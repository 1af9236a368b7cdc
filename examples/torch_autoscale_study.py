"""Scaling-policy study on SockShop on the PyTorch port: the paper's §6.4
experiment (NS vs HS vs VS vs the beyond-paper HYBRID), the twin of
``examples/autoscale_study.py``.

Each policy's client-load sweep runs as ONE ``Simulation.run_batch``: one
batched tick for every load point.  The verdict: HS scales out and runs
on fewer milicores than NS at the largest load.  Runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_autoscale_study.py \\
        --loads 300,500,1000
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import sockshop  # noqa: E402
from repro_torch.core import batch_item, policies, summarize  # noqa: E402

POLICIES = [("NS", policies.SCALE_NONE), ("HS", policies.SCALE_HORIZONTAL),
            ("VS", policies.SCALE_VERTICAL), ("HYBRID", policies.SCALE_HYBRID)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loads", default="300,500,1000",
                    help="comma list of client counts (one batched sweep "
                         "per policy)")
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    loads = [int(x) for x in args.loads.split(",") if x]

    print(f"{'policy':8s} {'clients':>8s} {'avg_ms':>8s} {'p95_ms':>8s} "
          f"{'SLO_viol':>9s} {'milicores':>10s} {'instances':>10s} "
          f"{'events':>14s}")
    last = {}
    for name, pid in POLICIES:
        sim = sockshop.make_sim(
            n_clients=max(loads), duration_s=args.duration,
            share=4725.0, scaling_policy=pid,
            hs_util_hi=0.03, hs_util_lo=0.002,
            vs_util_hi=0.14, vs_util_lo=0.01,
            idle_mips_frac=0.01, vs_overhead_frac=0.11, util_ema=0.1,
            device=args.device)
        sweeps = [dataclasses.replace(sim.params, n_clients=nc,
                                      spawn_rate=nc / 30.0) for nc in loads]
        res = sim.run_batch(sweeps)     # whole sweep: one batched tick
        for b, nc in enumerate(loads):
            rep = summarize(sim, batch_item(res, b), params=sweeps[b])
            events = (f"+{rep.scale_out}/-{rep.scale_in}"
                      f"/^{rep.scale_up}/v{rep.scale_down}")
            print(f"{name:8s} {nc:8d} {rep.avg_response_ms:8.0f} "
                  f"{rep.p95_response_ms:8.0f} "
                  f"{rep.slo_violation_rate:9.1%} "
                  f"{rep.avg_milicores:10.1f} {rep.active_instances:10d} "
                  f"{events:>14s}")
        last[name] = rep
    hs, ns = last["HS"], last["NS"]
    if hs.scale_out > 0 and hs.avg_milicores < ns.avg_milicores:
        print(f"# HS scaled out (+{hs.scale_out}) on "
              f"{hs.avg_milicores:.1f} milicores against NS's "
              f"{ns.avg_milicores:.1f} at {loads[-1]} clients")
        return 0
    print(f"# (!) HS did not scale out on fewer milicores than NS at "
          f"{loads[-1]} clients")
    return 1


if __name__ == "__main__":
    sys.exit(main())
