"""Network saturation study on SockShop on the PyTorch port (DESIGN.md
§6), the twin of ``examples/network_saturation.py``.

SockShop's 10-node cluster on low-bandwidth NICs, the offered load swept
as ONE ``Simulation.run_batch`` call.  The verdict: p95 transit time rises
with the load (a point that does not is marked ``(!)``).  Runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_network_saturation.py \\
        --loads 10,25,50,100 --mbps 8
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import sockshop  # noqa: E402
from repro_torch.core import batch_item, policies, summarize  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loads", default="10,25,50,100",
                    help="comma list of client counts (one batched sweep)")
    ap.add_argument("--mbps", type=float, default=8.0,
                    help="per-host NIC capacity, Mbit/s (low on purpose)")
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    loads = [int(x) for x in args.loads.split(",") if x]

    # Spread placement: the paper-default most-available policy piles every
    # sockshop instance onto the largest node, making all RPC hops loopback
    # — spreading them across hosts is what creates cross-NIC traffic.
    sim = sockshop.make_sim(
        n_clients=max(loads), duration_s=args.duration,
        network="fabric", nic_egress_mbps=args.mbps,
        nic_ingress_mbps=args.mbps,
        placement_policy=policies.PLACE_SPREAD, device=args.device)
    sweeps = [dataclasses.replace(sim.params, n_clients=nc,
                                  spawn_rate=nc / 10.0) for nc in loads]
    res_b = sim.run_batch(sweeps)

    print(f"# NIC {args.mbps} Mbit/s per host, {args.duration:.0f} s runs "
          f"(batched sweep: compile {res_b.compile_time_s:.1f}s, "
          f"run {res_b.wall_time_s:.1f}s)")
    print(f"{'clients':>8s} {'transits':>9s} {'MB_moved':>9s} "
          f"{'p50_tr_ms':>10s} {'p95_tr_ms':>10s} {'ingress_util':>13s} "
          f"{'p95_resp_ms':>12s}")
    prev, rising = -1.0, True
    for b, (nc, p) in enumerate(zip(loads, sweeps)):
        rep = summarize(sim, batch_item(res_b, b), params=p)
        mono = "" if rep.transit_p95_ms >= prev else "  (!)"
        rising = rising and not mono
        prev = rep.transit_p95_ms
        print(f"{nc:8d} {rep.net_transits:9d} {rep.net_bytes_mb:9.1f} "
              f"{rep.transit_p50_ms:10.1f} {rep.transit_p95_ms:10.1f} "
              f"{rep.avg_ingress_util:13.3f} {rep.p95_response_ms:12.1f}"
              f"{mono}")
    return 0 if rising else 1


if __name__ == "__main__":
    sys.exit(main())
