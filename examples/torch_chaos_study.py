"""Availability vs blast radius on SockShop on the PyTorch port (DESIGN.md
§7.1), the twin of ``examples/chaos_study.py``.

Zone-correlated fail-slow chaos over the 10-node cluster: per blast
radius, a breaker-only arm and a breaker + outlier-ejection arm, the whole
radius × arm grid as ONE ``Simulation.run_batch(points, apps=...)`` call.
The verdict: ejection lowers the error rate at every radius.  Runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_chaos_study.py --radii 1,2,5
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import sockshop  # noqa: E402
from repro_torch.core import batch_item, policies, summarize  # noqa: E402

N_HOSTS = 10        # the paper's cluster (sockshop.make_sim)


def zones(radius: int) -> np.ndarray:
    """Contiguous failure domains of ``radius`` hosts (last one ragged)."""
    return (np.arange(N_HOSTS) // radius).astype(np.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--radii", default="1,2,5",
                    help="comma list of blast radii (hosts per failure "
                         "domain, 1..10)")
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--zone-rate", type=float, default=0.02,
                    help="fail-slow episode rate per zone, 1/s")
    ap.add_argument("--slow-factor", type=float, default=0.1,
                    help="MIPS fraction a fail-slow host retains")
    ap.add_argument("--slow-mttr", type=float, default=15.0,
                    help="mean fail-slow episode length, seconds")
    ap.add_argument("--timeout", type=float, default=2.5,
                    help="per-attempt RPC timeout, seconds")
    ap.add_argument("--eject-thresh", type=float, default=0.35,
                    help="per-replica error-EMA ejection threshold "
                         "(the 'on' arm; 'off' uses 2.0)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    radii = [int(x) for x in args.radii.split(",") if x]

    # 2 replicas per service, spread over hosts; the breaker stays ON in
    # both arms (0.5): the study isolates what ejection adds on top of it
    sim = sockshop.make_sim(
        n_clients=args.clients, duration_s=args.duration, replicas=2,
        share=600.0, placement_policy=policies.PLACE_SPREAD,
        faults="chaos", host_mtbf_s=float("inf"), inst_kill_rate=0.0,
        retry_timeout_s=args.timeout, retry_budget=2,
        cb_err_thresh=0.5, cb_cooldown_s=5.0, cb_alpha=0.3,
        zone_slow_rate=args.zone_rate, host_slow_factor=args.slow_factor,
        host_slow_mttr_s=args.slow_mttr, eject_cooldown_s=8.0,
        host_zone=zones(radii[0]), device=args.device)
    base = sim.params

    points, apps, labels = [], [], []
    for r in radii:
        app_r = sim.app._replace(host_zone=torch.as_tensor(
            zones(r), device=sim.app.host_zone.device))
        for thresh in (2.0, args.eject_thresh):   # > 1 = ejection off
            points.append(dataclasses.replace(base,
                                              eject_err_thresh=thresh))
            apps.append(app_r)
            labels.append((r, thresh < 1.0))
    res_b = sim.run_batch(points, apps=apps)

    print(f"# sockshop x2 replicas, zone fail-slow rate "
          f"{args.zone_rate}/s, factor {args.slow_factor}, MTTR "
          f"{args.slow_mttr:.0f}s, timeout {args.timeout}s "
          f"(batched sweep: compile {res_b.compile_time_s:.1f}s, "
          f"run {res_b.wall_time_s:.1f}s)")
    print(f"{'radius':>6s} {'eject':>5s} {'avail':>6s} {'err_rate':>8s} "
          f"{'failed':>6s} {'slow_eps':>8s} {'ejects':>6s} {'readmit':>7s} "
          f"{'trips':>5s} {'p95_ms':>8s}")
    flat = {}
    for b, ((r, ej_on), p) in enumerate(zip(labels, points)):
        rep = summarize(sim, batch_item(res_b, b), params=p)
        flat[(r, ej_on)] = rep
        print(f"{r:6d} {'on' if ej_on else 'off':>5s} "
              f"{rep.availability:6.3f} {rep.error_rate:8.3f} "
              f"{rep.failed_requests:6d} {rep.slow_episodes:8d} "
              f"{rep.ejections:6d} {rep.readmissions:7d} "
              f"{rep.breaker_trips:5d} {rep.p95_response_ms:8.0f}")
    worse = [r for r in radii
             if flat[(r, True)].error_rate >= flat[(r, False)].error_rate]
    if worse:
        print(f"# (!) ejection did not reduce error rate at radius={worse}")
        return 1
    print("# outlier ejection + breaker dominated breaker-only error "
          "rate at every blast radius")
    return 0


if __name__ == "__main__":
    sys.exit(main())
