"""Latency-outlier ejection on heterogeneous hardware on the PyTorch port
(ROADMAP §7.1-a), the twin of ``examples/hetero_study.py``.

No injected faults: a slow-CPU host class (``--slow-hosts`` of the
10-node SockShop cluster at ``--cpu-scale`` of full speed) is the only
asymmetry, and the study runs latency ejection off vs on as one two-point
``run_batch``.  The verdict: ejection trips and cuts the p95 response
with no failed request.  Runs on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples/torch_hetero_study.py
"""
import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import sockshop  # noqa: E402
from repro_torch.core import batch_item, policies, summarize  # noqa: E402

N_HOSTS = 10        # the paper's cluster (sockshop.make_sim)


def hetero_cpu(n_slow: int, cpu_scale: float) -> np.ndarray:
    """Per-host CPU speed: the LAST ``n_slow`` nodes form the slow class
    (old CPUs, thermal throttling, a noisy neighbor)."""
    scale = np.ones(N_HOSTS, np.float32)
    scale[N_HOSTS - n_slow:] = cpu_scale
    return scale


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=80)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--slow-hosts", type=int, default=4,
                    help="how many of the 10 nodes are the slow class")
    ap.add_argument("--cpu-scale", type=float, default=0.2,
                    help="execution-speed fraction the slow class retains")
    ap.add_argument("--lat-factor", type=float, default=1.5,
                    help="ejection trip: replica latency EMA > factor × "
                         "service mean (the 'on' arm; 'off' uses 0)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # faults="chaos" enables the resilience machinery; every *injection*
    # knob is zeroed (inf MTBF, 0 rates), so nothing ever fails — the
    # only asymmetry is hardware speed.  eject_err_thresh > 1 keeps
    # error-based ejection off: the latency signal must do all the work.
    # replicas=3 matters: the healthy replicas must have the headroom to
    # absorb an ejected peer's traffic, or ejection just moves the queue
    # (with 2 replicas it halves a service's capacity and flaps).  The
    # long eject_cooldown_s keeps the slow replica parked between
    # half-open probes instead of re-admitting into the same EMA.
    sim = sockshop.make_sim(
        n_clients=args.clients, duration_s=args.duration, replicas=3,
        share=600.0, placement_policy=policies.PLACE_SPREAD,
        host_cpu_scale=hetero_cpu(args.slow_hosts, args.cpu_scale),
        faults="chaos", host_mtbf_s=float("inf"), inst_kill_rate=0.0,
        nic_degrade_rate=0.0, zone_fault_rate=0.0, zone_slow_rate=0.0,
        zone_partition_rate=0.0, eject_err_thresh=2.0,
        eject_cooldown_s=30.0, cb_err_thresh=2.0, device=args.device)
    base = sim.params

    points = [dataclasses.replace(base, eject_lat_factor=f)
              for f in (0.0, args.lat_factor)]
    res_b = sim.run_batch(points)

    print(f"# sockshop x3 replicas, {args.slow_hosts}/10 nodes at "
          f"{args.cpu_scale:.0%} CPU speed, zero injected faults "
          f"(batched sweep: compile {res_b.compile_time_s:.1f}s, "
          f"run {res_b.wall_time_s:.1f}s)")
    print(f"{'eject':>5s} {'p50_ms':>7s} {'p95_ms':>7s} {'p99_ms':>7s} "
          f"{'avg_ms':>7s} {'ejects':>6s} {'readmit':>7s} {'failed':>6s}")
    reps = []
    for b, p in enumerate(points):
        rep = summarize(sim, batch_item(res_b, b), params=p)
        reps.append(rep)
        on = p.eject_lat_factor > 0
        print(f"{'on' if on else 'off':>5s} {rep.p50_response_ms:7.0f} "
              f"{rep.p95_response_ms:7.0f} {rep.p99_response_ms:7.0f} "
              f"{rep.avg_response_ms:7.0f} {rep.ejections:6d} "
              f"{rep.readmissions:7d} {rep.failed_requests:6d}")
    off, on = reps
    if on.ejections == 0:
        print("# (!) latency ejection never tripped — raise --slow-hosts "
              "or lower --lat-factor")
    elif on.p95_response_ms >= off.p95_response_ms:
        print("# (!) ejection did not improve the p95 tail")
    else:
        print(f"# latency ejection cut p95 "
              f"{off.p95_response_ms:.0f}ms -> {on.p95_response_ms:.0f}ms "
              "by routing around the slow hardware class")
        return 0 if on.failed_requests == off.failed_requests == 0 else 1
    return 1


if __name__ == "__main__":
    sys.exit(main())
