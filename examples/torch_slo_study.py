"""Closing the QoS feedback loop on SockShop on the PyTorch port
(DESIGN.md §10), the twin of ``examples/slo_study.py``.

Burn-rate alerts gate the horizontal autoscaler (``hs_mode="slo_burn"``)
and tighten the outlier ejector (``slo_eject_tighten``); the util-vs-burn
comparison is ONE ``run_batch`` call under zone fail-slow chaos.  The
verdict (at 120 s or more): the slo_burn arm ends with a strictly lower
SLO violation rate at equal or fewer replica-seconds; every alert row
validates and no alert event is dropped at any duration.  Runs on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_slo_study.py
    PYTHONPATH=src python examples/torch_slo_study.py --duration 20  # toy
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
from repro_torch.obs import export  # noqa: E402

N_HOSTS = 10

# observability + SLO plane: 5 s windows, short lookback 15 s, long
# lookback 60 s, alerts need 0.5 s of sustained burn to fire.
OBS_KW = dict(telemetry="stream", tel_window_ticks=50, tel_windows=4,
              tel_span_k=50, tel_span_cap=1024,
              alerting="burn", slo_budget=0.05,
              slo_short_wins=3, slo_long_wins=12, slo_for_ticks=5,
              slo_stabilize_s=10.0)


def make_sim(duration_s: float, n_clients: int, device="cuda"):
    """SockShop x2 replicas under zone fail-slow chaos with HS enabled.

    The chaos plane reuses the gray-failure study's scenario (crash-free,
    episodes degrade a whole 2-host zone to 10 % MIPS); the scaling plane
    runs plain horizontal scaling whose out/in gate is the swept knob.
    """
    zones = (np.arange(N_HOSTS) // 2).astype(np.int32)
    return sockshop.make_sim(
        n_clients=n_clients, duration_s=duration_s, replicas=2,
        share=900.0, seed=11, placement_policy=policies.PLACE_SPREAD,
        scaling_policy=policies.SCALE_HORIZONTAL,
        hs_util_hi=0.5, hs_util_lo=0.05,
        faults="chaos", host_mtbf_s=float("inf"), inst_kill_rate=0.0,
        retry_timeout_s=2.5, retry_budget=2,
        cb_err_thresh=0.5, cb_cooldown_s=5.0, cb_alpha=0.3,
        zone_slow_rate=0.015, host_slow_factor=0.1, host_slow_mttr_s=15.0,
        eject_err_thresh=0.35, eject_cooldown_s=8.0,
        host_zone=zones, device=device, **OBS_KW)


def replica_seconds(item, dt: float) -> float:
    """∫ active replicas dt — the cost axis of the comparison."""
    return float(item.trace.active_instances.cpu().numpy()
                 .astype(np.float64).sum()) * dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=240.0)
    ap.add_argument("--clients", type=int, default=100)
    ap.add_argument("--points", type=int, default=2,
                    help="kept for smoke-CLI parity; the sweep always "
                         "runs the util and slo_burn arms")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sim = make_sim(args.duration, args.clients, args.device)
    # re-evaluate HS every 5 s (scale_interval is traced, so the
    # override rides the sweep points instead of the Simulation)
    base = dataclasses.replace(sim.params, scale_interval=50)
    # the two control planes; the util arm keeps plain ejection
    # (tighten=1.0 is an exact identity), the burn arm tightens it 2x
    # while alerts fire.
    arms = [("util", dataclasses.replace(base, hs_mode="util",
                                         slo_eject_tighten=1.0)),
            ("slo_burn", dataclasses.replace(base, hs_mode="slo_burn",
                                             slo_eject_tighten=0.3))]
    points = [p for _, p in arms]

    with export.alert_collecting() as alerts:
        res = sim.run_batch(points)
    export.validate_alert_rows(alerts.rows)
    print(f"# sockshop x2 replicas, zone fail-slow chaos, HS on "
          f"(batched sweep: compile {res.compile_time_s:.1f}s, "
          f"run {res.wall_time_s:.1f}s)")

    reps = {}
    print(f"{'hs_mode':>9s} {'viol_rate':>9s} {'repl_sec':>9s} "
          f"{'out':>4s} {'in':>4s} {'fires':>5s} {'firing_s':>8s} "
          f"{'ejects':>6s} {'p95_ms':>8s}")
    for b, (name, p) in enumerate(arms):
        item = batch_item(res, b)
        rep = summarize(sim, item, params=p)
        rs = replica_seconds(item, p.dt)
        reps[name] = (rep, rs)
        print(f"{name:>9s} {rep.slo_violation_rate:9.3f} {rs:9.0f} "
              f"{rep.scale_out:4d} {rep.scale_in:4d} {rep.alert_fires:5d} "
              f"{rep.alert_firing_time_s:8.1f} {rep.ejections:6d} "
              f"{rep.p95_response_ms:8.0f}")
        if rep.alert_event_drops:
            print(f"# (!) {name}: {rep.alert_event_drops} alert events "
                  "dropped")
            return 1

    print("\nfirst alert transitions (Prometheus ALERTS convention):")
    for ev in alerts.rows[:6]:
        print(export.prometheus_alert_line(ev).splitlines()[-1])

    (rep_u, rs_u), (rep_b, rs_b) = reps["util"], reps["slo_burn"]
    print(f"\n-> slo_burn vs util: violation rate "
          f"{rep_b.slo_violation_rate:.3f} vs {rep_u.slo_violation_rate:.3f}"
          f", replica-seconds {rs_b:.0f} vs {rs_u:.0f}")
    if args.duration >= 120.0:
        if rep_b.slo_violation_rate >= rep_u.slo_violation_rate:
            print("   (!) burn-gated scaling did not reduce the SLO "
                  "violation rate")
            return 1
        if rs_b > rs_u * 1.001:
            print("   (!) burn-gated scaling spent more replica-seconds "
                  "than util HS")
            return 1
        print("   burn-gated control wins on both axes.")
    else:
        print("   (toy duration — skipping the win assertions)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
