"""Streaming telemetry, sampled tracing & phase profiling on the PyTorch
port (DESIGN.md §9), the twin of ``examples/telemetry_study.py``.

Three observability surfaces on the paper's SockShop deployment: the live
metric stream (solo, OTel JSON), the per-point rows of a ``run_batch``
sweep (Prometheus lines) reconciled with each point's ``QoSReport``, and
the sampled request traces rebuilt into call trees that reproduce the
engine's response exactly; ``--profile`` adds the per-phase and
per-Disruption-stage times of the eager tick (CUDA events on the card).
The verdict: every streamed window validates and reconciles, and every
eligible trace is exact.  Runs on the card unless ``--device cpu`` is
given.

    PYTHONPATH=src python examples/torch_telemetry_study.py
    PYTHONPATH=src python examples/torch_telemetry_study.py --profile
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import sockshop  # noqa: E402
from repro_torch.core import batch_item, summarize  # noqa: E402
from repro_torch.obs import export, profile, spans  # noqa: E402


TEL_KW = dict(telemetry="stream", tel_window_ticks=50, tel_windows=4,
              tel_span_k=25, tel_span_cap=2048)


def make_sim(duration_s: float, **kw):
    return sockshop.make_sim(n_clients=80, duration_s=duration_s,
                             seed=11, **TEL_KW, **kw)


def solo_stream(duration_s: float, device="cuda"):
    print("=== 1. live metric stream (solo run, OTel JSON) ===")
    sim = make_sim(duration_s, device=device)
    with export.collecting() as col:
        sink = export.printer(export.otel_json)
        export.install(sink)
        try:
            res = sim.run()
        finally:
            export.uninstall(sink)
    export.validate_rows(col.rows)
    rep = summarize(sim, res)
    print(f"-> streamed {len(col.rows)} windows live; report agrees: "
          f"tel_windows={rep.tel_windows} tel_spans={rep.tel_spans} "
          f"tel_span_drops={rep.tel_span_drops}")
    return sim, res


def batch_stream(duration_s: float, n_points: int = 3,
                 device="cuda") -> None:
    print("\n=== 2. run_batch: per-point live rows (Prometheus) ===")
    sim = make_sim(duration_s, device=device)
    rates = tuple(2.0 * 2 ** b for b in range(n_points))
    points = [dataclasses.replace(sim.params, spawn_rate=r)
              for r in rates]
    with export.collecting() as col:
        sink = export.printer(export.prometheus_line)
        export.install(sink)
        try:
            res = sim.run_batch(points)
        finally:
            export.uninstall(sink)
    export.validate_rows(col.rows)
    for b, (r, p) in enumerate(zip(rates, points)):
        mine = [row for row in col.rows if int(row["tag"]) == b]
        rep = summarize(sim, batch_item(res, b), params=p)
        streamed = int(sum(row["completed"] for row in mine))
        print(f"-> point {b} (spawn_rate={r}): {len(mine)} windows, "
              f"streamed completed {streamed} == report "
              f"{rep.completed_requests}")
        if streamed != rep.completed_requests:
            raise AssertionError(
                f"point {b}: streamed windows sum to {streamed} but the "
                f"QoS report counted {rep.completed_requests}")


def trace_study(sim, res) -> bool:
    print("\n=== 3. sampled request traces vs critical path ===")
    d_max = int(sim.app.succ.shape[1])
    checks = spans.verify_traces(res.state, sim.graph, d_max)
    exact = [c for c in checks if c.exact]
    print(f"sampled completed requests reconstructed: {len(checks)} "
          f"({len(exact)} bitwise-exact, tolerance 0)")
    show = max(checks, key=lambda c: c.n_spans, default=None)
    if show is not None:
        roots = spans.trace_tree(spans.spans_of(res.state, show.req),
                                 sim.graph.n_services, d_max)
        print(f"\nrequest {show.req} (api {show.api}, "
              f"{show.n_spans} spans):")
        print(spans.format_trace(roots))
        print(f"engine response  {float(show.response):.6f} s\n"
              f"span-tree        {float(show.tree):.6f} s\n"
              f"tropical closure {float(show.tropical):.6f} s"
              + (f"\ngraph Alg 2      {float(show.graph):.6f} s"
                 if show.graph is not None else ""))
    eligible = [c for c in checks if c.retry_free]
    return bool(checks) and all(c.exact for c in eligible)


def profile_study(duration_s: float, device="cuda") -> None:
    print("\n=== 4. per-phase cost attribution (the eager tick's probes) "
          "===")
    sim = sockshop.make_sim(
        n_clients=80, duration_s=duration_s, seed=11,
        faults="chaos", replicas=2,
        host_mtbf_s=120.0, host_mttr_s=5.0,
        retry_timeout_s=3.0, retry_budget=2, device=device)
    print(profile.format_table(profile.phase_breakdown(sim, reps=3),
                               title="tick phase"))
    print()
    print(profile.format_table(profile.disruption_breakdown(sim, reps=3),
                               title="Disruption stage"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--points", type=int, default=3,
                    help="sweep points in the run_batch section")
    ap.add_argument("--profile", action="store_true",
                    help="also run the (slower) per-phase profiler")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, res = solo_stream(args.duration, args.device)
    batch_stream(args.duration, args.points, args.device)
    exact = trace_study(sim, res)
    if args.profile:
        profile_study(args.duration, args.device)
    if not exact:
        print("# (!) a retry-free sampled trace did not reproduce the "
              "engine's response")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
