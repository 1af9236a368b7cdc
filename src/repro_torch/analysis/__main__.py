"""CLI: ``python -m repro_torch.analysis [--only SECTION,...] [--device D]
[--shard-report PATH]``

Exit code 0 = every check holds; 1 = violations (printed one per line,
prefixed by their section); 2 = a section was asked for that the port
lacks (``intervals``) or that does not exist.  Rule
waivers live in ``analysis/waivers.toml`` — there is deliberately no CLI
waive flag: a flag silences forever and invisibly, a file row is reviewed
in the diff and expires.
"""
from __future__ import annotations

import argparse
import sys

from . import shardability
from .simcheck import NOT_PORTED, SECTIONS, run_simcheck


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="simcheck on the port: static checks of the tick the "
                    "card replays (DESIGN.md §8)")
    ap.add_argument("--only", default=None,
                    help="comma list of sections to run "
                         f"({','.join(SECTIONS)}); default all")
    ap.add_argument("--sweep-points", type=int, default=8,
                    help="run_batch sweep width for the capture sentinel "
                         "(default 8)")
    ap.add_argument("--device", default="cuda",
                    help="device the tick runs on (default cuda; cpu runs "
                         "the same checks without the card)")
    ap.add_argument("--shard-report", default=None, metavar="PATH",
                    help="write the full shardability report (per-phase "
                         "tables and every cross-shard op) as JSON to "
                         "PATH (needs the shardability section)")
    args = ap.parse_args(argv)

    only = set(args.only.split(",")) if args.only else None
    try:
        report = run_simcheck(only=only, sweep_points=args.sweep_points,
                              device=args.device)
    except ValueError as e:
        print(f"[simcheck] {e}", file=sys.stderr)
        return 2

    for sec, probs in report.sections.items():
        status = "clean" if not probs else f"{len(probs)} violation(s)"
        print(f"[simcheck] {sec}: {status}")
    if only is None:
        for sec in NOT_PORTED:
            print(f"[simcheck] {sec}: not ported")
    for combo, digest in report.stream_digests.items():
        print(f"[simcheck]   stream topology {combo}: {digest}")
    if report.sentinel is not None:
        s = report.sentinel
        print(f"[simcheck]   {s.what}: warm={s.warm.captures} "
              f"counting={s.counting.captures}; kernel builds: "
              f"warm={s.warm.builds} counting={s.counting.builds}")
    for srep in report.shard_reports.values():
        print(f"[simcheck]   shardability {srep.summary()}")
    if args.shard_report:
        if not report.shard_reports:
            print("[simcheck] --shard-report given but the shardability "
                  "section did not run", file=sys.stderr)
            return 2
        shardability.write_report(list(report.shard_reports.values()),
                                  args.shard_report)
        print(f"[simcheck]   shardability report -> {args.shard_report}")
    for p in report.problems:
        print(f"VIOLATION {p}")
    print(f"[simcheck] {'OK' if report.ok else 'FAILED'}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
