"""Hill-climb runner over the dry run: apply a named change to a cell,
rerun it, and print the roofline terms before and after.

Each experiment is (name, arch, shape, config overrides, hypothesis), the
reference's ``EXPERIMENTS``.  The baseline is the cell's single-pod
dry-run record (``dryrun.dryrun_cell``, cached); the experiment reruns
the same cell with the overridden ``ArchConfig`` on a fresh fake world.
Both sides are the dry run's direct full-depth counts (eager DTensor
counts under the H100 constants of ``roofline.py``).  Results are cached
under ``results/torch_perf/``.

  PYTHONPATH=src python -m repro_torch.launch.perf --exp phi3-prefill-flatseq
  PYTHONPATH=src python -m repro_torch.launch.perf --list
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json

from ..configs import SHAPES, get_config
from .dryrun import RESULTS as DRYRUN_RESULTS
from .dryrun import _run_costs, dryrun_cell, mesh_devices
from .mesh import fake_world, make_production_mesh
from .roofline import HBM_BW, LINK_BW, PEAK_FLOPS

PERF_RESULTS = DRYRUN_RESULTS.parent / "torch_perf"

# name → (arch, shape, overrides, hypothesis)
EXPERIMENTS = {
    "phi3-prefill-flat": (
        "phi3-medium-14b", "prefill_32k", {"attn_impl": "flat"},
        "flat-head einsum lifts the n_kv sharding cap; 40 ∤ 16 still, so "
        "expect little change alone — control for the seqshard run"),
    "phi3-prefill-flatseq": (
        "phi3-medium-14b", "prefill_32k", {"attn_impl": "flat_seqshard"},
        "context parallelism: shard the query sequence (32768 % 16 = 0) "
        "over the model axis → expect ~16× lower attention flops/bytes "
        "per device"),
    "phi3-train-flatseq": (
        "phi3-medium-14b", "train_4k", {"attn_impl": "flat_seqshard"},
        "same fix on the train cell (4096 % 16 = 0)"),
    "qwen3-train-flatseq": (
        "qwen3-0.6b", "train_4k", {"attn_impl": "flat_seqshard"},
        "paper-representative small arch; 16 q-heads shard after "
        "flattening AND the S² tensor shards on seq"),
    "whisper-train-flatseq": (
        "whisper-base", "train_4k", {"attn_impl": "flat_seqshard"},
        "whisper-train collectives come with heavy activation resharding; "
        "constraining attention layout should cut the all-gather volume"),
    "qwen3moe-decode-flat": (
        "qwen3-moe-30b-a3b", "decode_32k", {"attn_impl": "flat"},
        "32 q-heads % 16 = 0 after flattening → decode attention shards "
        "on heads instead of replicating at kv=4"),
    "qwen3moe-decode-int8kv": (
        "qwen3-moe-30b-a3b", "decode_32k", {"kv_dtype": "int8"},
        "decode is KV-read-bound; int8 cache (+f32 per-position scale) "
        "halves bytes per element → expect ~1.9× lower memory term"),
    "granite-decode-int8kv": (
        "granite-20b", "decode_32k", {"kv_dtype": "int8"},
        "same lever on the MQA serving cell"),
}

_TERMS = (("flops", PEAK_FLOPS), ("bytes_accessed", HBM_BW),
          ("collective_bytes", LINK_BW))


def run_experiment(name: str, force: bool = False) -> dict:
    arch, shape_name, overrides, hypothesis = EXPERIMENTS[name]
    PERF_RESULTS.mkdir(parents=True, exist_ok=True)
    cache = PERF_RESULTS / f"{name}.json"
    if cache.exists() and not force:
        return json.loads(cache.read_text())
    rec = {"name": name, "arch": arch, "shape": shape_name,
           "overrides": overrides, "hypothesis": hypothesis}
    base_rec = dryrun_cell(arch, shape_name)
    if base_rec["status"] != "ok":
        rec.update(status="error", error=f"baseline: {base_rec['status']}"
                   f" {base_rec.get('error', '')[:300]}")
        cache.write_text(json.dumps(rec, indent=1))
        return rec
    cfg = dc.replace(get_config(arch), **overrides)
    shape = next(s for s in SHAPES if s.name == shape_name)
    try:
        with fake_world(mesh_devices(False)):
            after = _run_costs(cfg, shape, make_production_mesh(
                device_type="cpu"))
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:500])
        cache.write_text(json.dumps(rec, indent=1))
        return rec
    rec["status"] = "ok"
    for key, denom in _TERMS:
        b, a = base_rec["cost_direct"][key], after[key]
        rec[key] = {"before": b, "after": a,
                    "speedup": (b / a) if a > 0 else float("inf"),
                    "term_before_s": b / denom, "term_after_s": a / denom}
    cache.write_text(json.dumps(rec, indent=1))
    return rec


def show(rec: dict):
    print(f"\n=== {rec['name']} ({rec['arch']} × {rec['shape']}) ===")
    print(f"hypothesis: {rec['hypothesis']}")
    if rec.get("status") != "ok":
        print(f"  {rec.get('status')}: {rec.get('error', '')[:200]}")
        return
    for key, _ in _TERMS:
        r = rec[key]
        print(f"  {key:18s} {r['before']:.3e} → {r['after']:.3e}  "
              f"({r['speedup']:.2f}×)  term {r['term_before_s']:.4f}s → "
              f"{r['term_after_s']:.4f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", choices=sorted(EXPERIMENTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for k, (a, s, o, _) in EXPERIMENTS.items():
            print(f"{k:28s} {a} × {s}: {o}")
        return
    names = sorted(EXPERIMENTS) if args.all else [args.exp]
    for n in names:
        if n:
            show(run_experiment(n, args.force))


if __name__ == "__main__":
    main()
