"""Roofline terms of the dry-run cells under H100 constants.

Per (arch × shape) single-pod cell:
    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW
plus MODEL_FLOPS = 6·N·D (train) / 2·N_active·D (serve) and the
useful-compute ratio MODEL_FLOPS / counted FLOPs.

The constants, per GPU (none was measured here):
  * ``PEAK_FLOPS = 989e12``: dense bfloat16 tensor-core peak of the H100
    SXM5 80GB (NVIDIA H100 datasheet; the figure PERF.md's kernel bounds
    use);
  * ``HBM_BW = 3.35e12`` bytes/s: the H100 SXM5's HBM3 bandwidth (same
    datasheet);
  * ``LINK_BW = 50e9`` bytes/s: one NDR InfiniBand link, 400 Gb/s, per
    GPU: a DGX H100 gives each GPU one ConnectX-7 NIC.  Both 16-wide axes
    of the production mesh span more than one 8-GPU node, so a collective
    over either crosses the network; an axis inside one node would see
    NVLink's 450e9 bytes/s per direction instead;
  * ``CHIPS = 256``: the single-pod mesh.

The FLOPs and bytes are the dry run's direct, full-depth counts per
device (``dryrun.py``: eager DTensor counts, every intermediate written
and read back, only matrix-product FLOPs counted), not XLA's, so the
terms are not comparable with the reference's.
"""
from __future__ import annotations

import argparse
import json

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applies
from ..models import build_model
from ..models.common import n_params
from .dryrun import RESULTS

PEAK_FLOPS = 989e12        # H100 SXM5 dense bf16, per GPU
HBM_BW = 3.35e12           # H100 SXM5 HBM3, bytes/s per GPU
LINK_BW = 50e9             # one NDR 400 Gb/s link per GPU, bytes/s
CHIPS = 256                # single-pod mesh


def _active_fraction(cfg) -> float:
    """Active-parameter fraction for MoE archs (6·N_active·D)."""
    if cfg.moe is None:
        return 1.0
    model = build_model(cfg)
    total = n_params(model.schema())
    m = cfg.moe
    routed_one = cfg.d_model * m.d_expert * 3
    if cfg.family == "hybrid":
        # half the period's FFNs are MoE; each picks top_k of n_experts
        inactive = (m.n_experts - m.top_k) * routed_one * (cfg.n_layers // 2)
    else:
        inactive = (m.n_experts - m.top_k) * routed_one * cfg.n_layers
    return max((total - inactive) / total, 1e-6)


def model_flops(cfg, shape) -> float:
    """6·N·D (train) or 2·N_active·D (forward/serve), global."""
    model = build_model(cfg)
    total = n_params(model.schema())
    active = total * _active_fraction(cfg)
    if shape.kind == "train":
        return 6.0 * active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * active * shape.seq_len * shape.global_batch
    return 2.0 * active * shape.global_batch     # one token per sequence


def roofline_of(rec: dict, cfg, shape) -> dict:
    """The roofline row of an ``ok`` single-pod record."""
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes_accessed"]
    coll_dev = rec["collectives"]["total_bytes"]
    terms = {"compute": flops_dev / PEAK_FLOPS,
             "memory": bytes_dev / HBM_BW,
             "collective": coll_dev / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    counted_global = flops_dev * CHIPS
    bound = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "status": "ok",
        "flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": coll_dev,
        "t_compute_s": terms["compute"], "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"], "dominant": dominant,
        "model_flops_global": mf,
        "useful_ratio": mf / counted_global if counted_global else 0.0,
        "roofline_fraction": (mf / CHIPS / PEAK_FLOPS) / bound
        if bound > 0 else 0.0,
        "coll_by_op": {k: v["bytes"] for k, v in rec["collectives"].items()
                       if isinstance(v, dict)},
        "memory_temp_bytes": rec["memory"].get("temp_bytes", -1),
        "run_s": rec.get("run_s"),
    }


def cell_roofline(arch: str, shape_name: str) -> dict | None:
    path = RESULTS / f"{arch}__{shape_name}__pod1.json"
    if not path.exists():
        return None
    rec = json.loads(path.read_text())
    if rec.get("status") != "ok":
        return {"arch": arch, "shape": shape_name,
                "status": rec.get("status"),
                "reason": rec.get("reason") or rec.get("error", "")[:200]}
    shape = next(s for s in SHAPES if s.name == shape_name)
    return roofline_of(rec, get_config(arch), shape)


def format_row(r: dict) -> str:
    if r.get("status") != "ok":
        return (f"{r['arch']:22s} {r['shape']:12s} -- {r.get('status')}: "
                f"{r.get('reason', '')[:60]}")
    return (f"{r['arch']:22s} {r['shape']:12s} {r['t_compute_s']:9.4f} "
            f"{r['t_memory_s']:9.4f} {r['t_collective_s']:9.4f} "
            f"{r['dominant'][:5]:>5s} {r['useful_ratio']:7.3f} "
            f"{r['roofline_fraction']:6.3f}")


HEADER = (f"{'arch':22s} {'shape':12s} {'comp(s)':>9s} {'mem(s)':>9s} "
          f"{'coll(s)':>9s} {'dom':>5s} {'useful':>7s} {'roofl':>6s}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = shape_applies(get_config(arch), shape)
            if not ok:
                rows.append({"arch": arch, "shape": shape.name,
                             "status": "skipped", "reason": why})
                continue
            r = cell_roofline(arch, shape.name)
            if r:
                rows.append(r)
    if args.json:
        print(json.dumps(rows, indent=1))
        return
    print(f"H100 SXM5 constants: PEAK_FLOPS {PEAK_FLOPS:.3e} FLOP/s, "
          f"HBM_BW {HBM_BW:.3e} B/s, LINK_BW {LINK_BW:.3e} B/s, "
          f"{CHIPS} GPUs")
    print(HEADER)
    for r in rows:
        print(format_row(r))


if __name__ == "__main__":
    main()
