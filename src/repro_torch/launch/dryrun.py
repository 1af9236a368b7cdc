"""Multi-pod dry run: run every (arch × shape × mesh) cell on a fake world.

The reference lowers and compiles each cell with XLA on 256 or 512
placeholder host devices.  The port runs it: the cell's step
(``launch.specs.build_cell``) runs once, eagerly, on DTensors whose local
shards are fake tensors, over a fake process group of as many ranks as
the mesh has devices (``launch.mesh.fake_world``).  Nothing is allocated
and no collective moves data; this process plays rank 0, and every rank
does the same work.  ``launch.comm_analysis.record`` counts what rank 0
would do.

Per cell we record:
  * ``status``: ``ok``, ``skipped`` (the shape does not apply) or
    ``error`` with the exception and ``op``, the DTensor op dispatched
    last (one DTensor has no sharding rule for, say; the reference
    records a failed compile the same way, and nothing here swaps such an
    op for a replicated fallback);
  * ``memory``: ``argument_bytes`` (the local shards of the arguments,
    known before the run, so an ``error`` record keeps it too),
    ``output_bytes`` (the outputs' local shards) and ``temp_bytes`` (the
    peak of live local intermediates);
  * ``cost``: ``flops`` and ``bytes_accessed`` per device;
  * ``collectives``: bytes and counts per collective, per device;
  * ``cost_extrapolated`` (single pod): the reference's calibration,
    1- and 2-unit variants extrapolated linearly to the full depth
    (XLA counts a loop body once; the port runs every layer, so the
    direct count, ``cost_direct``, stands beside it and the two agree
    where a unit's cost is the same at every depth);
  * ``run_s``: the run's wall time on the host (the reference's
    ``compile_s``).

All counts are eager and unfused (``comm_analysis`` says what that
means): they are not comparable with the reference's XLA counts.

Records are cached as JSON under ``results/torch_dryrun`` (delete a file,
or pass ``--force``, to rerun it).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import logging
import pathlib
import time
import traceback

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applies
from ..tree import tree_leaves
from .comm_analysis import _COLLECTIVES, record
from .mesh import fake_world, make_production_mesh
from .specs import build_cell

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "torch_dryrun"
_KEYS = ("flops", "bytes_accessed", "collective_bytes")


def _units(cfg) -> int:
    """Repeated-unit count for cost extrapolation (layers or periods)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_period
    return cfg.n_layers


def _variant(cfg, k: int):
    if cfg.family == "hybrid":
        return dc.replace(cfg, n_layers=k * cfg.attn_period)
    if cfg.family == "encdec":
        return dc.replace(cfg, n_layers=k, n_enc_layers=k)
    return dc.replace(cfg, n_layers=k)


def _local_bytes(tree) -> int:
    """Bytes of the local shards of a tree's tensors, each tensor once (a
    step that writes its arguments in place returns them)."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        loc = getattr(t, "_local_tensor", t)
        if not hasattr(loc, "numel") or id(loc) in seen:
            continue
        seen.add(id(loc))
        total += loc.numel() * loc.element_size()
    return total


def _quiet():
    # DTensor warns at every redistribution over two mesh dims at once
    logging.getLogger("torch.distributed.tensor._redistribute") \
        .setLevel(logging.ERROR)


def _run_costs(cfg, shape, mesh) -> dict:
    """flops/bytes/collectives/memory of one run of the cell."""
    _quiet()
    cell = build_cell(cfg, shape, mesh)
    arg_bytes = _local_bytes(cell.args)
    t0 = time.perf_counter()
    with cell.fake_mode, record() as rec:
        try:
            out = cell.fn(*cell.args)
        except Exception as e:
            e.dtensor_op = rec.last_op
            raise
        out_bytes = _local_bytes(out)
        del out
    coll = rec.summary()
    return {"flops": float(rec.flops),
            "bytes_accessed": float(rec.bytes_accessed),
            "collective_bytes": float(coll["total_bytes"]),
            "collectives": coll,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": out_bytes,
                       "temp_bytes": rec.peak_bytes},
            "run_s": time.perf_counter() - t0}


def cost_extrapolation(cfg, shape, mesh) -> dict:
    """The reference's calibration: run 1- and 2-unit variants (identical
    shapes otherwise) and extrapolate linearly, total(U) = c1 +
    (U-1)·(c2-c1)."""
    u = _units(cfg)
    c1 = _run_costs(_variant(cfg, 1), shape, mesh)
    c2 = _run_costs(_variant(cfg, 2), shape, mesh)
    out = {}
    for k in _KEYS:
        slope = c2[k] - c1[k]
        out[k] = c1[k] + (u - 1) * slope
        out[k + "_per_unit"] = slope
    out["units"] = u
    out["c1"] = {k: c1[k] for k in _KEYS}
    out["c2"] = {k: c2[k] for k in _KEYS}
    per_op = {}
    for op in _COLLECTIVES:
        b1 = c1["collectives"][op]["bytes"]
        b2 = c2["collectives"][op]["bytes"]
        per_op[op] = b1 + (u - 1) * (b2 - b1)
    out["collective_bytes_by_op"] = per_op
    return out


def mesh_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def cell_record(cfg, shape, mesh, extrapolate: bool = True) -> dict:
    """The record fields of one cell on ``mesh`` (a ``DeviceMesh`` over a
    fake world): ``status`` and, where the run went through, its
    memory, cost, collectives and (``extrapolate``) the calibration."""
    _quiet()
    rec = {}
    try:
        cell = build_cell(cfg, shape, mesh)
        rec["memory"] = {"argument_bytes": _local_bytes(cell.args)}
        rec["batch_shards"] = _batch_shards(cell, shape)
        del cell
        c = _run_costs(cfg, shape, mesh)
        if extrapolate:
            rec["cost_extrapolated"] = cost_extrapolation(cfg, shape, mesh)
        rec.update(status="ok", run_s=round(c["run_s"], 2),
                   memory=c["memory"],
                   cost={"flops": c["flops"],
                         "bytes_accessed": c["bytes_accessed"]},
                   cost_direct={k: c[k] for k in _KEYS},
                   collectives=c["collectives"])
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   op=getattr(e, "dtensor_op", None),
                   traceback=traceback.format_exc()[-2000:])
    return rec


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool = False,
                force: bool = False) -> dict:
    """The record of one cell on a production mesh (from the cache unless
    ``force``)."""
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    RESULTS.mkdir(parents=True, exist_ok=True)
    cache = RESULTS / f"{tag}.json"
    if cache.exists() and not force:
        return json.loads(cache.read_text())
    cfg = get_config(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    ok, why = shape_applies(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        t0 = time.perf_counter()
        with fake_world(mesh_devices(multi_pod)):
            # single-pod runs also calibrate the per-unit costs; the
            # multi-pod pass is the sharding proof and skips it
            rec.update(cell_record(cfg, shape, make_production_mesh(
                multi_pod=multi_pod, device_type="cpu"),
                extrapolate=not multi_pod))
        rec["wall_s"] = round(time.perf_counter() - t0, 2)
    cache.write_text(json.dumps(rec, indent=1))
    return rec


def _batch_shards(cell, shape) -> dict:
    """Global and local shape of each input the cell's batch holds."""
    arg = cell.args[2] if shape.kind == "train" else cell.args[1]
    items = arg.items() if isinstance(arg, dict) else [("tokens", arg)]
    return {k: {"global": list(v.shape),
                "local": list(v.to_local().shape)} for k, v in items}


def show(rec: dict) -> str:
    line = (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"{rec['status']:8s}")
    if rec["status"] == "ok":
        line += (f" run={rec['run_s']:8.1f}s "
                 f"flops={rec['cost']['flops']:.3e} "
                 f"coll={rec['collectives']['total_bytes']:.3e}B "
                 f"args={rec['memory']['argument_bytes'] / 2**30:.3f}GiB")
    elif rec["status"] == "error":
        line += f" at {rec.get('op')}: " \
            + rec["error"][:160].replace("\n", " ")
    else:
        line += " " + rec.get("reason", "")[:80]
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) on both meshes")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in (False, True):
                    print(show(dryrun_cell(arch, shape.name, mp,
                                           args.force)), flush=True)
        return
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    print(show(dryrun_cell(args.arch, args.shape, args.multi_pod,
                           args.force)), flush=True)


if __name__ == "__main__":
    main()
