#!/usr/bin/env python3
"""Facts about the JAX reference that the port must allow for, measured
on the installed JAX on the CPU (the JAX package is run, never edited).

``--shardability``: the reference's sharding audit
(``repro.analysis.shardability.audit_combo``) live on each golden combo,
against its committed ``shard_baseline.json``: the eqn totals, the
entries of the nested-call primitive ``jit`` (JAX 0.9's name for what the
baseline's JAX called ``pjit``, which the audit's ``_CONTROL`` lists, so
the walk does not descend into them), and its own gate's findings.

``--dryrun``: whether the reference's dry run (``repro.launch.dryrun``)
lowers and compiles the cells the port's eager DTensor dry run could not
run before its repairs (mamba2-130m train_4k on both meshes and its
prefill_32k, jamba-1.5-large-398b's train_4k, flat phi3-medium-14b's
prefill_32k), each with its wall; records go to a temporary directory.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_state.py \\
        --shardability --dryrun
"""
import os

# the production meshes need 512 placeholder host devices, set before
# JAX starts (the reference's dry run does the same)
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

DRYRUN_CELLS = (("mamba2-130m", "train_4k", True),
                ("mamba2-130m", "train_4k", False),
                ("mamba2-130m", "prefill_32k", False),
                ("jamba-1.5-large-398b", "train_4k", False))


def shardability() -> None:
    from repro.analysis import shardability as sh
    from repro.analysis.simcheck import GOLDEN_COMBOS, SHARD_BASELINE_PATH
    base = json.loads(SHARD_BASELINE_PATH.read_text())
    reports = []
    for net, fl in GOLDEN_COMBOS:
        rep = sh.audit_combo(net, fl)
        reports.append(rep)
        cur = rep.to_json()
        pinned = base["combos"][rep.combo]
        jit = {k: n for k, n in cur["cross_shard"].items()
               if k.endswith(":jit")}
        print(f"{rep.combo}: {cur['n_total']} eqns (pinned "
              f"{pinned['n_total']}), {sum(jit.values())} in "
              f"{len(jit)} ':jit' entries: {jit}")
    probs = sh.compare_to_baseline(reports, base)
    print(f"the reference's gate: {len(probs)} finding(s)")
    for p in probs[:8]:
        print("  " + p)


def dryrun() -> None:
    from repro.configs import SHAPES, get_config
    from repro.launch import dryrun as rd
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import build_cell
    import jax
    rd.RESULTS = pathlib.Path(tempfile.mkdtemp(prefix="reference_dryrun_"))
    for arch, shape, multi_pod in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = rd.dryrun_cell(arch, shape, multi_pod, force=True)
        print(f"{arch} {shape} {'2x16x16' if multi_pod else '16x16'}: "
              f"{rec.get('status')} {str(rec.get('error', ''))[:200]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("phi3-medium-14b"),
                              attn_impl="flat")
    shape = next(s for s in SHAPES if s.name == "prefill_32k")
    mesh = make_production_mesh(multi_pod=False)
    try:
        cell = build_cell(cfg, shape, mesh)
        with mesh:
            jax.jit(cell.fn, in_shardings=cell.in_shardings).lower(
                *cell.args).compile()
        status = "ok"
    except Exception as e:     # noqa: BLE001 — recorded, not raised
        status = f"error {type(e).__name__}: {str(e)[:200]}"
    print(f"phi3-medium-14b (attn_impl flat) prefill_32k 16x16: {status} "
          f"({time.perf_counter() - t0:.1f} s)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shardability", action="store_true")
    ap.add_argument("--dryrun", action="store_true")
    args = ap.parse_args()
    if args.shardability:
        shardability()
    if args.dryrun:
        dryrun()


if __name__ == "__main__":
    main()
