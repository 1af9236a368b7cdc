#!/usr/bin/env python3
"""Pins for ``chip_smoke.py``'s full-size runs, taken from the JAX
reference on the CPU.

chip_smoke imports neither JAX nor the JAX package, so the reference's
results at chip_smoke's own configurations are computed here and written
into it as constants (``PIN_LEAVES``, ``CAPACITY_PINS``,
``SOCKSHOP_PINS``, ``SWEEP_PINS``; this script prints them):

* Table 2 case1b, case1b+net, case2b and the chaos cases case1b+faults,
  case1b+chaos2 and case1b+net+chaos2 (``benchmarks/bench_capacity.py``
  sizing, which the port's ``configs/capacity.py`` must copy: checked): a
  digest of every leaf of the final state, the reference's state carried
  into the port's containers (``repro_torch.core.convert``) and digested
  as chip_smoke digests the card's (``chip_smoke.leaf_digests``);
* SockShop (paper §6.3): 100 clients HS and 300 NS over 600 s, 300 HS
  over 180 s: the response digest and the integer counters;
* ``benchmarks/bench_scaling.py``'s ``sweep8_demo`` (SockShop, HS,
  ``FIG11_KNOBS``, 8 loads from 200 to 1100 clients over 600 s) as one
  ``run_batch``: each point's response digest and integer counters
  (``SWEEP_PINS``, in load order);
* ``examples/chaos_study.py``'s sweep (radii 1, 2, 5 x ejection off and
  on, 100 clients over 120 s) as one ``run_batch(apps=)``: each point's
  response digest, integer counters and ``FaultStats`` (``CHAOS_PINS``,
  ``chip_smoke.chaos_summary``).  chip_smoke's copy of the study's
  configuration (``CHAOS_STUDY``) is checked against the example's
  source, and its copy of the golden scenario's chaos pins
  (``GOLDEN_CHAOS``) against ``tests/test_layouts.py``'s.

The reference runs as its goldens were pinned: non-partitionable threefry,
compile cache cleared; numpy runs on its baseline code paths, as in
chip_smoke (its ``NUMPY_BASELINE``: the instance placement's order among
VMs of equal free capacity is numpy's argsort's, which depends on the SIMD
sort numpy dispatches to).  Run from the repository root (the reference
takes about 40 s for case2b and under two minutes in all on the CPU, and
a few minutes more for the sweeps):

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python tools/chip_smoke_pins.py

``--port`` also runs the port on the CPU at the same configurations and
names the first leaf that differs from the reference (about eight
minutes more in all).  ``--only`` restricts the runs to the named cases.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# chip_smoke puts numpy on its baseline code paths (its NUMPY_BASELINE) as
# it is imported: first, so that the reference and the port place
# instances as chip_smoke's runs will
assert "numpy" not in sys.modules
import chip_smoke  # noqa: E402

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

CAPACITY = ("case1b", "case1b+net", "case2b") + chip_smoke.CHAOS_CASES \
    + chip_smoke.OBS_CASES


def _reference():
    from test_torch_phases import jax_reference
    return jax_reference()


def _collect(export, run):
    """``run()`` with the metric and alert rows ``export`` streams: the
    result and the rows' summaries (``chip_smoke.rows_summary``,
    ``alerts_summary``)."""
    with export.collecting() as rows, export.alert_collecting() as ev:
        out = run()
    return out, dict(chip_smoke.rows_summary(rows.rows),
                     **chip_smoke.alerts_summary(ev.rows))


def capacity_pins(tag, port, row_pins):
    from benchmarks import bench_capacity
    from repro.obs import export as jexport
    from repro_torch.configs import capacity
    from repro_torch.core import convert
    from repro_torch.core.types import resolve_layout
    from repro_torch.obs import export as texport
    from test_torch_phases import jax_tree_np
    import dataclasses
    case, _, variant = tag.partition("+")
    n_req, S, reps, _, fanout = capacity.CASES[case]
    t0 = time.perf_counter()
    with _reference():
        jsim, _ = bench_capacity.build_case(n_req, S, reps, fanout,
                                            **capacity.VARIANTS[variant])
        jres, rows = _collect(jexport, jsim.run)
        jst = jres.state
    if tag in chip_smoke.OBS_CASES:
        row_pins[tag] = rows
    tree = jax_tree_np(jst)
    tsim = capacity.build_tagged(tag, device="cpu")[0]
    assert dataclasses.asdict(tsim.params) == \
        dataclasses.asdict(jsim.params), f"{tag}: SimParams drifted"
    assert dataclasses.asdict(tsim.caps) == dataclasses.asdict(jsim.caps)
    assert (tsim.app.host_zone.numpy() == np.asarray(
        jsim.app.host_zone)).all(), f"{tag}: host_zone drifted"
    layout = resolve_layout(tsim.params)
    state = convert.state_from_numpy(tree, layout, device="cpu")
    pins = chip_smoke.leaf_digests(state)
    print(f"# {tag}: reference {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if port:
        t0 = time.perf_counter()
        tsim, _ = capacity.build_tagged(tag, device="cpu")
        tres, trows = _collect(texport, tsim.run)
        got = chip_smoke.leaf_digests(tres.state)
        bad = [k for k in pins if got.get(k) != pins[k]]
        if tag in chip_smoke.OBS_CASES and trows != rows:
            bad.append(f"streamed rows {trows} != {rows}")
        print(f"# {tag}: port on the CPU {time.perf_counter() - t0:.1f} s, "
              f"{'matches' if not bad else f'differs first in {bad[0]}'}"
              f" ({len(bad)} of {len(pins)} leaves differ)", file=sys.stderr)
    return pins


def sockshop_pins(n_clients, duration, policy, port):
    from repro.configs import sockshop as jsock
    t0 = time.perf_counter()
    with _reference():
        jst = jsock.make_sim(n_clients, duration,
                             scaling_policy=policy).run().state
    pins = chip_smoke.sockshop_summary(jst)
    print(f"# sockshop {n_clients} {duration:.0f} s policy {policy}: "
          f"reference {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if port:
        from repro_torch.configs import sockshop as tsock
        t0 = time.perf_counter()
        got = chip_smoke.sockshop_summary(tsock.make_sim(
            n_clients, duration, scaling_policy=policy,
            device="cpu").run().state)
        print(f"# ... port on the CPU {time.perf_counter() - t0:.1f} s, "
              f"{'matches' if got == pins else f'differs: {got}'}",
              file=sys.stderr)
    return pins


def sweep_pins(port):
    """The reference's ``sweep8_demo`` sweep as one ``run_batch``: each
    point's ``sockshop_summary``, in load order.  chip_smoke keeps its own
    copy of the sweep's knobs and loads (it imports no part of the JAX
    package); they must be the benchmark's."""
    import dataclasses
    from benchmarks import bench_scaling
    from repro.configs import sockshop as jsock
    from repro.core import batch_item, policies
    knobs, loads = chip_smoke.FIG11_KNOBS, chip_smoke.SWEEP8_LOADS
    assert knobs == bench_scaling.FIG11_KNOBS, "FIG11_KNOBS drifted"
    assert list(loads) == [int(x) for x in np.linspace(200, 1100, 8)]
    t0 = time.perf_counter()
    with _reference():
        jsim = jsock.make_sim(n_clients=max(loads), duration_s=600.0,
                              scaling_policy=policies.SCALE_HORIZONTAL,
                              **knobs)
        sweeps = [dataclasses.replace(jsim.params, n_clients=int(nc),
                                      spawn_rate=float(nc) / 30.0)
                  for nc in loads]
        res = jsim.run_batch(sweeps)
        pins = [chip_smoke.sockshop_summary(batch_item(res, b).state)
                for b in range(len(loads))]
    print(f"# sweep8: reference {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if port:
        from repro_torch.configs import sockshop as tsock
        from repro_torch.core import batch_item as titem
        t0 = time.perf_counter()
        tsim = tsock.make_sim(n_clients=max(loads), duration_s=600.0,
                              scaling_policy=policies.SCALE_HORIZONTAL,
                              device="cpu", **knobs)
        tres = tsim.run_batch([dataclasses.replace(p) for p in sweeps])
        got = [chip_smoke.sockshop_summary(titem(tres, b).state)
               for b in range(len(loads))]
        print(f"# ... port on the CPU {time.perf_counter() - t0:.1f} s, "
              f"{'matches' if got == pins else f'differs: {got}'}",
              file=sys.stderr)
    return pins


def check_copies():
    """chip_smoke's copies of the chaos study's configuration and of the
    golden scenario's chaos pins must be the sources'."""
    import ast
    from test_layouts import MATRIX_GOLDEN
    for net, pins in chip_smoke.GOLDEN_CHAOS.items():
        want = MATRIX_GOLDEN[(net, "chaos")]
        got = dict(pins, resp=pins["resp_digest"])
        assert all(got[k] == want[k] for k in want if k != "used_mips"), \
            f"GOLDEN_CHAOS[{net!r}] drifted"
    src = open(os.path.join(ROOT, "examples", "chaos_study.py")).read()
    tree = ast.parse(src)
    defaults, kw = {}, {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") \
                == "add_argument":
            for k in n.keywords:
                if k.arg == "default":
                    defaults[n.args[0].value.lstrip("-").replace("-", "_")] \
                        = ast.literal_eval(k.value)
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") \
                == "make_sim":
            for k in n.keywords:
                text = ast.unparse(k.value)
                if text.startswith("args."):
                    kw[k.arg] = defaults[text[5:]]
                elif k.arg not in ("placement_policy", "host_zone"):
                    kw[k.arg] = eval(text, {"float": float})
                else:
                    kw[k.arg] = text
    assert kw.pop("placement_policy") == "policies.PLACE_SPREAD"
    assert kw.pop("host_zone") == "zones(radii[0])"
    assert kw == chip_smoke.CHAOS_STUDY, f"CHAOS_STUDY drifted: {kw}"
    radii = tuple(int(x) for x in defaults["radii"].split(","))
    assert radii == chip_smoke.CHAOS_RADII
    assert chip_smoke.CHAOS_EJECT == (2.0, defaults["eject_thresh"])
    assert "(np.arange(N_HOSTS) // radius)" in src \
        and "N_HOSTS = 10" in src and chip_smoke.CHAOS_HOSTS == 10


def chaos_pins(port):
    """The reference's chaos study as one ``run_batch(apps=)``: each
    point's ``chaos_summary``, radius by radius, ejection off then on."""
    import dataclasses
    import jax.numpy as jnp
    from repro.configs import sockshop as jsock
    from repro.core import batch_item, policies
    check_copies()
    cs = chip_smoke
    t0 = time.perf_counter()

    def sweep(sock, zone_table):
        sim = sock.make_sim(placement_policy=policies.PLACE_SPREAD,
                            host_zone=cs.study_zones(cs.CHAOS_RADII[0]),
                            **cs.CHAOS_STUDY, **kw)
        points, apps = [], []
        for r in cs.CHAOS_RADII:
            app_r = sim.app._replace(host_zone=zone_table(cs.study_zones(r)))
            for thresh in cs.CHAOS_EJECT:
                points.append(dataclasses.replace(sim.params,
                                                  eject_err_thresh=thresh))
                apps.append(app_r)
        return sim.run_batch(points, apps=apps), len(points)

    kw = {}
    with _reference():
        res, B = sweep(jsock, jnp.asarray)
        pins = [cs.chaos_summary(batch_item(res, b).state) for b in range(B)]
    print(f"# chaos study: reference {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if port:
        import torch
        from repro_torch.configs import sockshop as tsock
        from repro_torch.core import batch_item as titem
        t0 = time.perf_counter()
        kw = dict(device="cpu")
        tres, _ = sweep(tsock, torch.from_numpy)
        got = [cs.chaos_summary(titem(tres, b).state) for b in range(B)]
        print(f"# ... port on the CPU {time.perf_counter() - t0:.1f} s, "
              f"{'matches' if got == pins else f'differs: {got}'}",
              file=sys.stderr)
    return pins


def check_obs_copies():
    """chip_smoke's copies of ``examples/telemetry_study.py``'s
    ``TEL_KW`` and of the arguments ``examples/slo_study.py`` gives
    ``sockshop.make_sim`` must be the examples' own."""
    import importlib.util
    mods = {}
    for name in ("telemetry_study", "slo_study"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    assert mods["telemetry_study"].TEL_KW == chip_smoke.TEL_KW, \
        "TEL_KW drifted"
    study = mods["slo_study"]
    args = {}
    real = study.sockshop.make_sim
    study.sockshop.make_sim = lambda **kw: args.update(kw)
    try:
        study.make_sim(240.0, 100)
    finally:
        study.sockshop.make_sim = real
    assert (args.pop("host_zone") == chip_smoke.slo_zones()).all()
    assert args.pop("placement_policy") == 3      # policies.PLACE_SPREAD
    assert args == chip_smoke.SLO_STUDY, f"SLO_STUDY drifted: {args}"
    # the arms and the example's defaults, from its source
    import ast
    tree = ast.parse(open(os.path.join(ROOT, "examples",
                                       "slo_study.py")).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    replaced = [{k.arg: ast.literal_eval(k.value) for k in n.keywords}
                for n in calls if ast.unparse(n.func) == "dataclasses.replace"]
    arms = [dict(arm) for _, arm in chip_smoke.SLO_ARMS]
    shared = {"scale_interval": arms[0].pop("scale_interval")}
    arms[1].pop("scale_interval")
    assert replaced == [shared] + arms, f"SLO_ARMS drifted: {replaced}"
    defaults = {n.args[0].value: ast.literal_eval(k.value) for n in calls
                if ast.unparse(n.func) == "ap.add_argument"
                for k in n.keywords if k.arg == "default"}
    assert (defaults["--duration"], defaults["--clients"]) == (240.0, 100)


def trace_pins(port):
    """SockShop 100 clients HS over 600 s with ``TEL_KW``: the streamed
    rows and ``verify_traces``'s checks (``chip_smoke.traces_summary``)."""
    from repro.configs import sockshop as jsock
    from repro.obs import export as jexport
    from repro.obs import spans as jspans
    check_obs_copies()
    t0 = time.perf_counter()
    with _reference():
        jsim = jsock.make_sim(100, 600.0, scaling_policy=1,
                              **chip_smoke.TEL_KW)
        with jexport.collecting() as rows:
            jres = jsim.run()
        checks = jspans.verify_traces(jres.state, jsim.graph,
                                      int(jsim.app.succ.shape[1]))
    assert chip_smoke.sockshop_summary(jres.state) == sockshop_pins(
        100, 600.0, 1, False), "telemetry changed the SockShop run"
    pins = dict(chip_smoke.rows_summary(rows.rows),
                **chip_smoke.traces_summary(checks))
    print(f"# sockshop traces: reference {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if port:
        from repro_torch.configs import sockshop as tsock
        from repro_torch.obs import export as texport
        from repro_torch.obs import spans as tspans
        t0 = time.perf_counter()
        tsim = tsock.make_sim(100, 600.0, scaling_policy=1, device="cpu",
                              **chip_smoke.TEL_KW)
        with texport.collecting() as trows:
            tres = tsim.run()
        got = dict(chip_smoke.rows_summary(trows.rows),
                   **chip_smoke.traces_summary(tspans.verify_traces(
                       tres.state, tsim.graph, int(tsim.app.succ.shape[1]))))
        print(f"# ... port on the CPU {time.perf_counter() - t0:.1f} s, "
              f"{'matches' if got == pins else f'differs: {got}'}",
              file=sys.stderr)
    return pins


def slo_pins(port):
    """``examples/slo_study.py``'s two arms as one ``run_batch``: each
    arm's ``chip_smoke.slo_summary``."""
    import dataclasses
    from repro.configs import sockshop as jsock
    from repro.core import batch_item
    from repro.obs import export as jexport
    cs = chip_smoke
    check_obs_copies()

    def sweep(sock, export, **kw):
        sim = sock.make_sim(placement_policy=3, host_zone=cs.slo_zones(),
                            **cs.SLO_STUDY, **kw)
        points = [dataclasses.replace(sim.params, **arm)
                  for _, arm in cs.SLO_ARMS]
        with export.alert_collecting() as ev:
            res = sim.run_batch(points)
        return res, ev.rows

    t0 = time.perf_counter()
    with _reference():
        res, rows = sweep(jsock, jexport)
        pins = [cs.slo_summary(batch_item(res, b).state,
                               [r for r in rows if int(r["tag"]) == b])
                for b in range(len(cs.SLO_ARMS))]
    print(f"# slo study: reference {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    if port:
        from repro_torch.configs import sockshop as tsock
        from repro_torch.core import batch_item as titem
        from repro_torch.obs import export as texport
        t0 = time.perf_counter()
        tres, trows = sweep(tsock, texport, device="cpu")
        got = [cs.slo_summary(titem(tres, b).state,
                              [r for r in trows if int(r["tag"]) == b])
               for b in range(len(cs.SLO_ARMS))]
        print(f"# ... port on the CPU {time.perf_counter() - t0:.1f} s, "
              f"{'matches' if got == pins else f'differs: {got}'}",
              file=sys.stderr)
    return pins


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU and compare")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of "
                    f"{', '.join(CAPACITY)}, sockshop, sweep, chaos, "
                    "traces, slo")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    rows = {}
    cap = {tag: capacity_pins(tag, args.port, rows) for tag in CAPACITY
           if not only or tag in only}
    sock = {}
    if not only or "sockshop" in only:
        for case in chip_smoke.SOCKSHOP_CASES:
            sock["%d/%d/%d" % (case[0], case[1], case[2])] = sockshop_pins(
                *case, args.port)
    sweep = sweep_pins(args.port) if not only or "sweep" in only else []
    chaos = chaos_pins(args.port) if not only or "chaos" in only else []
    traces = trace_pins(args.port) if not only or "traces" in only else {}
    slo = slo_pins(args.port) if not only or "slo" in only else []
    print(_source(cap, sock, sweep, chaos, rows, traces, slo))
    return 0


def _dicts(name, items, indent="    ") -> list:
    """``name = (dict, ...)`` with the dictionaries' keys quoted."""
    out = [f"{name} = ("]
    for pin in items:
        rows = _packed([f'"{k}": {v!r},' for k, v in sorted(pin.items())],
                       indent + " ", " ")
        out.append(indent + "{" + rows[0].rstrip())
        out += [indent + " " + r.rstrip() for r in rows[1:]]
        out[-1] = out[-1][:-1] + "},"
    out.append(")")
    return out


def _packed(words, indent, sep):
    rows, row = [], ""
    for w in words:
        if row and len(indent) + len(row) + len(w) + len(sep) > 77:
            rows.append(row)
            row = ""
        row += w + sep
    return rows + [row] if row else rows


def _source(cap, sock, sweep=(), chaos=(), row_pins=None, traces=None,
            slo=()) -> str:
    """The pins as chip_smoke's constants: the leaf names once
    (``PIN_LEAVES``, sorted), each capacity case's leaf digests in that
    order as one string, the SockShop summaries as dictionaries; lines of
    at most 79 characters."""
    def packed(words, indent, sep):
        rows, row = [], ""
        for w in words:
            if row and len(indent) + len(row) + len(w) + len(sep) > 77:
                rows.append(row)
                row = ""
            row += w + sep
        return rows + [row] if row else rows
    leaves = sorted(next(iter(cap.values()))) if cap else []
    assert all(sorted(v) == leaves for v in cap.values())
    out = ["PIN_LEAVES = ("]
    out += ["    " + r.rstrip() for r in
            packed([f'"{k}",' for k in leaves], "    ", " ")]
    out[-1] += ")"
    out.append("CAPACITY_PINS = {")
    for case in sorted(cap):
        out.append(f'    "{case}": (')
        rows = packed([cap[case][k] for k in leaves], "        ", " ")
        out += [f'        "{r}"' for r in rows]
        out[-1] = out[-1][:-2] + '"),'
    out.append("}")
    out.append("SOCKSHOP_PINS = {")
    for case in sorted(sock):
        out.append(f'    "{case}": dict(')
        out += ["        " + r.rstrip() for r in packed(
            [f"{k}={v}," for k, v in sorted(sock[case].items())],
            "        ", " ")]
        out[-1] = out[-1][:-1] + "),"
    out.append("}")
    out.append("SWEEP_PINS = (")
    for pin in sweep:
        rows = packed([f"{k}={v}," for k, v in sorted(pin.items())],
                      "        ", " ")
        out.append("    dict(" + rows[0].rstrip())
        out += ["         " + r.rstrip() for r in rows[1:]]
        out[-1] = out[-1][:-1] + "),"
    out.append(")")
    out.append("CHAOS_PINS = (")
    for pin in chaos:
        rows = packed([f'"{k}": {v},' for k, v in sorted(pin.items())],
                      "        ", " ")
        out.append("    {" + rows[0].rstrip())
        out += ["     " + r.rstrip() for r in rows[1:]]
        out[-1] = out[-1][:-1] + "},"
    out.append(")")
    out.append("ROW_PINS = {")
    for tag, pin in sorted((row_pins or {}).items()):
        out += [f'    "{tag}": ' + "{"] + [
            "        " + r.rstrip() for r in _packed(
                [f'"{k}": {v!r},' for k, v in sorted(pin.items())],
                "        ", " ")] + ["    },"]
    out.append("}")
    out.append("TRACE_PINS = {")
    out += ["    " + r.rstrip() for r in _packed(
        [f'"{k}": {v!r},' for k, v in sorted((traces or {}).items())],
        "    ", " ")]
    out.append("}")
    out += _dicts("SLO_PINS", slo)
    return "\n".join(out)


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())
