"""Where does a run of the port leave the JAX reference?

As a script, it runs a Table 2 capacity case (optionally with the fabric
on) for ``--ticks`` ticks in both packages on the CPU, the reference as
its runs compile it (the tick scan, non-partitionable threefry), and
prints every state leaf that differs, with the largest distance in
float32 ULPs.  With ``--locate`` it steps the reference's compiled tick
scan two ticks at a time, runs the port from each of its states, and
prints the first two-tick window in which a leaf outside ``NetStats``
differs: the place to look for a rounding the reference's compiled
program takes that the port does not.

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu \\
        python tests/test_torch_drift.py --case case1b --scale 0.001 \\
        --ticks 200 --net --locate

As a test, it holds whole runs that stay on the reference, every leaf
identical: case3a+net (100 services × 3 replicas on a four-host fabric)
over 100 ticks, and runs with one service or one API (case1b at 1000
requests with and without the fabric, case2a+net) past the ticks where
they used to leave it.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import numpy as np
import pytest

from benchmarks import bench_capacity
from repro.core.types import DynParams as JDyn
from test_torch_phases import _flat, jax_reference, jax_tree_np, ulp_distance

from repro_torch.configs import capacity
from repro_torch.core import convert
from repro_torch.core.types import resolve_layout


def diff(got: dict, want: dict, skip_net: bool = False) -> list:
    """(leaf, max ULP or "int") for every leaf that differs."""
    g, w = dict(_flat(got)), dict(_flat(want))
    out = []
    for k in w:
        if skip_net and k.startswith("net."):
            continue
        if np.array_equal(g[k], w[k]):
            continue
        out.append((k, int(ulp_distance(g[k], w[k]).max())
                    if w[k].dtype.kind == "f" else "int"))
    return out


def _run(tag: str, scale: float, ticks: int):
    """(the port's final state, the reference's) after ``ticks`` ticks."""
    case, net = tag.split("+")[0], tag.endswith("+net")
    n_req, S, reps, _, fanout = capacity.CASES[case]
    tsim, _ = capacity.build_tagged(tag, scale, device="cpu")
    with jax_reference():
        jsim, _ = bench_capacity.build_case(
            max(int(n_req * scale), 100), S, reps, fanout, network=net)
        jsim.params = dataclasses.replace(jsim.params, n_ticks=ticks)
        want = jax_tree_np(jsim.run().state)
    state, _ = tsim.run_state(tsim.init_state(), n_ticks=ticks)
    return convert.state_to_numpy(state), want


def test_case3a_net_run_stays_on_the_reference():
    got, want = _run("case3a+net", 0.01, 100)
    assert diff(got, want) == []
    assert int(got["net"]["transits"]) > 0


@pytest.mark.parametrize("tag,scale,ticks", [("case1b+net", 0.001, 30),
                                             ("case1b", 0.001, 200),
                                             ("case2a+net", 0.1, 60)])
def test_one_entry_table_run_stays_on_the_reference(tag, scale, ticks):
    """case1b+net first left the reference in ticks 24-25 and case1b's
    ``usage_sum`` by one ULP after 200 ticks, through a spawn length;
    case2a+net's per-host ingress sum by one ULP after 60 ticks, through
    a payload.  The reference folds ``normal``'s sqrt(2) into a std drawn
    from a one-entry table (one service, one API: ``random.normal_fma``)."""
    got, want = _run(tag, scale, ticks)
    assert diff(got, want) == []


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="case1b")
    ap.add_argument("--scale", type=float, default=0.001)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--net", action="store_true")
    ap.add_argument("--locate", action="store_true")
    a = ap.parse_args()
    n_req, S, reps, _, fanout = capacity.CASES[a.case]
    tag = a.case + ("+net" if a.net else "")
    tsim, _ = capacity.build_tagged(tag, a.scale, device="cpu")
    with jax_reference():
        jsim, _ = bench_capacity.build_case(
            max(int(n_req * a.scale), 100), S, reps, fanout,
            network=a.net)
        jsim.params = dataclasses.replace(jsim.params, n_ticks=a.ticks)
        jfinal = jsim.run().state
        if a.locate:
            tick, dyn = jsim._tick, JDyn.from_params(jsim.params)
            two = jax.jit(lambda st, d, ap_: jax.lax.scan(
                lambda s, _: tick(s, d, ap_), st, None, length=2)[0])
            states = [jsim.init_state()]
            for _ in range(a.ticks // 2):
                states.append(two(states[-1], dyn, jsim.app))
    state, _ = tsim.run_state(tsim.init_state(), n_ticks=a.ticks)
    print(f"{tag} x{a.scale} after {a.ticks} ticks:",
          diff(convert.state_to_numpy(state), jax_tree_np(jfinal)) or
          "identical")
    if not a.locate:
        return
    layout = resolve_layout(tsim.params)
    for k in range(a.ticks // 2):
        src = convert.state_from_numpy(jax_tree_np(states[k]), layout,
                                       device="cpu")
        out, _ = tsim.run_state(src, n_ticks=2, first_tick=2 * k)
        bad = diff(convert.state_to_numpy(out), jax_tree_np(states[k + 1]),
                   skip_net=True)
        if bad:
            print(f"first divergence in ticks {2 * k}-{2 * k + 1}: {bad}")
            return
    print("no divergence outside NetStats")


if __name__ == "__main__":
    main()
