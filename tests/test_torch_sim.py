"""The whole default simulation path of the port against a live run of the
JAX reference (non-partitionable threefry, compile cache cleared).

The final state must be bit-identical leaf for leaf, and the integer
traces equal.  The one float trace, ``used_mips`` (a per-tick sum over the
instance table), is summed in the order of the reference's compiled tick
(``pool.tree_sum``, XLA's 32-wide tree) and equals it bit for bit.  The
golden scenario also reproduces the reference's pins
(``tests/test_layouts.py`` ``MATRIX_GOLDEN``): 157 completed, 794
spawned, 789 finished, response digest 1306795296637.  The Table 2
capacity builder of the port is held against the reference's
``benchmarks/bench_capacity.py`` the same way, on scaled-down cases.
"""
import dataclasses

import numpy as np
import pytest

from test_layouts import MATRIX_GOLDEN, matrix_sim
from test_network import _digest_f32
from test_torch_phases import (assert_trees_match, jax_reference,
                               jax_tree_np, torch_tree_np)

from repro.configs import sockshop as jsockshop

from repro_torch.configs import sockshop as tsockshop
from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,
                              Simulation, convert, diamond)

INT_TRACES = ("completed", "generated", "n_waiting", "n_exec", "n_transit",
              "active_instances", "active_clients")


def _port_matrix_sim(jsim) -> Simulation:
    """The port's twin of ``test_layouts.matrix_sim``'s Simulation."""
    return Simulation(
        diamond(mi=400.0),
        caps=SimCaps(**dataclasses.asdict(jsim.caps)),
        params=SimParams(**dataclasses.asdict(jsim.params)),
        default_template=InstanceTemplate(mips=8000.0, limit_mips=16000.0,
                                          replicas=2),
        vm_mips=np.full(4, 64000.0, np.float32), device="cpu")


def _assert_runs_match(jres, tres):
    assert_trees_match(convert.state_to_numpy(tres.state),
                       jax_tree_np(jres.state), where="state.")
    jt, tt = jax_tree_np(jres.trace), torch_tree_np(tres.trace)
    for k in INT_TRACES:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    np.testing.assert_array_equal(tt["used_mips"].view(np.uint32),
                                  jt["used_mips"].view(np.uint32),
                                  err_msg="used_mips")


def test_golden_scenario_matches_live_reference_and_pins():
    with jax_reference():
        jsim = matrix_sim("uniform", "none")
        jres = jsim.run()
    tres = _port_matrix_sim(jsim).run()
    _assert_runs_match(jres, tres)
    st = tres.state
    pin = MATRIX_GOLDEN[("uniform", "none")]
    assert int(st.counters.completed) == pin["completed"] == 157
    assert int(st.counters.spawned) == pin["spawned"] == 794
    assert int(st.counters.finished) == pin["finished"] == 789
    assert _digest_f32(st.requests.response.numpy()) == pin["resp"]


def test_sockshop_hs_matches_live_reference():
    """A short SockShop run with HS scaling that scales out and in."""
    kw = dict(scaling_policy=1, hs_util_hi=0.05, hs_util_lo=0.04,
              share=300.0)
    with jax_reference():
        jres = jsockshop.make_sim(100, 60.0, **kw).run()
    tres = tsockshop.make_sim(100, 60.0, device="cpu", **kw).run()
    _assert_runs_match(jres, tres)
    c = tres.state.counters
    assert int(c.scale_out) > 0 and int(c.scale_in) > 0
    assert int(c.completed) > 0


@pytest.mark.parametrize("tag,scale", [("case1b", 0.0005), ("case2a", 0.1),
                                       ("case3a", 0.01)])
def test_capacity_case_matches_live_reference(tag, scale):
    """The port's Table 2 builder (``configs/capacity.py``) sizes a case
    exactly as ``benchmarks/bench_capacity.py`` does, and its first 60
    ticks are bit-identical to the reference's (request count scaled)."""
    from benchmarks import bench_capacity
    from repro_torch.configs import capacity
    n_req, S, reps, _, fanout = capacity.CASES[tag]
    n_req = max(int(n_req * scale), 100)
    with jax_reference():
        jsim, jmeta = bench_capacity.build_case(n_req, S, reps, fanout)
        jsim.params = dataclasses.replace(jsim.params, n_ticks=60)
        jres = jsim.run()
    tsim, tmeta = capacity.build_case(n_req, S, reps, fanout, device="cpu")
    assert {k: tmeta[k] for k in jmeta} == jmeta
    assert tsim.caps == type(tsim.caps)(**dataclasses.asdict(jsim.caps))
    state, _ = tsim.run_state(tsim.init_state(), n_ticks=60)
    assert_trees_match(convert.state_to_numpy(state),
                       jax_tree_np(jres.state), where=f"{tag}.")
    assert int(state.counters.spawned) > 0
