"""Per-phase parity of the PyTorch port against the JAX reference.

Both packages start each phase from the same state: a mid-run reference
state, carried across through ``repro_torch.core.convert`` (numpy dicts
keyed by the reference containers' field names).  The reference runs its
phase jitted with the application and the swept scalars as traced
arguments, as inside its compiled tick, under the non-partitionable
threefry derivation its goldens were pinned with.  Integer leaves must be
equal; float leaves must be bit-identical too (ULP bound 0) — the port
writes out the fused multiply-adds the reference's compiled program
contracts, so no float leaf of a phase differs.

The helpers here are shared with ``test_torch_sim.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core.engine as jeng
from repro.core import generator as jgen
from repro.core import placement as jplace
from repro.core import scaling as jscal
from repro.core import scheduler as jsched
from repro.core.types import DynParams as JDyn
from test_layouts import matrix_sim

from repro_torch import random as trnd
from repro_torch.core import convert
from repro_torch.core import generator as tgen
from repro_torch.core import placement as tplace
from repro_torch.core import scaling as tscal
from repro_torch.core import scheduler as tsched
from repro_torch.core.types import DynParams as TDyn
from repro_torch.core.types import resolve_layout

# the port's tensors here are small: one intra-op thread per test
# process beats oversubscribing the cores across test workers
torch.set_num_threads(1)

FLOAT_ULPS = 0      # float leaves: bit-identical


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def jax_reference():
    """Run the reference as its goldens were pinned: non-partitionable
    threefry, with the compile cache cleared before and after (its key
    leaves the flag out, so a program compiled under one setting would be
    reused under the other)."""
    jeng.Simulation._compiled_cache.clear()
    try:
        with jax.threefry_partitionable(False):
            yield
    finally:
        jeng.Simulation._compiled_cache.clear()


def jax_tree_np(x) -> dict:
    """A reference container (state, app, trace) as nested numpy dicts."""
    out = {}
    for f in x._fields:
        v = getattr(x, f)
        if hasattr(v, "ints") and hasattr(v, "flts"):
            out[f] = {"ints": np.asarray(v.ints), "flts": np.asarray(v.flts)}
        elif hasattr(v, "_fields"):
            out[f] = jax_tree_np(v)
        else:
            out[f] = np.asarray(v)
    return out


def torch_tree_np(x) -> dict:
    out = {}
    for f in x._fields:
        v = getattr(x, f)
        if hasattr(v, "ints") and hasattr(v, "flts"):
            out[f] = {"ints": v.ints.numpy(), "flts": v.flts.numpy()}
        elif hasattr(v, "_fields"):
            out[f] = torch_tree_np(v)
        else:
            out[f] = v.numpy()
    return out


def _flat(d, pre=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + ".")
        else:
            yield pre + k, np.asarray(v)


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place (sign-aware)."""
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def assert_trees_match(got: dict, want: dict, float_ulps: int = FLOAT_ULPS,
                       where: str = "") -> None:
    """Integer leaves equal, float leaves within ``float_ulps`` (0 = bit
    for bit; NaN never occurs in these states)."""
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys(), (where, sorted(set(g) ^ set(w)))
    for k in w:
        a, b = g[k], w[k]
        assert a.shape == b.shape, (where, k, a.shape, b.shape)
        if b.dtype.kind == "f":
            d = ulp_distance(a, b)
            assert d.max(initial=0) <= float_ulps, \
                f"{where}{k}: {int((d > 0).sum())} floats differ, max " \
                f"{int(d.max())} ULP"
        else:
            np.testing.assert_array_equal(
                a.astype(np.int64), b.astype(np.int64),
                err_msg=f"{where}{k}")


def torch_app(app) -> "convert.AppStatic":
    return convert.app_from_numpy(
        {k: np.asarray(v) for k, v in app._asdict().items()}, device="cpu")


# ---------------------------------------------------------------------------
# a mid-run reference state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mid():
    """The golden scenario (uniform network, no faults) run 150 ticks by
    the reference."""
    with jax_reference():
        sim = matrix_sim("uniform", "none", n_ticks=150)
        res = sim.run()
        st = res.state
        keys = jax.random.split(st.rng, 5)
    return sim, st, keys


def _both(sim, jst):
    """(reference state, the port's copy of it, layout)."""
    layout = resolve_layout(sim.params)
    return jst, convert.state_from_numpy(jax_tree_np(jst), layout,
                                         device="cpu"), layout


def test_key_schedule_matches(mid):
    sim, jst, keys = mid
    _, tst, _ = _both(sim, jst)
    tkeys = trnd.split(tst.rng, 5)
    np.testing.assert_array_equal(np.asarray(keys, np.int64),
                                  tkeys.numpy())


def test_client_phase_matches(mid):
    sim, jst, keys = mid
    _, tst, _ = _both(sim, jst)
    dyn = JDyn.from_params(sim.params)
    with jax_reference():
        got_j = jax.jit(lambda st, d, a, k: jgen.client_phase(
            st.clients.wait, st.time, st.requests.count, a.api_cdf, d, k))(
            jst, dyn, sim.app, keys[1])
    tk = trnd.split(tst.rng, 5)
    got_t = tgen.client_phase(tst.clients.wait, tst.time,
                              tst.requests.count,
                              torch_app(sim.app).api_cdf,
                              TDyn.from_params(sim.params), tk[1])
    assert_trees_match(torch_tree_np(got_t), jax_tree_np(got_j),
                       where="client_phase.")


PHASES = ("gen_spawn", "dispatch", "execute", "derive", "complete")


def _run_phase_chain(sim, jst, keys, upto):
    """Run the reference phases before ``upto`` to get its input state,
    then ``upto`` itself on both packages from that same state."""
    caps, params, app = sim.caps, sim.params, sim.app
    dyn = JDyn.from_params(params)
    tdyn = TDyn.from_params(params)
    tapp = torch_app(app)
    layout = resolve_layout(params)
    tkeys = trnd.split(convert.state_from_numpy(
        jax_tree_np(jst), layout, device="cpu").rng, 5)
    with jax_reference():
        gen = jax.jit(lambda st, d, a, k: jgen.client_phase(
            st.clients.wait, st.time, st.requests.count, a.api_cdf, d,
            k))(jst, dyn, app, keys[1])
        j_gen = jax.jit(lambda st, d, a, k, g: jsched.gen_spawn(
            st, a, caps, g.fired, g.api, g.wait_proposal, k, d))
        j_disp = jax.jit(lambda st, d, a, k: jsched.dispatch(
            st, a, caps, params, d, k))
        j_exec = jax.jit(lambda st, d, a: jsched.execute(st, a, caps,
                                                         params, d))
        j_der = jax.jit(lambda st, a, i, k: jsched.derive(
            st, a, caps, i, k, params=params))
        j_done = jax.jit(lambda st, d: jsched.complete(st, d))
        st = jst
        info = None
        for ph in PHASES:
            src = convert.state_from_numpy(jax_tree_np(st), layout,
                                           device="cpu")
            if ph == "gen_spawn":
                out_j, _ = j_gen(st, dyn, app, keys[2], gen)
                if ph == upto:
                    tg = tgen.client_phase(src.clients.wait, src.time,
                                           src.requests.count, tapp.api_cdf,
                                           tdyn, tkeys[1])
                    out_t, _ = tsched.gen_spawn(src, tapp, caps, tg.fired,
                                                tg.api, tg.wait_proposal,
                                                tkeys[2], tdyn)
            elif ph == "dispatch":
                out_j = j_disp(st, dyn, app, keys[3])
                if ph == upto:
                    out_t = tsched.dispatch(src, tapp, caps, params, tdyn,
                                            tkeys[3])
            elif ph == "execute":
                out_j, info = j_exec(st, dyn, app)
                if ph == upto:
                    out_t, tinfo = tsched.execute(src, tapp, caps, params,
                                                  tdyn)
                    assert_trees_match(torch_tree_np(tinfo),
                                       jax_tree_np(info),
                                       where="execute.info.")
            elif ph == "derive":
                out_j = j_der(st, app, info, keys[4])
                if ph == upto:
                    tinfo = tsched.FinishInfo(*[
                        torch.from_numpy(np.array(x)) for x in info])
                    out_t = tsched.derive(src, tapp, caps, tinfo, tkeys[4])
            else:
                out_j, _ = j_done(st, dyn)
                if ph == upto:
                    out_t, _ = tsched.complete(src, tdyn)
            if ph == upto:
                return out_j, out_t
            st = out_j
    raise AssertionError(upto)


@pytest.mark.parametrize("phase", PHASES)
def test_phase_matches_reference(mid, phase):
    sim, jst, keys = mid
    out_j, out_t = _run_phase_chain(sim, jst, keys, phase)
    assert_trees_match(convert.state_to_numpy(out_t), jax_tree_np(out_j),
                       where=f"{phase}.")


SCALING = {
    # name: SimParams overrides that make the event act on this state
    "hs_out": dict(scaling_policy=1, hs_util_hi=0.01),
    "hs_in": dict(scaling_policy=1, hs_util_hi=2.0, hs_util_lo=0.99),
    "vs": dict(scaling_policy=2, vs_util_hi=0.01, vs_util_lo=0.005),
    "hybrid": dict(scaling_policy=3, hs_util_hi=0.01, vs_util_hi=0.01),
}


@pytest.mark.parametrize("case", sorted(SCALING))
def test_scaling_event_matches_reference(mid, case):
    sim, jst, _ = mid
    params = dataclasses.replace(sim.params, **SCALING[case])
    caps = dataclasses.replace(sim.caps, max_replicas=4)
    layout = resolve_layout(params)
    # give services room to scale out: two more replica ranks and four
    # free instance slots, added the same way on both sides
    d = jax_tree_np(jst)
    iof = d["sched"]["inst_of_rank"]
    d["sched"]["inst_of_rank"] = np.concatenate(
        [iof, np.full((iof.shape[0], 2), -1, iof.dtype)], axis=1)
    free = {"service": -1, "vm": -1, "host": -1}
    d["instances"] = {k: np.concatenate([v, np.full(
        (4,), free.get(k, 0), v.dtype)]) for k, v in d["instances"].items()}
    src = convert.state_from_numpy(d, layout, device="cpu")
    jnp_ = jax.numpy
    jst2 = jst._replace(
        sched=type(jst.sched)(**{k: jnp_.asarray(v)
                                 for k, v in d["sched"].items()}),
        instances=type(jst.instances)(**{k: jnp_.asarray(v) for k, v
                                         in d["instances"].items()}))
    with jax_reference():
        out_j = jax.jit(lambda st, dd, a: jscal.scaling_event(
            st, a, caps, params, dd))(jst2, JDyn.from_params(params),
                                      sim.app)
    out_t = tscal.scaling_event(src, torch_app(sim.app), caps, params,
                                TDyn.from_params(params))
    got, want = convert.state_to_numpy(out_t), jax_tree_np(out_j)
    assert_trees_match(got, want, where=f"scaling[{case}].")
    c = want["counters"]
    moved = int(c["scale_out"]) + int(c["scale_in"]) + int(c["scale_up"]) \
        + int(c["scale_down"]) - sum(int(v) for k, v in
                                     jax_tree_np(jst)["counters"].items()
                                     if k.startswith("scale_"))
    assert moved > 0, f"scaling[{case}] did nothing on this state"


def test_migrate_matches_reference(mid):
    sim, jst, _ = mid
    params = dataclasses.replace(sim.params, migration_enabled=True,
                                 mig_vm_util_hi=0.01)
    layout = resolve_layout(params)
    # shrink VM 0 so it runs hot and one of its instances has to move
    d = jax_tree_np(jst)
    d["vms"]["mips"] = d["vms"]["mips"].copy()
    d["vms"]["mips"][0] = 20000.0
    src = convert.state_from_numpy(d, layout, device="cpu")
    jst2 = jst._replace(vms=jst.vms._replace(
        mips=jax.numpy.asarray(d["vms"]["mips"])))
    with jax_reference():
        out_j = jax.jit(lambda st, dd, a: jplace.migrate(
            st, a, sim.caps, dd))(jst2, JDyn.from_params(params), sim.app)
    out_t = tplace.migrate(src, torch_app(sim.app), sim.caps,
                           TDyn.from_params(params))
    want = jax_tree_np(out_j)
    assert_trees_match(convert.state_to_numpy(out_t), want,
                       where="migrate.")
    assert int(want["counters"]["migrations"]) == 1


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------

def test_layouts_match_reference_in_every_mode():
    from repro.core.types import SimParams as JParams
    from repro.core.types import resolve_layout as jresolve
    from repro_torch.core.types import SimParams as TParams
    for network in ("uniform", "fabric"):
        for faults in ("none", "chaos"):
            for shaping in (False, True):
                kw = dict(network=network, faults=faults,
                          egress_shaping=shaping)
                j, t = jresolve(JParams(**kw)), resolve_layout(TParams(**kw))
                assert (j.i_fields, j.f_fields) == (t.i_fields, t.f_fields)


def test_initial_state_matches_reference(mid):
    """``Simulation.init_state`` (zeros_state + placement) leaf for leaf,
    dtypes included, for the golden scenario and for SockShop."""
    from repro.configs import sockshop as jsock
    from repro_torch.configs import sockshop as tsock
    from test_torch_sim import _port_matrix_sim
    sim = mid[0]
    pairs = [(sim, _port_matrix_sim(sim)),
             (jsock.make_sim(100, 10.0, scaling_policy=1),
              tsock.make_sim(100, 10.0, scaling_policy=1, device="cpu"))]
    for jsim, tsim in pairs:
        with jax_reference():
            want = jax_tree_np(jsim.init_state())
        got = convert.state_to_numpy(tsim.init_state())
        for (k, a), (_, b) in zip(sorted(_flat(got)), sorted(_flat(want))):
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert_trees_match(got, want, where="init.")
        assert_trees_match(
            {k: v.numpy() for k, v in tsim.app._asdict().items()},
            {k: np.asarray(v) for k, v in jsim.app._asdict().items()},
            where="app.")
