"""Chaos mode of the port (``faults="chaos"``: the Disruption phase,
outlier ejection and the chaos branches of the scheduler, the fabric and
the engine) against the JAX reference.

Each case feeds the same inputs to the reference, run under the
non-partitionable threefry derivation as the other parity tests run it,
and to the port on the CPU, and compares every state leaf and every trace
exactly (tolerance 0, floats bit for bit) and ``summarize``'s report.
Here: the golden matrix's chaos combos (``tests/test_layouts.py``, whose
pinned fields the port must reproduce too), ``disruption`` alone against
the reference's phase jitted on its own, on the hand-built states of
``tests/test_faults.py`` (and ``transit``, ``execute`` and scale-in
there), ``random.exp`` against ``jax.jit(jnp.exp)`` and a key path
through a fold against ``jax.random``.  Each case is also held to the
reference test's own assertions, the chaos conservation law included.
The engine-level scenarios are in ``test_torch_faults_runs.py`` and
``test_torch_faults_scenarios.py``, the sweeps in
``test_torch_faults_sweeps.py``; the helpers here serve all four.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_faults as jtf
from test_layouts import MATRIX_GOLDEN, matrix_sim
from test_network import _digest_f32
from test_torch_phases import (assert_trees_match, jax_reference,
                               jax_tree_np, torch_app, torch_tree_np)

import repro.core as jcore
from repro.core import faults as jfaults
from repro.core import network as jnet
from repro.core import policies as jpol
from repro.core import scheduler as jsched
from repro.core.scaling import _scale_in as j_scale_in
from repro.core.types import DynParams as JDyn

from repro_torch import random as trnd
from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,
                              Simulation, build_graph, convert, diamond,
                              policies, summarize)
from repro_torch.core import faults as tfaults
from repro_torch.core import network as tnet
from repro_torch.core import scheduler as tsched
from repro_torch.core.batch import lift
from repro_torch.core.scaling import _scale_in as t_scale_in
from repro_torch.core.types import (CL_EXEC, CL_FREE, CL_WAITING,
                                    INST_DOWN, INST_DRAIN, INST_ON,
                                    DynParams as TDyn, resolve_layout)

torch.set_num_threads(1)

CHAOS_TMPL = dict(mips=8000.0, limit_mips=16000.0, replicas=2)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _twin(jsim, graph, template=None, **extra) -> Simulation:
    """The port's Simulation of the reference's ``jsim`` (same caps and
    params) over the port's twin of its graph, on the CPU."""
    if template is not None:
        extra["default_template"] = InstanceTemplate(**template)
    return Simulation(graph, caps=SimCaps(**dataclasses.asdict(jsim.caps)),
                      params=SimParams(**dataclasses.asdict(jsim.params)),
                      device="cpu", **extra)


def _chaos_twin(jsim):
    return _twin(jsim, diamond(mi=400.0), CHAOS_TMPL,
                 vm_mips=np.full(4, 64000.0, np.float32))


def _report(rep) -> dict:
    d = dataclasses.asdict(rep)
    d.pop("wall_time_s")
    d.pop("compile_time_s")
    return d


def _assert_runs_equal(tres, jres, where, tsim=None, jsim=None, tp=None,
                       jp=None):
    assert_trees_match(convert.state_to_numpy(tres.state),
                       jax_tree_np(jres.state), where=f"{where}.state.")
    assert_trees_match(torch_tree_np(tres.trace), jax_tree_np(jres.trace),
                       where=f"{where}.trace.")
    if tsim is not None:
        assert _report(summarize(tsim, tres, params=tp)) == \
            _report(jcore.summarize(jsim, jres, params=jp)), where


def _run_both(jsim, tsim, where):
    with jax_reference():
        jres = jsim.run()
    tres = tsim.run()
    _assert_runs_equal(tres, jres, where, tsim, jsim)
    return tres


def _conservation(st):
    """The reference's chaos conservation law on a port state: every
    spawned cloudlet finished, in flight or a counted failed attempt;
    ``n_exec`` equal to the pool; failed requests counted once."""
    status = st.cloudlets.status.numpy()
    in_flight = int((status != CL_FREE).sum())
    assert int(st.counters.spawned) == int(st.counters.finished) \
        + in_flight + int(st.fstats.failed_attempts)
    inst = st.cloudlets.inst.numpy()
    I = st.instances.status.shape[0]
    np.testing.assert_array_equal(
        np.bincount(inst[status == CL_EXEC], minlength=I)[:I],
        st.instances.n_exec.numpy())
    out = st.requests.outstanding.numpy()[:int(st.requests.count)]
    assert (out >= 0).all() and out.sum() == in_flight
    resp = st.requests.response.numpy()
    failed = st.requests.failed.numpy()
    assert int(st.counters.completed) == int((resp >= 0).sum())
    assert set(np.unique(failed)) <= {0, 1}
    assert int(st.fstats.failed_requests) == \
        int(((resp >= 0) & (failed > 0)).sum())


def _port_state(jstate, params):
    return convert.state_from_numpy(jax_tree_np(jstate),
                                    resolve_layout(params), device="cpu")


def _port_caps_params(caps, params):
    return (SimCaps(**dataclasses.asdict(caps)),
            SimParams(**dataclasses.asdict(params)))


def _disrupt_both(jstate, app, caps, params, dyn, key=7):
    """The reference's ``disruption`` jitted (app, dyn, state and keys
    traced) and the port's, from the same hand-built state and keys."""
    with jax_reference():
        k1, k2 = jax.random.split(jax.random.PRNGKey(key))
        jout = jax.jit(lambda st, a, d, x, y: jfaults.disruption(
            st, a, caps, params, d, x, y, None))(jstate, app, dyn, k1, k2)
    tk = trnd.split(trnd.PRNGKey(key), 2)
    tcaps, tparams = _port_caps_params(caps, params)
    tout = tfaults.disruption(_port_state(jstate, params), torch_app(app),
                              tcaps, tparams, TDyn.from_params(tparams),
                              tk[0], tk[1], None)
    assert_trees_match(convert.state_to_numpy(tout), jax_tree_np(jout),
                       where="disruption.")
    return tout


# ---------------------------------------------------------------------------
# the random numbers chaos adds: XLA's exp, keys below a fold
# ---------------------------------------------------------------------------

def test_exp_is_xlas_exp():
    xs = np.concatenate([
        np.linspace(-30.0, 0.0, 300_001, dtype=np.float32),
        # every float32 of [-1, 0] on a stride, and the clamp / flush edges
        np.arange(0x80000000, 0xBF800001, 4099, dtype=np.int64)
        .astype(np.uint32).view(np.float32),
        np.float32([-0.0, 0.0, -1e-30, -87.3, -87.5, -88.0, -89.0, -103.9,
                    -104.0, -110.0, -1e30, 1.0, 88.7, 88.8, 100.0])])
    # the -dt·rate and -dt/mean arguments of the scenarios below
    dts = np.float32([0.05, 0.1, 0.5])
    vals = np.float32([20.0, 5.0, 3.0, 1.0, 2.0, 15.0, 30.0, 1e-9, 1e-4,
                       0.01, 0.05, 0.02, 0.1, 0.2, 0.3, 1e9,
                       math.log(2.0) / 0.1, 0.0016, 0.0008, 1250.0])
    args = np.concatenate([(-dts[:, None] * vals).ravel(),
                           (-dts[:, None] / vals).ravel()])
    xs = np.concatenate([xs, args.astype(np.float32)])
    want = np.asarray(jax.jit(jnp.exp)(xs))
    got = trnd.exp(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tick_probabilities_match_the_reference():
    params = SimParams(dt=0.05, faults="chaos", host_mtbf_s=20.0,
                       host_mttr_s=5.0, inst_kill_rate=0.01,
                       zone_slow_rate=0.1, zone_partition_rate=0.2,
                       zone_partition_mttr_s=1.0, host_slow_mtbf_s=5.0,
                       host_slow_mttr_s=float("inf"), nic_degrade_rate=1e9)
    p = tfaults.tick_probabilities(TDyn(*[
        torch.from_numpy(np.atleast_1d(v))
        for v in TDyn.from_params(params)]))
    jdyn = JDyn.from_params(jcore.SimParams(**dataclasses.asdict(params)))
    for f, kind in tfaults._RATES:
        fn = jfaults._p_rate if kind == "rate" else jfaults._p_mean_time
        want = np.asarray(jax.jit(fn)(getattr(jdyn, f), jdyn.dt))
        np.testing.assert_array_equal(p[f].numpy().reshape(()).view(
            np.uint32), want.view(np.uint32), err_msg=f)


@pytest.mark.parametrize("seed", (0, 3))
def test_table_key_through_a_fold(seed):
    with jax.threefry_partitionable(False):
        root = jax.random.PRNGKey(seed)
        want = jax.random.split(jax.random.fold_in(
            jax.random.split(root, 8)[-3], 1), 5)
    roots, _ = trnd.chain(trnd.PRNGKey(seed), 1, ((8, 0),))
    table = trnd.KeyTable(1, "cpu")
    table.fill(roots)
    faults_key = trnd.split(table.root(), 8)[-3]
    keys = trnd.split(trnd.fold_in(faults_key, 1), 5)
    for i, k in enumerate(keys):
        got = [int(w) for w in table.words(k.path)]
        np.testing.assert_array_equal(got, np.asarray(want[i], np.int64))
    # the host derivation agrees
    host = trnd.split(trnd.fold_in(trnd.split(trnd.PRNGKey(seed), 8)[5],
                                   1), 5)
    np.testing.assert_array_equal(host.numpy(),
                                  np.asarray(want, np.int64))


# ---------------------------------------------------------------------------
# the golden matrix's chaos combos
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("network", ("uniform", "fabric"))
def test_golden_chaos_matches_reference_and_pins(network):
    jsim = matrix_sim(network, "chaos")
    tsim = _twin(jsim, diamond(mi=400.0), CHAOS_TMPL,
                 vm_mips=np.full(4, 64000.0, np.float32))
    tres = _run_both(jsim, tsim, f"golden-{network}")
    st = tres.state
    pin = MATRIX_GOLDEN[(network, "chaos")]
    assert _digest_f32(st.requests.response.numpy()) == pin["resp"]
    for k in ("completed", "spawned", "finished"):
        assert int(getattr(st.counters, k)) == pin[k], k
    assert int(st.net.transits) == pin["transits"]
    assert int(st.fstats.failed_attempts) == pin["failed_attempts"]
    assert int(st.fstats.retries) == pin["retries"]
    _conservation(st)


# ---------------------------------------------------------------------------
# the Disruption phase alone, on the reference tests' hand-built states
# ---------------------------------------------------------------------------

def test_mass_kill_recycles_slots_in_one_tick():
    C = 64
    out = _disrupt_both(*jtf._crafted(C=C, retry_budget=2))
    assert (out.cloudlets.status.numpy() == CL_WAITING).all()
    assert (out.cloudlets.col("attempt").numpy() == 1).all()
    assert int(out.fstats.failed_attempts) == C == int(out.fstats.retries)
    assert int(out.counters.spawned) == C
    assert int(out.counters.dropped_cloudlets) == 0
    assert int(out.instances.status[0]) == INST_DOWN
    assert int(out.instances.n_exec[0]) == 0
    assert (out.requests.outstanding.numpy()[:C] == 1).all()
    assert int(out.requests.failed.sum()) == 0
    assert int(out.fstats.host_crashes) == 2


def test_budget_exhausted_wave_fails_requests_exactly_once():
    C = 32
    out = _disrupt_both(*jtf._crafted(C=C, retry_budget=0))
    assert (out.cloudlets.status.numpy() == CL_FREE).all()
    assert int(out.fstats.retries) == 0
    assert int(out.fstats.failed_attempts) == C
    assert (out.requests.outstanding.numpy()[:C] == 0).all()
    assert (out.requests.failed.numpy()[:C] == 1).all()
    assert (out.requests.finish.numpy()[:C] >= 1.0 - 1e-6).all()


def test_zone_fault_downs_the_whole_zone_atomically():
    args = jtf._zone_state([0, 0, 1, 1],
                           zone_fault_rate=math.log(2.0) / 0.1)
    out = _disrupt_both(*args, key=0)
    np.testing.assert_array_equal(out.fault.host_up.numpy(), [0, 0, 1, 1])
    assert int(out.fstats.zone_faults) == 1
    assert int(out.fstats.host_crashes) == 2


def test_partition_cuts_zone_pair_then_heals():
    state, app, caps, params, dyn = jtf._zone_state(
        [0, 0, 1, 1], zone_partition_rate=1e9,
        zone_partition_mttr_s=float("inf"))
    out = _disrupt_both(state, app, caps, params, dyn, key=3)
    zc = out.fault.zone_cut.numpy()
    assert zc[0, 1] == 1 and zc[1, 0] == 1
    assert zc.diagonal().sum() == 0 and zc.sum() == 2
    assert int(out.fstats.partitions) == 1
    heal = dataclasses.replace(params, zone_partition_rate=0.0,
                               zone_partition_mttr_s=1e-9)
    with jax_reference():
        k1, k2 = jax.random.split(jax.random.PRNGKey(3))
        jcut = jax.jit(lambda st, a, d, x, y: jfaults.disruption(
            st, a, caps, params, d, x, y, None))(state, app, dyn, k1, k2)
    out2 = _disrupt_both(jcut, app, caps, heal, JDyn.from_params(heal),
                         key=3)
    assert out2.fault.zone_cut.numpy().sum() == 0


def _transit_state():
    """``test_faults.test_partition_stalls_cross_zone_transfer_…``'s state:
    one transfer from host 0 (zone 0) to an instance on host 2 (zone 1)."""
    from repro.core.types import CL_TRANSIT, zeros_state
    app = jcore.build_app(jcore.linear_chain(1, mi=100.0),
                          host_zone=[0, 0, 1, 1])
    caps = jcore.SimCaps(n_clients=4, max_requests=8, max_cloudlets=8,
                         max_instances=4, n_vms=4, d_max=1, max_replicas=1)
    params = jcore.SimParams(dt=0.1, n_ticks=1, network="fabric",
                             faults="chaos")
    state = zeros_state(caps, params, jax.random.PRNGKey(0), app=app)
    inst = state.instances._replace(
        status=state.instances.status.at[0].set(INST_ON),
        service=state.instances.service.at[0].set(0),
        vm=state.instances.vm.at[0].set(2),
        host=state.instances.host.at[0].set(2),
        mips=state.instances.mips.at[0].set(1000.0))
    first = jnp.arange(caps.max_cloudlets) == 0
    cl = state.cloudlets.with_cols(
        status=jnp.where(first, CL_TRANSIT, CL_FREE),
        inst=jnp.where(first, 0, -1), req=jnp.where(first, 0, -1),
        service=0, depth=0, attempt=0, edge=0, src_inst=-1,
        src_host=jnp.where(first, 0, -1), length=100.0, rem=100.0,
        arrival=0.0, start=-1.0, rem_bytes=jnp.where(first, 1.0, 0.0))
    cut = state.fault.zone_cut.at[0, 1].set(1).at[1, 0].set(1)
    return state._replace(instances=inst, cloudlets=cl,
                          fault=state.fault._replace(zone_cut=cut)), \
        app, caps, params


def test_partition_stalls_cross_zone_transfer_without_crashing():
    from repro_torch.core.types import CL_TRANSIT
    state, app, caps, params = _transit_state()
    dyn = JDyn.from_params(params)
    tcaps, tparams = _port_caps_params(caps, params)
    tdyn = TDyn.from_params(tparams)
    for cut in (True, False):
        st = state if cut else state._replace(fault=state.fault._replace(
            zone_cut=jnp.zeros_like(state.fault.zone_cut)))
        with jax_reference():
            jout = jax.jit(lambda s, d, a: jnet.transit(s, caps, params, d,
                                                        a))(st, dyn, app)
        tout = tnet.transit(_port_state(st, params), tcaps, tparams, tdyn,
                            torch_app(app))
        assert_trees_match(convert.state_to_numpy(tout), jax_tree_np(jout),
                           where=f"transit-cut={cut}.")
        status = int(tout.cloudlets.status[0])
        left = float(tout.cloudlets.rem_bytes[0])
        if cut:
            assert status == CL_TRANSIT and left == 1.0
        else:
            assert status == CL_WAITING and left == 0.0


def test_fail_slow_host_degrades_only_execution_rate():
    from repro.core.types import zeros_state
    app = jcore.build_app(jcore.linear_chain(1, mi=100.0), n_hosts=2)
    caps = jcore.SimCaps(n_clients=4, max_requests=8, max_cloudlets=8,
                         max_instances=4, n_vms=2, d_max=1, max_replicas=1)
    params = jcore.SimParams(dt=0.1, n_ticks=1, faults="chaos",
                             host_slow_factor=0.25)
    dyn = JDyn.from_params(params)
    state = zeros_state(caps, params, jax.random.PRNGKey(0), app=app)
    inst = state.instances._replace(
        status=state.instances.status.at[0].set(INST_ON),
        service=state.instances.service.at[0].set(0),
        vm=state.instances.vm.at[0].set(0),
        host=state.instances.host.at[0].set(0),
        mips=state.instances.mips.at[0].set(1000.0),
        n_exec=state.instances.n_exec.at[0].set(1))
    first = jnp.arange(caps.max_cloudlets) == 0
    cl = state.cloudlets.with_cols(
        status=jnp.where(first, CL_EXEC, CL_FREE),
        inst=jnp.where(first, 0, -1), req=jnp.where(first, 0, -1),
        service=0, depth=0, attempt=0, edge=0, src_inst=-1, src_host=-1,
        length=1000.0, rem=1000.0, arrival=0.0, start=0.0, rem_bytes=0.0)
    healthy = state._replace(instances=inst, cloudlets=cl)
    slowed = healthy._replace(fault=healthy.fault._replace(
        host_slow=healthy.fault.host_slow.at[0].set(1)))
    tcaps, tparams = _port_caps_params(caps, params)
    rems = []
    for st in (healthy, slowed):
        with jax_reference():
            jout, _ = jax.jit(lambda s, a, d: jsched.execute(
                s, a, caps, params, d))(st, app, dyn)
        tout, _ = tsched.execute(_port_state(st, params), torch_app(app),
                                 tcaps, tparams, TDyn.from_params(tparams))
        assert_trees_match(convert.state_to_numpy(tout), jax_tree_np(jout),
                           where="execute.")
        rems.append(float(tout.cloudlets.rem[0]))
    assert rems == [900.0, 975.0]


def test_outlier_ejection_and_readmission_round_trip():
    state, app, caps, params, dyn = jtf._eject_state()
    out = _disrupt_both(state, app, caps, params, dyn)
    t = float(out.time)
    ej = out.fault.inst_eject_until.numpy()
    assert ej[0] > t and ej[1] == 0.0
    assert int(out.fstats.ejections) == 1
    assert int(out.instances.status[0]) == INST_ON
    iof, n_ok = policies.eject_view(lift(out.sched),
                                    lift(out.fault.inst_eject_until),
                                    lift(out.time))
    assert iof[0, 0, :2].tolist() == [1, -1] and int(n_ok[0, 0]) == 1
    # the reference's view agrees
    with jax_reference():
        jout = jax.jit(lambda st, a, d, x, y: jfaults.disruption(
            st, a, caps, params, d, x, y, None))(
            state, app, dyn, *jax.random.split(jax.random.PRNGKey(7)))
        jiof, jn = jpol.eject_view(jout.sched, jout.fault.inst_eject_until,
                                   jout.time)
    np.testing.assert_array_equal(iof[0].numpy(), np.asarray(jiof))
    np.testing.assert_array_equal(n_ok[0].numpy(), np.asarray(jn))
    # half-open probe after the cooldown: clean traffic re-admits it
    st2 = jout._replace(fault=jout.fault._replace(
        inst_eject_until=jout.fault.inst_eject_until.at[0].set(5.0),
        inst_succ=jout.fault.inst_succ.at[0].set(3)))
    out2 = _disrupt_both(st2, app, caps, params, dyn)
    assert float(out2.fault.inst_eject_until[0]) == 0.0
    assert int(out2.fstats.readmissions) == 1
    assert float(out2.fault.inst_err_ema[0]) == 0.0


def test_ejection_spares_the_last_admissible_replica():
    from repro.core.types import INST_FREE
    state, app, caps, params, dyn = jtf._eject_state()
    state = state._replace(
        instances=state.instances._replace(
            status=state.instances.status.at[1].set(INST_FREE)),
        sched=state.sched._replace(
            inst_of_rank=state.sched.inst_of_rank.at[0, 1].set(-1),
            svc_replicas=state.sched.svc_replicas.at[0].set(1)))
    out = _disrupt_both(state, app, caps, params, dyn)
    assert float(out.fault.inst_eject_until[0]) == 0.0
    assert int(out.fstats.ejections) == 0


def test_eject_view_identity_when_nothing_ejected():
    state, app, caps, params, dyn = jtf._eject_state()
    tst = _port_state(state, params)
    iof, n_ok = policies.eject_view(lift(tst.sched),
                                    lift(tst.fault.inst_eject_until),
                                    lift(tst.time))
    np.testing.assert_array_equal(iof[0].numpy(),
                                  tst.sched.inst_of_rank.numpy())
    np.testing.assert_array_equal(n_ok[0].numpy(),
                                  tst.sched.svc_replicas.numpy())


@pytest.mark.parametrize("statuses", ([INST_ON, INST_ON, INST_DOWN],
                                      [INST_ON, INST_DOWN],
                                      [INST_ON, INST_ON, INST_ON]))
def test_scale_in_skips_down_replicas(statuses):
    _, jstate = jtf._scale_in_state(statuses)
    jout = j_scale_in(jstate, 0)
    params = SimParams(faults="chaos")
    tout = t_scale_in(lift(_port_state(jstate, params)), 0,
                      torch.ones(1, dtype=torch.bool))
    for f in ("instances", "sched", "counters"):
        assert_trees_match(torch_tree_np(getattr(tout, f)),
                           {k: v[None] for k, v in
                            jax_tree_np(getattr(jout, f)).items()},
                           where=f"scale_in.{f}.")
    status = tout.instances.status[0].numpy()
    assert INST_DRAIN not in status[np.asarray(statuses) == INST_DOWN]


def test_chaos_tables_sized_as_the_reference():
    """``zeros_state``'s chaos tables have the reference's widths in both
    fault modes (zero-width with faults off), sized from the app's edge
    tables; a state whose edge tables miss an API's edge is rejected."""
    from repro.core.types import zeros_state as jzeros
    from repro_torch.core import build_app
    from repro_torch.core.types import zeros_state as tzeros
    graph = jtf._two_api_graph()
    tgraph = build_graph(["front", "back"], {"front": ["back"]},
                         [("GET /a", "front", 1.0),
                          ("GET /b", "front", 1.0)],
                         {"front": 300.0, "back": 300.0})
    caps = jcore.SimCaps(n_clients=4, max_requests=64, max_cloudlets=64,
                         max_instances=4, n_vms=3, d_max=1)
    tcaps = SimCaps(**dataclasses.asdict(caps))
    for faults in ("none", "chaos"):
        params = jcore.SimParams(faults=faults)
        tparams = SimParams(faults=faults)
        japp = jcore.build_app(graph, n_hosts=3)
        tapp = build_app(tgraph, n_hosts=3, device="cpu")
        with jax_reference():
            jst = jzeros(caps, params, jax.random.PRNGKey(0), app=japp)
        tst = tzeros(tcaps, tparams, trnd.PRNGKey(0), app=tapp,
                     device="cpu")
        assert_trees_match(convert.state_to_numpy(tst), jax_tree_np(jst),
                           where=f"zeros_state[{faults}].")
    small = tzeros(tcaps, tparams, trnd.PRNGKey(0), n_services=2,
                   device="cpu")
    assert small.fault.edge_open_until.shape[0] == tapp.n_edges - 1
    k = trnd.split(trnd.PRNGKey(1), 2)
    with pytest.raises(ValueError, match="undersized"):
        tfaults.disruption(small, tapp, tcaps, tparams,
                           TDyn.from_params(tparams), k[0], k[1], None)
