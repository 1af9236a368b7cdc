"""``Simulation.run_batch`` of the port against the JAX reference's.

Each scenario is a sweep the reference's own tests run
(``tests/test_fused_tick.py``, ``tests/test_network.py``), plus a sweep
whose points differ in ``scale_interval`` (the reference's per-point
cond, the port's ``"mask"`` tick) and an ``apps=`` sweep of two
re-parameterised applications.  Three runs are held together: the port's
batch must equal the reference's batch in every state leaf and trace,
exactly, and each point must equal the port's own solo ``run``; where the
reference's batch differs from its solo runs the port follows the batch.
The reference runs under the non-partitionable threefry derivation, as
the other parity tests run it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_network import GOLDEN, _digest_f32
from test_torch_phases import (assert_trees_match, jax_reference,
                               jax_tree_np, torch_tree_np)

import repro.core as jcore
from repro.core import engine as jeng

from repro_torch import random as trnd
from repro_torch.core import (AppStatic, InstanceTemplate, SimCaps,
                              SimParams, Simulation, batch_item, convert,
                              diamond, linear_chain, stack_dyn)
from repro_torch.core import engine as teng
from repro_torch.core.types import DynParams

torch.set_num_threads(1)


def _fused_sweep():
    """``test_fused_tick.py::test_run_batch_matches_solo_runs``."""
    kw = dict(graph=("diamond", 400.0),
              caps=dict(n_clients=16, max_requests=512, max_cloudlets=512,
                        max_instances=8, n_vms=2, d_max=2, max_replicas=2),
              params=dict(dt=0.05, n_ticks=200, n_clients=10,
                          spawn_rate=5.0, wait_lo=0.5, wait_hi=1.5,
                          seed=123))
    points = [dict(n_clients=nc, hs_util_hi=th)
              for nc, th in [(4, 0.8), (8, 0.5), (10, 0.8), (16, 0.3)]]
    return kw, points


def _hoisted():
    """``test_fused_tick.py::test_run_batch_hoisted_scaling_matches_solo``:
    HS every 40 ticks, shared by the points."""
    kw = dict(graph=("diamond", 300.0),
              caps=dict(n_clients=32, max_requests=1024, max_cloudlets=512,
                        max_instances=16, n_vms=4, d_max=2, max_replicas=4),
              params=dict(dt=0.05, n_ticks=250, n_clients=20,
                          spawn_rate=10.0, wait_lo=0.5, wait_hi=1.5,
                          scaling_policy=1, scale_interval=40, seed=7),
              template=dict(mips=1000.0, limit_mips=4000.0))
    points = [dict(n_clients=nc, hs_util_hi=th)
              for nc, th in [(8, 0.6), (20, 0.4), (32, 0.2)]]
    return kw, points


def _capped():
    """``test_fused_tick.py::test_run_batch_capped_dispatch_path``."""
    kw = dict(graph=("chain", 2000.0),
              caps=dict(n_clients=16, max_requests=256, max_cloudlets=128,
                        max_instances=4, n_vms=2, d_max=1, max_replicas=1),
              params=dict(dt=0.05, n_ticks=150, n_clients=16,
                          spawn_rate=100.0, wait_lo=0.1, wait_hi=0.2,
                          max_concurrent=2),
              template=dict(mips=1000.0, limit_mips=1000.0))
    return kw, [dict(max_concurrent=m) for m in (1, 2, 3)]


def _uniform_golden():
    """``test_network.py::test_uniform_mode_bit_identical_run_batch``."""
    kw = dict(graph=("diamond", 400.0),
              caps=dict(n_clients=16, max_requests=512, max_cloudlets=512,
                        max_instances=8, n_vms=2, d_max=2, max_replicas=2),
              params=dict(dt=0.05, n_ticks=300, n_clients=12,
                          spawn_rate=5.0, wait_lo=0.5, wait_hi=1.5,
                          scaling_policy=1, scale_interval=40,
                          net_latency_s=0.05, seed=3))
    return kw, [dict(n_clients=nc) for nc in (6, 12, 16)]


def _fabric_nic():
    """``test_network.py::test_fabric_nic_bandwidth_sweepable_via_dynparams``:
    NIC capacity swept on the fabric."""
    kw = dict(graph=("diamond", 400.0),
              caps=dict(n_clients=16, max_requests=512, max_cloudlets=512,
                        max_instances=8, n_vms=2, d_max=2, max_replicas=2),
              params=dict(dt=0.05, n_ticks=300, n_clients=12,
                          spawn_rate=5.0, wait_lo=0.5, wait_hi=1.5, seed=3,
                          network="fabric", nic_egress_mbps=100.0,
                          nic_ingress_mbps=100.0),
              template=dict(mips=8000.0, limit_mips=16000.0),
              vm_mips=64000.0)
    return kw, [dict(nic_egress_mbps=m, nic_ingress_mbps=m)
                for m in (100.0, 4.0)]


def _intervals():
    """HS whose points scale every 15, 25 and 40 ticks (with migration):
    the reference's per-point cond, the port's per-point mask."""
    kw, _ = _hoisted()
    kw = dict(kw, params=dict(kw["params"], n_ticks=160,
                              migration_enabled=True, mig_vm_util_hi=0.3))
    return kw, [dict(scale_interval=si, hs_util_hi=th)
                for si, th in [(15, 0.4), (25, 0.2), (40, 0.3)]]


SCENARIOS = {"fused": _fused_sweep, "hoisted": _hoisted, "capped": _capped,
             "uniform_golden": _uniform_golden, "fabric_nic": _fabric_nic,
             "intervals": _intervals}


def _pair(kw):
    """The reference's Simulation and the port's twin (on the CPU)."""
    kind, mi = kw["graph"]
    tmpl = kw.get("template")
    vm = kw.get("vm_mips")
    out = []
    for pkg in (jcore, None):
        caps = (pkg.SimCaps if pkg else SimCaps)(**kw["caps"])
        params = (pkg.SimParams if pkg else SimParams)(**kw["params"])
        graph = ((pkg.diamond if pkg else diamond)(mi=mi) if kind == "diamond"
                 else (pkg.linear_chain if pkg else linear_chain)(1, mi=mi))
        extra = {}
        if tmpl:
            extra["default_template"] = (
                pkg.InstanceTemplate if pkg else InstanceTemplate)(**tmpl)
        if vm:
            extra["vm_mips"] = np.full(kw["caps"]["n_vms"], vm, np.float32)
        if pkg is None:
            extra["device"] = "cpu"
        out.append((pkg.Simulation if pkg else Simulation)(
            graph, caps=caps, params=params, **extra))
    return out


def _points(params, points):
    return [dataclasses.replace(params, **p) for p in points]


def _assert_batch_equal(tres, jres, where):
    assert_trees_match(convert.state_to_numpy(tres.state),
                       jax_tree_np(jres.state), where=f"{where}.state.")
    assert_trees_match(torch_tree_np(tres.trace), jax_tree_np(jres.trace),
                       where=f"{where}.trace.")


def _assert_solo_equal(item, solo, where):
    assert_trees_match(convert.state_to_numpy(item.state),
                       convert.state_to_numpy(solo.state),
                       where=f"{where}.state.")
    assert_trees_match(torch_tree_np(item.trace), torch_tree_np(solo.trace),
                       where=f"{where}.trace.")


_REF: dict = {}


def _reference(name):
    """The reference's batch and solo runs of a scenario (cached)."""
    if name not in _REF:
        kw, points = SCENARIOS[name]()
        jsim, _ = _pair(kw)
        sweeps = _points(jsim.params, points)
        with jax_reference():
            jres = jsim.run_batch(sweeps)
            solos = []
            for p in sweeps:
                jsim.params = p
                jsim._tick = jeng.make_tick(jsim.caps, p, jsim._has_edges)
                solos.append(jsim.run())
        _REF[name] = (jres, solos)
    return _REF[name]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_batch_matches_reference_batch_and_solo(name):
    kw, points = SCENARIOS[name]()
    jres, jsolos = _reference(name)
    _, tsim = _pair(kw)
    sweeps = _points(tsim.params, points)
    tres = tsim.run_batch(sweeps)
    assert tres.compile_time_s == 0.0       # the CPU runs eagerly
    T = tsim.params.n_ticks
    assert tuple(tres.trace.completed.shape) == (len(points), T)
    assert tuple(tres.state.rng.shape) == (len(points), 2)
    _assert_batch_equal(tres, jres, name)
    base = tsim.params
    for b, p in enumerate(sweeps):
        tsim.params = p
        solo = tsim.run()
        _assert_solo_equal(batch_item(tres, b), solo, f"{name}[{b}]")
        # the reference's own batch against its solo run: equal here
        ref_b = jcore.batch_item(jres, b)
        assert_trees_match(jax_tree_np(ref_b.state),
                           jax_tree_np(jsolos[b].state),
                           where=f"{name}[{b}] reference batch vs solo.")
    tsim.params = base
    if name == "uniform_golden":
        got = tuple(_digest_f32(batch_item(tres, b).state.requests.response)
                    for b in range(len(points)))
        assert got == GOLDEN["batch_resp"]
    if name == "hoisted":
        assert int(tres.state.counters.scale_out.sum()) > 0
    if name == "intervals":
        # the points' own cadences acted: some scaled out
        assert int(tres.state.counters.scale_out.sum()) > 0
    if name == "capped":
        for b, p in enumerate(sweeps):
            assert int(tres.state.instances.n_exec[b].max()) \
                <= p.max_concurrent


def _apps_pair():
    kw, _ = _fused_sweep()
    jsim, tsim = _pair(kw)
    japps, tapps = [], []
    for scale, pay in ((1.0, 1.0), (1.5, 2.0)):
        ja = jsim.app._replace(
            len_mean=jsim.app.len_mean * np.float32(scale),
            tmpl_mips=jsim.app.tmpl_mips * np.float32(pay))
        japps.append(ja)
        tapps.append(convert.app_from_numpy(
            {k: np.asarray(v) for k, v in ja._asdict().items()},
            device="cpu"))
    return jsim, tsim, japps, tapps


def test_run_batch_apps_sweep_matches_reference():
    """Two re-parameterised applications of the same shapes (longer
    cloudlets, bigger instances), one point each."""
    jsim, tsim, japps, tapps = _apps_pair()
    sweeps = [jsim.params, dataclasses.replace(jsim.params, n_clients=16)]
    with jax_reference():
        jres = jsim.run_batch(sweeps, apps=japps)
    tsweeps = _points(tsim.params, [{}, dict(n_clients=16)])
    tres = tsim.run_batch(tsweeps, apps=tapps)
    _assert_batch_equal(tres, jres, "apps")
    # point 1: a solo run of its application from the sweep's shared
    # start state (placed by the Simulation's own app)
    alt = Simulation(tsim.graph, caps=tsim.caps, params=tsweeps[1],
                     device="cpu")
    alt.app = tapps[1]
    st, tr = alt.run_state(tsim.init_state())
    _assert_solo_equal(batch_item(tres, 1),
                       teng.SimResult(st, tr, 0.0, 0.0), "apps[1]")
    a0 = np.asarray(batch_item(tres, 0).state.requests.response)
    a1 = np.asarray(batch_item(tres, 1).state.requests.response)
    assert not np.array_equal(a0, a1)


def test_run_batch_rejections_match_reference():
    base = SimParams(dt=0.05, n_ticks=50, n_clients=8, spawn_rate=5.0)
    sim = Simulation(diamond(mi=300.0), caps=SimCaps(
        n_clients=8, max_requests=128, max_cloudlets=128, max_instances=4,
        n_vms=2, d_max=2, max_replicas=2), params=base, device="cpu")
    with pytest.raises(ValueError, match="structural"):
        sim.run_batch([base, dataclasses.replace(base, scaling_policy=1)])
    with pytest.raises(ValueError, match="structural"):
        sim.run_batch([dataclasses.replace(base, max_concurrent=2)])
    with pytest.raises(ValueError, match="different seed"):
        sim.run_batch([base, dataclasses.replace(base, seed=5)])
    with pytest.raises(ValueError, match="one AppStatic per sweep point"):
        sim.run_batch([base, base], apps=[sim.app])
    small = sim.app._replace(len_mean=sim.app.len_mean[:2])
    with pytest.raises(ValueError, match="different array shapes"):
        sim.run_batch([base, base], apps=[sim.app, small])


def test_stack_dyn_and_batch_item():
    ps = [SimParams(dt=0.05, n_clients=n, hs_util_hi=0.1 * n, seed=1)
          for n in (3, 7)]
    d = stack_dyn(DynParams.from_params(p) for p in ps)
    jd = jcore.stack_dyn(jcore.types.DynParams.from_params(
        jcore.SimParams(**dataclasses.asdict(p))) for p in ps)
    for f in DynParams._fields:
        got, want = getattr(d, f).numpy(), np.asarray(getattr(jd, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    sim = Simulation(diamond(mi=300.0), caps=SimCaps(
        n_clients=8, max_requests=128, max_cloudlets=128, max_instances=4,
        n_vms=2, d_max=2, max_replicas=2), params=dataclasses.replace(
            ps[0], n_ticks=20), device="cpu")
    res = sim.run_batch(d)
    for b in range(2):
        one = batch_item(res, b)
        assert one.state.tick.dim() == 0 and int(one.state.tick) == 20
        assert tuple(one.state.rng.shape) == (2,)
        assert tuple(one.trace.completed.shape) == (20,)
        assert torch.equal(one.state.requests.response,
                           res.state.requests.response[b])
        assert one.wall_time_s == res.wall_time_s


def test_batched_tick_draws_once_as_the_solo_tick():
    """A batched tick takes each draw once, at the solo tick's shape, and
    draws the solo tick's bits (every point shares the seed)."""
    kw, points = _hoisted()
    _, tsim = _pair(kw)
    state = tsim.init_state()
    roots, _ = trnd.chain(state.rng, 3, teng.carry_path(tsim.params))
    calls = {}
    real = trnd.random_bits

    def record(tag):
        def bits(key, shape, device=None):
            out = real(key, shape, device)
            calls[tag].append((tuple(shape), out.clone()))
            return out
        return bits

    dyn = stack_dyn(DynParams.from_params(p)
                    for p in _points(tsim.params, points))
    for tag, d in (("solo", DynParams.from_params(tsim.params)),
                   ("batch", dyn)):
        calls[tag] = []
        loop = teng.TickLoop(tsim._tick, d, tsim.app, state, 3)
        loop.keys.fill(roots)
        loop.step(False)
        loop.step(True)
        trnd.random_bits = record(tag)
        try:
            loop.step(False)
        finally:
            trnd.random_bits = real
    assert loop.B == len(points)
    assert [s for s, _ in calls["batch"]] == [s for s, _ in calls["solo"]]
    assert calls["solo"]
    for (_, a), (_, b) in zip(calls["batch"], calls["solo"]):
        assert torch.equal(a, b)


def test_batch_of_one_is_the_solo_run():
    """``run_batch`` of one point equals ``run``, and a batched state
    continues in windows as one run does."""
    kw, points = _hoisted()
    _, tsim = _pair(kw)
    tsim.params = dataclasses.replace(tsim.params, n_ticks=90)
    solo = tsim.run()
    one = tsim.run_batch([tsim.params])
    _assert_solo_equal(batch_item(one, 0), solo, "batch of one")
    sweeps = _points(tsim.params, points)
    whole = tsim.run_batch(sweeps)
    state, traces, t0 = tsim.init_state(), [], 0
    for w in (35, 55):
        state, tr = tsim.run_batch_state(state, sweeps, w, first_tick=t0)
        traces.append(tr)
        t0 += w
    for b in range(len(sweeps)):
        got = teng.SimResult(
            state=batch_item(teng.SimResult(state, tr, 0.0, 0.0), b).state,
            trace=type(tr)(*[torch.cat([t[k][b] for t in traces])
                             for k in range(len(tr))]),
            wall_time_s=0.0, compile_time_s=0.0)
        _assert_solo_equal(got, batch_item(whole, b), f"windows[{b}]")


def test_app_static_sizes_read_trailing_axes():
    sim = Simulation(diamond(mi=300.0), caps=SimCaps(
        n_clients=8, max_requests=128, max_cloudlets=128, max_instances=4,
        n_vms=2, d_max=2, max_replicas=2), device="cpu")
    stacked = AppStatic(*[torch.stack([t, t]) for t in sim.app])
    for f in ("n_services", "n_apis", "n_edges", "n_hosts"):
        assert getattr(stacked, f) == getattr(sim.app, f), f
