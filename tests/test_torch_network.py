"""The port's network fabric (``network="fabric"``) against the JAX
reference.

Per phase: the fabric branches of ``gen_spawn``, ``transit``, ``dispatch``
and ``derive`` (and the unchanged ``execute``/``complete`` between them)
start from the same mid-run reference state of the golden fabric scenario
(``test_layouts.matrix_sim("fabric", "none")``), the reference jitted with
the swept scalars traced as inside its compiled tick.  Every leaf of the
output state must be bit-identical, ``NetStats`` included: the port takes
its float sums in the reference's order (``pool.tree_sum``, the 32-wide
tree of XLA's CPU reductions, and ordered scatters).

The reference's compiled programs contract some multiply-adds and not
others, and which ones depends on the program around them.  Each site of
the fabric is decided here, written the other way each breaks a leaf:
the payload's ``mean + std·noise`` and ``busy + util·dt`` are fused,
``rem - rate·dt`` is not, and the water-fill's port drain ``rem - λ·n``
is fused inside the compiled tick (the program the simulator's results
come from) though the Transit phase jitted on its own rounds it twice.
That site is decided by two ticks of the reference's compiled tick from a
crowded fabric.

Whole runs: the golden fabric scenario leaf for leaf against the live
reference and its pins, an ``egress_shaping`` run, a SockShop fabric run
with spread placement, and the first 60 ticks of two Table 2 cases with
the fabric on (there the ``NetStats`` sums within ``NET_ULPS``).  Then
the port's twins of the reference's semantic fabric tests
(``tests/test_network.py``).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import sockshop as jsock
from repro.core import network as jnet
from repro.core import policies as jpol
from repro.core import scheduler as jsched
from repro.core import generator as jgen
from repro.core.types import DynParams as JDyn
from test_layouts import MATRIX_GOLDEN, matrix_sim
from test_network import _digest_f32
from test_torch_phases import (_flat, assert_trees_match, jax_reference,
                               jax_tree_np, torch_app, torch_tree_np)
from test_torch_sim import _assert_runs_match, _port_matrix_sim

from repro_torch import random as trnd
from repro_torch.configs import sockshop as tsock
from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,
                              Simulation, convert, diamond, linear_chain,
                              policies, summarize)
from repro_torch.core import generator as tgen
from repro_torch.core import network as tnet
from repro_torch.core import scheduler as tsched
from repro_torch.core.engine import FABRIC_KEY_NAMES
from repro_torch.core.types import CL_TRANSIT
from repro_torch.core.types import DynParams as TDyn
from repro_torch.core.types import resolve_layout

torch.set_num_threads(1)

N_KEYS = len(FABRIC_KEY_NAMES)

# NetStats float sums of the Table 2 fabric cases, held within NET_ULPS.
# The bound was 2 when case2a+net's per-host ingress sum differed from the
# reference's compiled tick by one ULP after 60 ticks (two after 200);
# that came from its payload draws (one API: ``random.normal_fma``).  The
# sums now match exactly, and the bound is what the runs show.
NET_ULPS = 0


# ---------------------------------------------------------------------------
# per-phase parity from a mid-run state
# ---------------------------------------------------------------------------

def _mid(**overrides):
    with jax_reference():
        sim = matrix_sim("fabric", "none", n_ticks=150, **overrides)
        st = sim.run().state
        keys = jax.random.split(st.rng, N_KEYS)
    return sim, st, keys


@pytest.fixture(scope="module")
def mid():
    """The golden fabric scenario run 150 ticks by the reference."""
    return _mid()


@pytest.fixture(scope="module")
def mid_shaped():
    """The same with per-instance egress shaping at a starving allowance:
    the shaping clamp binds on the cross-host hops."""
    return _mid(egress_shaping=True, nic_egress_mbps=1000.0,
                nic_ingress_mbps=1000.0)


PHASES = ("gen_spawn", "transit", "dispatch", "execute", "derive",
          "complete")


def _port_state(jst, layout):
    return convert.state_from_numpy(jax_tree_np(jst), layout, device="cpu")


def _run_phase_chain(mid, upto):
    """The reference phases before ``upto`` give its input state; then
    ``upto`` runs on both packages from that same state."""
    sim, jst, keys = mid
    caps, params, app = sim.caps, sim.params, sim.app
    dyn, tdyn = JDyn.from_params(params), TDyn.from_params(params)
    tapp = torch_app(app)
    layout = resolve_layout(params)
    tkeys = trnd.split(_port_state(jst, layout).rng, N_KEYS)
    with jax_reference():
        gen = jax.jit(lambda st, d, a, k: jgen.client_phase(
            st.clients.wait, st.time, st.requests.count, a.api_cdf, d,
            k))(jst, dyn, app, keys[1])
        j = dict(
            gen_spawn=jax.jit(lambda st, d, a, g: jsched.gen_spawn(
                st, a, caps, g.fired, g.api, g.wait_proposal, keys[2], d,
                params=params, net_rng=keys[5])[0]),
            transit=jax.jit(lambda st, d, a: jnet.transit(st, caps, params,
                                                          d, a)),
            dispatch=jax.jit(lambda st, d, a: jsched.dispatch(
                st, a, caps, params, d, keys[3], network=True)),
            execute=jax.jit(lambda st, d, a: jsched.execute(st, a, caps,
                                                            params, d)),
            derive=jax.jit(lambda st, a, i: jsched.derive(
                st, a, caps, i, keys[4], params=params, net_rng=keys[6])),
            complete=jax.jit(lambda st, d: jsched.complete(st, d)[0]))
        st, info = jst, None
        for ph in PHASES:
            src = _port_state(st, layout)
            if ph == "gen_spawn":
                out_j = j[ph](st, dyn, app, gen)
            elif ph == "execute":
                out_j, info = j[ph](st, dyn, app)
            elif ph == "derive":
                out_j = j[ph](st, app, info)
            elif ph == "complete":
                out_j = j[ph](st, dyn)
            else:
                out_j = j[ph](st, dyn, app)
            if ph == upto:
                break
            st = out_j
    if upto == "gen_spawn":
        tg = tgen.client_phase(src.clients.wait, src.time,
                               src.requests.count, tapp.api_cdf, tdyn,
                               tkeys[1])
        out_t, _ = tsched.gen_spawn(src, tapp, caps, tg.fired, tg.api,
                                    tg.wait_proposal, tkeys[2], tdyn,
                                    params=params, net_rng=tkeys[5])
    elif upto == "transit":
        out_t = tnet.transit(src, caps, params, tdyn, tapp)
    elif upto == "dispatch":
        out_t = tsched.dispatch(src, tapp, caps, params, tdyn, tkeys[3],
                                network=True)
    elif upto == "execute":
        out_t, tinfo = tsched.execute(src, tapp, caps, params, tdyn)
        assert_trees_match(torch_tree_np(tinfo), jax_tree_np(info),
                           where="execute.info.")
    elif upto == "derive":
        tinfo = tsched.FinishInfo(*[torch.from_numpy(np.array(x))
                                    for x in info])
        out_t = tsched.derive(src, tapp, caps, tinfo, tkeys[4],
                              params=params, net_rng=tkeys[6])
    else:
        out_t, _ = tsched.complete(src, tdyn)
    return jax_tree_np(st), out_j, out_t


def _changed(before: dict, after: dict, where: str) -> None:
    """The phase did something on this state (a test that changes no
    leaf proves nothing)."""
    b = dict(_flat(before))
    assert any(not np.array_equal(v, b[k]) for k, v in _flat(after)), where


def test_fabric_key_schedule_matches(mid):
    sim, jst, keys = mid
    tkeys = trnd.split(_port_state(jst, resolve_layout(sim.params)).rng,
                       N_KEYS)
    np.testing.assert_array_equal(np.asarray(keys, np.int64),
                                  tkeys.numpy())


@pytest.mark.parametrize("phase", PHASES)
def test_fabric_phase_matches_reference(mid, phase):
    before, out_j, out_t = _run_phase_chain(mid, phase)
    want = jax_tree_np(out_j)
    assert_trees_match(convert.state_to_numpy(out_t), want,
                       where=f"{phase}.")
    _changed(before, want, phase)


@pytest.mark.parametrize("phase", ("gen_spawn", "transit", "derive"))
def test_fabric_phase_with_egress_shaping_matches_reference(mid_shaped,
                                                            phase):
    before, out_j, out_t = _run_phase_chain(mid_shaped, phase)
    want = jax_tree_np(out_j)
    assert_trees_match(convert.state_to_numpy(out_t), want,
                       where=f"shaped.{phase}.")
    _changed(before, want, phase)


def _crowd(mid, n: int, seed: int, max_mb: float = 3.0):
    """The mid state with ``n`` more transfers injected into free slots:
    payloads of up to ``max_mb`` MB on random ports (some client uploads,
    some to a vanished replica), so ports carry many transfers of unequal
    sizes; at 3 MB most do not arrive this tick, at 0.01 MB most do."""
    sim, jst, _ = mid
    L = resolve_layout(sim.params)
    d = jax_tree_np(jst)
    ints, flts = d["cloudlets"]["ints"].copy(), d["cloudlets"]["flts"].copy()
    r = np.random.default_rng(seed)
    free = np.flatnonzero(ints[:, L.i("status")] == 0)[:n]
    on = np.flatnonzero(d["instances"]["status"] == 1)
    H = d["hosts"]["egress_scale"].shape[0]
    k = free.shape[0]
    ints[free, L.i("status")] = CL_TRANSIT
    ints[free, L.i("inst")] = np.where(r.random(k) < 0.05, -1,
                                       r.choice(on, k))
    ints[free, L.i("src_host")] = r.integers(-1, H, k)
    if "src_inst" in L:
        ints[free, L.i("src_inst")] = np.where(r.random(k) < 0.2, -1,
                                               r.choice(on, k))
    inst = ints[free, L.i("inst")]
    S = sim.app.n_services
    ints[free, L.i("service")] = np.where(
        inst >= 0, d["instances"]["service"][np.maximum(inst, 0)],
        r.integers(0, S, k))
    req = r.integers(0, int(d["requests"]["count"]), k)
    ints[free, L.i("req")] = req
    ints[free, L.i("depth")] = 0
    ints[free, L.i("wait_ticks")] = 0
    t = float(d["time"])
    flts[free, L.f("rem_bytes")] = r.uniform(max_mb / 300, max_mb, k)
    flts[free, L.f("arrival")] = t - r.uniform(0.0, 2.0, k)
    flts[free, L.f("length")] = flts[free, L.f("rem")] = \
        r.uniform(100.0, 400.0, k)
    flts[free, L.f("start")] = -1.0
    # the requests own their new hops, as a spawn wave would record it
    jnp_ = jax.numpy
    out, spawned = (d["requests"]["outstanding"].copy(),
                    d["requests"]["spawned"].copy())
    np.add.at(out, req, 1)
    np.add.at(spawned, req, 1)
    jcl = jst.cloudlets.replace(ints=jnp_.asarray(ints),
                                flts=jnp_.asarray(flts))
    return sim, jst._replace(
        cloudlets=jcl,
        requests=jst.requests._replace(outstanding=jnp_.asarray(out),
                                       spawned=jnp_.asarray(spawned)),
        counters=jst.counters._replace(
            spawned=jst.counters.spawned + k))


@pytest.mark.parametrize("shaped,max_mb", [(False, 3.0), (True, 3.0),
                                           (False, 0.01)])
def test_ticks_match_reference_on_a_crowded_fabric(mid, mid_shaped,
                                                   shaped, max_mb):
    """Two ticks of the reference's compiled tick scan (the program its
    runs execute) from a crowded fabric: many transfers of unequal sizes
    per port, so several water-fill rounds, transfers that do not arrive
    (``rem - rate·dt``), per-host sums of many unequal terms and, with
    small payloads, a transit-time sum over many arrivals (their order).
    The compiled tick fuses the water-fill's port drain; the reference's
    Transit phase jitted alone does not, so this, not a per-phase test,
    decides that site."""
    jsim, jst = _crowd(mid_shaped if shaped else mid, 300, 11 + shaped,
                       max_mb)
    with jax_reference():
        tick = jsim._tick
        out_j = jax.jit(lambda st, d, a: jax.lax.scan(
            lambda s, _: tick(s, d, a), st, None, length=2)[0])(
            jst, JDyn.from_params(jsim.params), jsim.app)
    tsim = _port_matrix_sim(jsim)
    out_t, _ = tsim.run_state(_port_state(jst, resolve_layout(jsim.params)),
                              n_ticks=2, first_tick=150)
    want = jax_tree_np(out_j)
    assert_trees_match(convert.state_to_numpy(out_t), want,
                       where="crowded ticks.")
    L = resolve_layout(jsim.params)
    status = want["cloudlets"]["ints"][:, L.i("status")]
    arrived = int(want["net"]["transits"]) - int(jst.net.transits)
    assert int((status == CL_TRANSIT).sum()) > 100 if max_mb > 1 \
        else arrived > 50


def test_transit_moves_bytes_on_this_state(mid):
    """The mid state has transfers on the fabric, several of them on one
    port, and the phase delivers some of them."""
    before, out_j, _ = _run_phase_chain(mid, "transit")
    L = resolve_layout(mid[0].params)
    status = before["cloudlets"]["ints"][:, L.i("status")]
    assert int((status == CL_TRANSIT).sum()) >= 2
    after = jax_tree_np(out_j)
    assert int(after["net"]["transits"]) > int(before["net"]["transits"])
    assert float(after["net"]["bytes_in"].sum()) \
        > float(before["net"]["bytes_in"].sum())


def test_inflight_mb_matches_reference(mid):
    sim, jst = _crowd(mid, 300, 5)
    with jax_reference():
        want = np.asarray(jax.jit(jnet.inflight_mb)(jst.cloudlets))
    got = tnet.inflight_mb(_port_state(jst, resolve_layout(sim.params))
                           .cloudlets)
    assert want > 0
    assert got.numpy().view(np.int32) == want.view(np.int32)


@pytest.mark.parametrize("lb", [jpol.LB_ROUND_ROBIN, jpol.LB_RANDOM,
                                jpol.LB_LEAST_LOADED])
def test_pick_replicas_matches_reference(mid, lb):
    sim, jst, keys = mid
    params = dataclasses.replace(sim.params, lb_policy=lb)
    r = np.random.default_rng(lb)
    K = 64
    svc = r.integers(0, sim.app.n_services, K).astype(np.int32)
    live = r.random(K) < 0.8
    with jax_reference():
        tgt_j, rr_j = jax.jit(lambda st, s, lv, k: jnet.pick_replicas(
            s, lv, st, sim.caps, params, k))(jst, svc, live, keys[5])
    tst = _port_state(jst, resolve_layout(params))
    tgt_t, rr_t = tnet.pick_replicas(torch.from_numpy(svc),
                                     torch.from_numpy(live), tst, sim.caps,
                                     params, trnd.split(tst.rng, N_KEYS)[5])
    np.testing.assert_array_equal(tgt_t.numpy(), np.asarray(tgt_j))
    np.testing.assert_array_equal(rr_t.numpy(), np.asarray(rr_j))
    assert (np.asarray(tgt_j) >= 0).sum() > K // 2


def test_sample_payload_matches_reference(mid):
    _, _, keys = mid
    r = np.random.default_rng(4)
    mean = r.uniform(0.0, 0.5, 4096).astype(np.float32)
    std = r.uniform(0.0, 0.3, 4096).astype(np.float32)
    with jax_reference():
        want = np.asarray(jax.jit(jnet.sample_payload)(mean, std, keys[5]))
    got = tnet.sample_payload(torch.from_numpy(mean), torch.from_numpy(std),
                              torch.from_numpy(np.asarray(keys[5],
                                                          np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert (want == jnet.MIN_PAYLOAD_MB).any()


# ---------------------------------------------------------------------------
# whole runs against the live reference
# ---------------------------------------------------------------------------

def test_fabric_golden_matches_live_reference_and_pins():
    with jax_reference():
        jsim = matrix_sim("fabric", "none")
        jres = jsim.run()
    tres = _port_matrix_sim(jsim).run()
    _assert_runs_match(jres, tres)
    st = tres.state
    pin = MATRIX_GOLDEN[("fabric", "none")]
    assert int(st.counters.completed) == pin["completed"] == 163
    assert int(st.counters.spawned) == pin["spawned"] == 830
    assert int(st.counters.finished) == pin["finished"] == 822
    assert int(st.net.transits) == pin["transits"] == 606
    assert _digest_f32(st.requests.response.numpy()) == pin["resp"]
    assert int(tres.trace.n_transit.sum()) > 0


def test_egress_shaping_run_matches_live_reference():
    kw = dict(n_ticks=200, egress_shaping=True, nic_egress_mbps=1000.0,
              nic_ingress_mbps=1000.0)
    with jax_reference():
        jsim = matrix_sim("fabric", "none", **kw)
        jres = jsim.run()
    tres = _port_matrix_sim(jsim).run()
    _assert_runs_match(jres, tres)
    assert int(tres.state.net.transits) > 0


def test_sockshop_fabric_spread_matches_live_reference():
    """SockShop at 8 Mbit/s NICs with spread placement: cross-host hops,
    loopback hops and saturated ports, the water-fill's several rounds."""
    kw = dict(network="fabric", nic_egress_mbps=8.0, nic_ingress_mbps=8.0,
              spawn_rate=3.0)
    with jax_reference():
        jres = jsock.make_sim(
            30, 15.0, placement_policy=jpol.PLACE_SPREAD, **kw).run()
    tsim = tsock.make_sim(30, 15.0, placement_policy=policies.PLACE_SPREAD,
                          device="cpu", **kw)
    tres = tsim.run()
    _assert_runs_match(jres, tres)
    st = tres.state
    assert int(st.net.transits) > 0 and int(st.counters.completed) > 0
    assert float(st.net.bytes_out.sum()) > 0      # cross-host hops
    rep = summarize(tsim, tres)
    assert rep.avg_ingress_util > 0


# ---------------------------------------------------------------------------
# the port's twins of the reference's semantic fabric tests
# ---------------------------------------------------------------------------

def _fabric_sim(mbps: float, n_ticks: int = 300, seed: int = 3,
                n_clients: int = 12) -> Simulation:
    caps = SimCaps(n_clients=16, max_requests=512, max_cloudlets=512,
                   max_instances=8, n_vms=2, d_max=2, max_replicas=2)
    params = SimParams(dt=0.05, n_ticks=n_ticks, n_clients=n_clients,
                       spawn_rate=5.0, wait_lo=0.5, wait_hi=1.5, seed=seed,
                       network="fabric", nic_egress_mbps=mbps,
                       nic_ingress_mbps=mbps)
    return Simulation(diamond(mi=400.0), caps=caps, params=params,
                      default_template=InstanceTemplate(mips=8000.0,
                                                        limit_mips=16000.0),
                      vm_mips=np.full(2, 64000.0, np.float32), device="cpu")


def test_fabric_transfer_conservation():
    st = _fabric_sim(50.0).run().state
    in_flight = int((st.cloudlets.status == CL_TRANSIT).sum())
    assert int(st.net.hist.sum()) == int(st.net.transits) > 0
    assert float(st.net.bytes_in.sum()) > 0
    assert int(st.counters.completed) > 0
    assert 0 <= in_flight <= st.cloudlets.status.shape[0]
    n_live = int((st.cloudlets.status != 0).sum())
    assert int(st.counters.spawned) == int(st.counters.finished) + n_live


def test_fabric_loopback_beats_cross_host():
    """All instances on one VM: every derived hop is loopback, so no NIC
    egress and no transits beyond the client uploads."""
    caps = SimCaps(n_clients=8, max_requests=256, max_cloudlets=256,
                   max_instances=8, n_vms=1, d_max=2, max_replicas=2)
    params = SimParams(dt=0.05, n_ticks=200, n_clients=6, spawn_rate=5.0,
                       wait_lo=0.5, wait_hi=1.5, seed=0,
                       network="fabric", nic_egress_mbps=100.0,
                       nic_ingress_mbps=100.0)
    sim = Simulation(diamond(mi=200.0), caps=caps, params=params,
                     default_template=InstanceTemplate(mips=8000.0,
                                                       limit_mips=16000.0),
                     vm_mips=np.full(1, 64000.0, np.float32), device="cpu")
    st = sim.run().state
    assert int(st.counters.completed) > 0
    assert float(st.net.bytes_out.sum()) == 0.0
    assert float(st.net.bytes_in.sum()) > 0.0
    assert int(st.net.transits) <= int(st.requests.count) + 1


def test_fabric_low_bandwidth_increases_transit_p95():
    reps = {}
    for mbps in (100.0, 2.0):
        sim = _fabric_sim(mbps)
        reps[mbps] = summarize(sim, sim.run())
    assert reps[2.0].transit_p95_ms > reps[100.0].transit_p95_ms
    assert reps[2.0].avg_ingress_util > reps[100.0].avg_ingress_util


def test_fabric_saturation_p95_monotone_with_load():
    """Low-bandwidth SockShop with spread placement: p95 transit time
    rises with the offered load (solo runs of the reference's batched
    sweep points: one client pool sized for the largest load)."""
    sim = tsock.make_sim(n_clients=96, duration_s=40.0, seed=0,
                         network="fabric", nic_egress_mbps=8.0,
                         nic_ingress_mbps=8.0,
                         placement_policy=policies.PLACE_SPREAD,
                         device="cpu")
    base = sim.params
    p95 = []
    for nc in (8, 32, 96):
        sim.params = dataclasses.replace(base, n_clients=nc,
                                         spawn_rate=nc / 10.0)
        p95.append(summarize(sim, sim.run()).transit_p95_ms)
    assert all(b >= a for a, b in zip(p95, p95[1:])), p95
    assert p95[-1] > p95[0], p95


def test_fabric_round_robin_uses_all_replicas():
    caps = SimCaps(n_clients=8, max_requests=512, max_cloudlets=256,
                   max_instances=8, n_vms=4, d_max=1, max_replicas=2)
    params = SimParams(dt=0.05, n_ticks=300, n_clients=8, spawn_rate=10.0,
                       wait_lo=0.3, wait_hi=0.6, seed=0,
                       network="fabric", nic_egress_mbps=1000.0,
                       nic_ingress_mbps=1000.0)
    sim = Simulation(linear_chain(2, mi=500.0), caps=caps, params=params,
                     default_template=InstanceTemplate(
                         mips=4000.0, limit_mips=8000.0, replicas=2),
                     vm_mips=np.full(4, 64000.0, np.float32),
                     placement_policy=policies.PLACE_SPREAD, device="cpu")
    st = sim.run().state
    busy = st.instances.busy_ticks.numpy()
    svc = st.instances.service.numpy()
    assert int(st.counters.completed) > 10
    for s in (0, 1):
        replicas_busy = busy[svc == s]
        assert len(replicas_busy) == 2
        assert (replicas_busy > 0).all(), (s, busy, svc)


def test_egress_shaping_bw_starved_instance_slows_transit():
    def run_one(shaping: bool, bw: float):
        caps = SimCaps(n_clients=16, max_requests=512, max_cloudlets=512,
                       max_instances=8, n_vms=2, d_max=2, max_replicas=2)
        params = SimParams(dt=0.05, n_ticks=300, n_clients=12,
                           spawn_rate=5.0, wait_lo=0.5, wait_hi=1.5, seed=3,
                           network="fabric", nic_egress_mbps=1000.0,
                           nic_ingress_mbps=1000.0, egress_shaping=shaping)
        sim = Simulation(diamond(mi=400.0), caps=caps, params=params,
                         default_template=InstanceTemplate(
                             mips=8000.0, limit_mips=16000.0, bw=bw),
                         vm_mips=np.full(2, 64000.0, np.float32),
                         placement_policy=policies.PLACE_SPREAD,
                         device="cpu")
        return summarize(sim, sim.run())

    rep_off = run_one(False, 0.5)
    rep_on = run_one(True, 0.5)
    rep_on_fat = run_one(True, 1000.0)
    assert rep_on.net_transits > 0
    assert rep_on.avg_transit_ms > 2.0 * rep_off.avg_transit_ms
    assert abs(rep_on_fat.avg_transit_ms - rep_off.avg_transit_ms) < 1e-3


@pytest.mark.parametrize("tag,scale", [("case1b", 0.0005),
                                       ("case2a", 0.1)])
def test_capacity_net_case_matches_live_reference(tag, scale):
    """``configs/capacity.build_tagged("<case>+net")`` sizes the fabric
    variant as ``benchmarks/bench_capacity.py`` does with
    ``network=True``, and its first 60 ticks are bit-identical to the
    reference's (request count scaled)."""
    from benchmarks import bench_capacity
    from repro_torch.configs import capacity
    n_req, S, reps, _, fanout = capacity.CASES[tag]
    with jax_reference():
        jsim, jmeta = bench_capacity.build_case(
            max(int(n_req * scale), 100), S, reps, fanout, network=True)
        jsim.params = dataclasses.replace(jsim.params, n_ticks=60)
        jres = jsim.run()
    tsim, tmeta = capacity.build_tagged(tag + "+net", scale, device="cpu")
    assert {k: tmeta[k] for k in jmeta} == jmeta
    assert tsim.caps == type(tsim.caps)(**dataclasses.asdict(jsim.caps))
    assert tsim.params.network == "fabric"
    state, _ = tsim.run_state(tsim.init_state(), n_ticks=60)
    got, want = convert.state_to_numpy(state), jax_tree_np(jres.state)
    net_got, net_want = got.pop("net"), want.pop("net")
    assert_trees_match(got, want, where=f"{tag}+net.")
    assert_trees_match(net_got, net_want, float_ulps=NET_ULPS,
                       where=f"{tag}+net.net.")
    assert int(state.net.transits) > 0
    with pytest.raises(ValueError, match="variant"):
        capacity.build_tagged(tag + "+chaos", scale, device="cpu")
