"""End-to-end engine invariants on the PyTorch port (CPU): the five
properties of ``tests/test_engine_invariants.py`` and the deterministic
critical-path check of ``tests/test_critical_path.py``, run on
``repro_torch`` at smaller sweep sizes (fewer hypothesis examples and
ticks) so the file stays quick.
"""
import numpy as np
import pytest
import torch

from _hyp import given, settings, st  # skips gracefully without hypothesis

from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,
                              Simulation, critical_path, diamond,
                              linear_chain, node_delays, star, summarize)

# the port's tensors here are small: one intra-op thread per test
# process beats oversubscribing the cores across test workers
torch.set_num_threads(1)


def _run(graph, caps, params, tmpl=None):
    sim = Simulation(graph, caps=caps, params=params, default_template=tmpl,
                     device="cpu")
    return sim, sim.run()


@given(
    seed=st.integers(min_value=0, max_value=2 ** 16),
    n_clients=st.integers(min_value=1, max_value=24),
    mi=st.floats(min_value=50.0, max_value=2000.0),
    topology=st.sampled_from(["chain", "diamond", "star"]),
)
@settings(max_examples=3, deadline=None)
def test_conservation_laws(seed, n_clients, mi, topology):
    g = {"chain": lambda: linear_chain(3, mi=mi),
         "diamond": lambda: diamond(mi=mi),
         "star": lambda: star(4, mi=mi)}[topology]()
    caps = SimCaps(n_clients=32, max_requests=4096, max_cloudlets=2048,
                   max_instances=16, n_vms=4, d_max=max(g.d_max, 1),
                   max_replicas=2)
    params = SimParams(dt=0.05, n_ticks=200, n_clients=n_clients,
                       spawn_rate=4.0, wait_lo=0.5, wait_hi=2.0, seed=seed)
    sim, res = _run(g, caps, params,
                    InstanceTemplate(mips=8000.0, limit_mips=8000.0))
    s = res.state
    in_flight = int((s.cloudlets.status.numpy() != 0).sum())
    spawned, finished = int(s.counters.spawned), int(s.counters.finished)
    assert spawned == finished + in_flight
    n = int(s.requests.count)
    out = s.requests.outstanding.numpy()[:n]
    assert (out >= 0).all()
    assert out.sum() == in_flight
    resp = s.requests.response.numpy()[:n]
    arr = s.requests.arrival.numpy()[:n]
    fin = s.requests.finish.numpy()[:n]
    done = resp >= 0
    assert (fin[done] >= arr[done] - 1e-5).all()
    assert np.allclose(resp[done], fin[done] - arr[done], atol=1e-4)
    assert int(s.counters.completed) == int(done.sum())


def test_capacity_is_never_oversubscribed():
    """Instance usage ≤ allocation; VM allocations ≤ VM capacity."""
    caps = SimCaps(n_clients=64, max_requests=8192, max_cloudlets=4096,
                   max_instances=32, n_vms=4, d_max=2, max_replicas=4)
    params = SimParams(dt=0.05, n_ticks=400, n_clients=50, spawn_rate=10.0,
                       wait_lo=0.5, wait_hi=1.5, scaling_policy=1,
                       scale_interval=40)
    sim, res = _run(diamond(mi=300.0), caps, params,
                    InstanceTemplate(mips=1000.0, limit_mips=4000.0))
    inst, vms = res.state.instances, res.state.vms
    used, alloc = inst.used_mips.numpy(), inst.mips.numpy()
    assert (used <= alloc * (1 + 1e-4) + 1e-3).all()
    assert (vms.mips_used.numpy() <= vms.mips.numpy() + 1e-3).all()
    assert (vms.ram_used.numpy() <= vms.ram.numpy() + 1e-3).all()
    assert (vms.mips_used.numpy() >= -1e-3).all()
    assert int(res.state.counters.scale_out) > 0


def test_overload_sheds_into_waiting_queue_not_crash():
    caps = SimCaps(n_clients=32, max_requests=2048, max_cloudlets=512,
                   max_instances=8, n_vms=2, d_max=1, max_replicas=1)
    params = SimParams(dt=0.05, n_ticks=300, n_clients=32, spawn_rate=50.0,
                       wait_lo=0.1, wait_hi=0.2)
    sim, res = _run(linear_chain(2, mi=5000.0), caps, params,
                    InstanceTemplate(mips=500.0, limit_mips=500.0))
    s = res.state
    in_flight = int((s.cloudlets.status.numpy() != 0).sum())
    assert int(s.counters.spawned) == int(s.counters.finished) + in_flight
    assert in_flight > 0
    assert summarize(sim, res).cloudlets_dropped >= 0


def test_space_shared_cap_limits_concurrency():
    caps = SimCaps(n_clients=16, max_requests=1024, max_cloudlets=256,
                   max_instances=4, n_vms=2, d_max=1, max_replicas=1)
    params = SimParams(dt=0.05, n_ticks=200, n_clients=16, spawn_rate=100.0,
                       wait_lo=0.1, wait_hi=0.2, max_concurrent=2)
    sim, res = _run(linear_chain(1, mi=2000.0), caps, params,
                    InstanceTemplate(mips=1000.0, limit_mips=1000.0))
    assert int(res.state.instances.n_exec.max()) <= 2
    tr = res.trace_np()
    assert tr["n_exec"].max() <= 2
    assert tr["n_waiting"].max() > 0


def test_deterministic_given_seed():
    caps = SimCaps(n_clients=16, max_requests=512, max_cloudlets=512,
                   max_instances=8, n_vms=2, d_max=2, max_replicas=2)
    params = SimParams(dt=0.05, n_ticks=200, n_clients=10, spawn_rate=5.0,
                       wait_lo=0.5, wait_hi=1.5, seed=123)
    _, r1 = _run(diamond(mi=400.0), caps, params)
    _, r2 = _run(diamond(mi=400.0), caps, params)
    np.testing.assert_array_equal(r1.state.requests.response.numpy(),
                                  r2.state.requests.response.numpy())
    assert int(r1.state.counters.spawned) == int(r2.state.counters.spawned)


def test_engine_response_matches_critical_path_deterministic():
    """One deterministic request: the engine's response equals the Alg 2
    prediction (execution delays + per-hop dispatch latency)."""
    n, mi, mips, dt = 4, 800.0, 1600.0, 0.05
    g = linear_chain(n, mi=mi)
    g.len_std[:] = 0.0
    caps = SimCaps(n_clients=1, max_requests=8, max_cloudlets=64,
                   max_instances=8, n_vms=2, d_max=1, max_replicas=1)
    params = SimParams(dt=dt, n_ticks=400, n_clients=1, spawn_rate=100.0,
                       wait_lo=100.0, wait_hi=101.0, num_limit=1)
    sim, res = _run(g, caps, params,
                    InstanceTemplate(mips=mips, limit_mips=mips))
    resp = res.state.requests.response.numpy()
    resp = resp[resp >= 0]
    assert len(resp) == 1
    exec_time = n * mi / mips
    assert exec_time - 1e-3 <= resp[0] <= exec_time + n * dt + 1e-3
    rt, path = critical_path(g, node_delays(res), 0)
    assert len(path) == n
    assert rt == pytest.approx(float(resp[0]), rel=0.02)
    assert int(res.state.requests.critical_len[0]) == n
