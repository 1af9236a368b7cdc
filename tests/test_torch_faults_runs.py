"""Chaos runs of the port against the JAX reference: the engine-level
scenarios of ``tests/test_faults.py`` that exercise failures, retries and
the circuit breaker (the conservation-and-availability run, the breaker
trip, the per-edge timeout).  Every state leaf, every trace and
``summarize``'s report must equal the reference's run (non-partitionable
threefry), floats bit for bit, and each run is held to the reference
test's own assertions and the chaos conservation law
(``test_torch_faults.py`` holds the helpers; the cases are split over
files to keep each one's CPU time short)."""
from __future__ import annotations

import pytest
import torch

import test_faults as jtf
from test_torch_faults import _chaos_twin, _conservation, _run_both, _twin

import repro.core as jcore

from repro_torch.core import build_graph, linear_chain, summarize

torch.set_num_threads(1)


def test_chaos_conservation_and_availability():
    jsim, _ = jtf._chaos_sim()
    tsim = _chaos_twin(jsim)
    tres = _run_both(jsim, tsim, "chaos_sim")
    rep = summarize(tsim, tres)
    assert rep.host_crashes > 0 and rep.retries > 0
    assert rep.failed_requests > 0
    assert 0.0 <= rep.availability < 1.0
    assert rep.error_rate > 0.0 and rep.retry_amplification > 1.0
    assert rep.observed_mttr_s > 0.0
    _conservation(tres.state)


def test_breaker_trips_open_and_fails_fast():
    caps = jcore.SimCaps(n_clients=8, max_requests=512, max_cloudlets=256,
                         max_instances=4, n_vms=2, d_max=1, max_replicas=1)
    base = dict(dt=0.05, n_ticks=400, n_clients=8, spawn_rate=20.0,
                wait_lo=0.3, wait_hi=0.8, seed=0, faults="chaos",
                host_mtbf_s=1e-4, host_mttr_s=float("inf"),
                retry_timeout_s=0.5, retry_budget=1, cb_cooldown_s=2.0)
    reps = {}
    for name, thresh in (("on", 0.3), ("off", 2.0)):
        jsim = jcore.Simulation(jcore.linear_chain(1, mi=200.0), caps=caps,
                                params=jcore.SimParams(cb_err_thresh=thresh,
                                                       **base))
        tsim = _twin(jsim, linear_chain(1, mi=200.0))
        tres = _run_both(jsim, tsim, f"breaker-{name}")
        reps[name] = rep = summarize(tsim, tres)
        assert rep.availability == 0.0 and rep.failed_requests > 0
        _conservation(tres.state)
    assert reps["on"].breaker_trips > 0 and reps["on"].failfast_failures > 0
    assert reps["off"].breaker_trips == 0
    assert reps["off"].failfast_failures == 0
    assert reps["off"].retries > reps["on"].retries


@pytest.mark.parametrize("timeouts", (None, {"api": 0.2}))
def test_per_edge_timeout_overrides_run_wide_default(timeouts):
    jsim = jtf._slow_service_sim(api_timeouts=timeouts)
    graph = build_graph(["s0"], {}, [("api", "s0", 1.0)], {"s0": 500.0},
                        len_std={"s0": 0.0}, api_timeouts=timeouts)
    tsim = _twin(jsim, graph, dict(mips=1000.0, limit_mips=1000.0))
    rep = summarize(tsim, _run_both(jsim, tsim, f"timeout-{timeouts}"))
    if timeouts is None:
        assert rep.failed_requests == 0 and rep.availability == 1.0
    else:
        assert rep.failed_requests > 0 and rep.availability < 1.0
