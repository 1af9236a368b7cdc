"""Chaos runs of the port against the JAX reference: the scenarios of
``tests/test_faults.py`` that move instances (HS scale-out off down
hosts) and the edge tables (a two-API graph).  Every state leaf, every
trace and ``summarize``'s report must equal the reference's run
(non-partitionable threefry), floats bit for bit, and each run is held to
the reference test's own assertions and the chaos conservation law."""
from __future__ import annotations

import numpy as np
import torch

import test_faults as jtf
from test_torch_faults import CHAOS_TMPL, _conservation, _run_both, _twin

import repro.core as jcore

from repro_torch.core import build_graph, diamond
from repro_torch.core.types import CL_FREE, INST_ON

torch.set_num_threads(1)


def test_hs_scale_out_respawns_off_down_hosts():
    caps = jcore.SimCaps(n_clients=16, max_requests=1024, max_cloudlets=512,
                         max_instances=16, n_vms=4, d_max=2, max_replicas=4)
    params = jcore.SimParams(
        dt=0.05, n_ticks=600, n_clients=16, spawn_rate=10.0, wait_lo=0.3,
        wait_hi=0.8, seed=5, faults="chaos", host_mtbf_s=40.0,
        host_mttr_s=float("inf"), retry_timeout_s=2.0, scaling_policy=1,
        scale_interval=20, hs_util_hi=0.4, hs_util_lo=0.01)
    tmpl = dict(mips=1000.0, limit_mips=2000.0)
    vm = np.full(4, 64000.0, np.float32)
    jsim = jcore.Simulation(jcore.diamond(mi=400.0), caps=caps,
                            params=params,
                            default_template=jcore.InstanceTemplate(**tmpl),
                            vm_mips=vm)
    tres = _run_both(jsim, _twin(jsim, diamond(mi=400.0), tmpl, vm_mips=vm),
                     "hs_down_hosts")
    st = tres.state
    up = st.fault.host_up.numpy()
    assert up.sum() < len(up) and int(st.counters.scale_out) > 0
    on = st.instances.status.numpy() == INST_ON
    assert on.any() and (up[st.instances.host.numpy()[on]] == 1).all()
    _conservation(st)


def test_two_api_chaos_run_keeps_breaker_edges_distinct():
    caps = jcore.SimCaps(n_clients=16, max_requests=1024, max_cloudlets=512,
                         max_instances=8, n_vms=4, d_max=2, max_replicas=2)
    params = jcore.SimParams(dt=0.05, n_ticks=500, n_clients=12,
                             spawn_rate=5.0, wait_lo=0.5, wait_hi=1.5,
                             seed=3, faults="chaos", host_mtbf_s=20.0,
                             host_mttr_s=5.0, retry_timeout_s=3.0,
                             retry_budget=2)
    vm = np.full(4, 64000.0, np.float32)
    jsim = jcore.Simulation(jtf._two_api_graph(), caps=caps, params=params,
                            default_template=jcore.InstanceTemplate(
                                **CHAOS_TMPL), vm_mips=vm)
    graph = build_graph(["front", "back"], {"front": ["back"]},
                        [("GET /a", "front", 1.0), ("GET /b", "front", 1.0)],
                        {"front": 300.0, "back": 300.0})
    tsim = _twin(jsim, graph, CHAOS_TMPL, vm_mips=vm)
    assert tsim.app.n_edges == tsim.graph.n_services * tsim.graph.d_max + 2
    tres = _run_both(jsim, tsim, "two_api")
    st = tres.state
    E = st.fault.edge_open_until.shape[0]
    assert E == tsim.app.n_edges
    active = st.cloudlets.status.numpy() != CL_FREE
    edges = st.cloudlets.col("edge").numpy()
    assert (edges[active] >= 0).all() and (edges[active] < E).all()
    _conservation(st)
    api = st.requests.api.numpy()[:int(st.requests.count)]
    assert set(np.unique(api)) == {0, 1}
