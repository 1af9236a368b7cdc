"""Chaos sweeps of the port against the JAX reference: ``run_batch``
over fault rates (``tests/test_faults.py``'s three points), held to the
reference's batch and to each point's solo run, and the chaos study's
re-zoned ``run_batch(apps=)`` (``examples/chaos_study.py``, cut to 25 s),
held to the reference's batch and reports.  Every leaf and trace is
compared exactly (non-partitionable threefry on the reference's side)."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import test_faults as jtf
from test_torch_faults import (CHAOS_TMPL, _assert_runs_equal, _chaos_twin,
                               _conservation, _report)
from test_torch_phases import (assert_trees_match, jax_reference,
                               jax_tree_np, torch_tree_np)

import repro.core as jcore
from repro.configs import sockshop as jsockshop
from repro.core import policies as jpol

from repro_torch.configs import sockshop as tsockshop
from repro_torch.core import batch_item, convert, summarize

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# sweeps: run_batch with and without apps=
# ---------------------------------------------------------------------------

def _assert_batch(tres, jres, where):
    assert_trees_match(convert.state_to_numpy(tres.state),
                       jax_tree_np(jres.state), where=f"{where}.state.")
    assert_trees_match(torch_tree_np(tres.trace), jax_tree_np(jres.trace),
                       where=f"{where}.trace.")


def test_fault_rates_sweep_via_run_batch_matches_reference():
    jsim, base = jtf._chaos_sim(n_ticks=300)
    tsim = _chaos_twin(jsim)
    rates = ((60.0, 0.0), (20.0, 0.01), (8.0, 0.05))
    jpts = [dataclasses.replace(base, host_mtbf_s=m, inst_kill_rate=k)
            for m, k in rates]
    tpts = [dataclasses.replace(tsim.params, host_mtbf_s=m,
                                inst_kill_rate=k) for m, k in rates]
    with jax_reference():
        jres = jsim.run_batch(jpts)
    tres = tsim.run_batch(tpts)
    _assert_batch(tres, jres, "fault_sweep")
    fails = []
    for b, p in enumerate(jpts):
        # each point equals the reference's solo run of it
        with jax_reference():
            jsolo = jcore.Simulation(
                jsim.graph, caps=jsim.caps, params=p,
                default_template=jcore.InstanceTemplate(**CHAOS_TMPL),
                vm_mips=np.full(4, 64000.0, np.float32)).run()
        item = batch_item(tres, b)
        _assert_runs_equal(item, jsolo, f"fault_sweep[{b}]")
        _conservation(item.state)
        fails.append(int(item.state.fstats.failed_attempts))
    assert fails[0] < fails[-1]


def _study_zones(radius):
    return (np.arange(10) // radius).astype(np.int32)


def test_chaos_study_apps_sweep_matches_reference():
    """``examples/chaos_study.py``'s re-zoned sweep, cut to 25 s: radius ×
    ejection arm as one ``run_batch(apps=)``."""
    kw = dict(n_clients=100, duration_s=25.0, replicas=2, share=600.0,
              placement_policy=jpol.PLACE_SPREAD, faults="chaos",
              host_mtbf_s=float("inf"), inst_kill_rate=0.0,
              retry_timeout_s=2.5, retry_budget=2, cb_err_thresh=0.5,
              cb_cooldown_s=5.0, cb_alpha=0.3, zone_slow_rate=0.2,
              host_slow_factor=0.1, host_slow_mttr_s=15.0,
              eject_cooldown_s=8.0, host_zone=_study_zones(1))
    labels = ((1, 2.0), (5, 0.35))
    with jax_reference():
        jsim = jsockshop.make_sim(**kw)
        jpts = [dataclasses.replace(jsim.params, eject_err_thresh=e)
                for _, e in labels]
        japps = [jsim.app._replace(host_zone=jnp.asarray(_study_zones(r)))
                 for r, _ in labels]
        jres = jsim.run_batch(jpts, apps=japps)
    tsim = tsockshop.make_sim(device="cpu", **kw)
    tpts = [dataclasses.replace(tsim.params, eject_err_thresh=e)
            for _, e in labels]
    tapps = [tsim.app._replace(host_zone=torch.from_numpy(_study_zones(r)))
             for r, _ in labels]
    tres = tsim.run_batch(tpts, apps=tapps)
    _assert_batch(tres, jres, "chaos_study")
    for b, p in enumerate(tpts):
        item = batch_item(tres, b)
        rep = summarize(tsim, item, params=p)
        jrep = jcore.summarize(jsim, jcore.batch_item(jres, b),
                              params=jpts[b])
        assert _report(rep) == _report(jrep), b
        _conservation(item.state)
    assert int(tres.state.fstats.slow_episodes.sum()) > 0
