"""Sweeps of the port with telemetry and burn-rate alerting on
(``Simulation.run_batch``) against the JAX reference's ``run_batch``:
every leaf and trace of the batch, the metric rows each point streams
under its own tag (``run_batch`` numbers the points when no tag is set)
and the alert rows; each point against its own solo run; the burn-gated
autoscaler (``hs_mode="slo_burn"``) beside the util one in one sweep
(the alert-driven ejection tightening is in ``test_torch_obs_eject.py``,
``examples/slo_study.py``'s two arms in ``test_torch_obs_study.py``).
Tolerance zero throughout."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import test_slo as jts
from test_layouts import matrix_sim
from test_torch_obs_runs import HOT_KW, rows_sorted, run_both
from test_torch_phases import assert_trees_match, torch_tree_np
from test_torch_sim import _port_matrix_sim

from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,
                              Simulation, batch_item, convert, diamond,
                              summarize)
from repro_torch.obs import export

torch.set_num_threads(1)


def _solo_equal(tsim, res, rows, b, p):
    """Point ``b`` of a port sweep against its solo run with its tag."""
    base = tsim.params
    tsim.params = dataclasses.replace(p, tel_tag=float(b))
    try:
        with export.collecting() as solo_rows:
            solo = tsim.run()
    finally:
        tsim.params = base
    item = batch_item(res, b)
    assert_trees_match(convert.state_to_numpy(item.state),
                       convert.state_to_numpy(solo.state),
                       where=f"point {b} vs solo: ")
    assert_trees_match(torch_tree_np(item.trace), torch_tree_np(solo.trace),
                       where=f"point {b} vs solo: trace.")
    mine = [r for r in rows if r["tag"] == float(b)]
    np.testing.assert_array_equal(rows_sorted(mine),
                                  rows_sorted(solo_rows.rows))
    return item


def test_run_batch_tagged_rows_match_reference_and_solo_runs():
    """Three loads of the golden scenario on the fabric under chaos, 128
    ticks in 8-tick windows (the reference test's sweep), alerting hot."""
    kw = dict(HOT_KW, n_ticks=128, tel_window_ticks=8, tel_windows=4,
              tel_span_k=2, tel_span_cap=512)
    jsim = matrix_sim("fabric", "chaos", **kw)
    tsim = _port_matrix_sim(jsim)
    rates = (3.0, 5.0, 8.0)
    jpts = [dataclasses.replace(jsim.params, spawn_rate=r) for r in rates]
    tpts = [dataclasses.replace(tsim.params, spawn_rate=r) for r in rates]
    res, rows, alerts = run_both(jsim, tsim, "batch", jpts, tpts)
    export.validate_rows(rows)
    export.validate_alert_rows(alerts)
    for b, p in enumerate(tpts):
        item = _solo_equal(tsim, res, rows, b, p)
        rep = summarize(tsim, item, params=p)
        mine = [r for r in rows if int(r["tag"]) == b]
        assert len(mine) == 128 // 8 == rep.tel_windows
        assert int(sum(r["completed"] for r in mine)) == \
            rep.completed_requests
        assert sum(r["state"] == "firing" for r in alerts
                   if int(r["tag"]) == b) == rep.alert_fires > 0


def _burn_pair():
    """``tests/test_slo.py``'s burn-gated autoscaler scenario and the
    port's twin of it."""
    jsim = jts._burn_sim()
    tsim = Simulation(diamond(mi=400.0),
                      caps=SimCaps(**dataclasses.asdict(jsim.caps)),
                      params=SimParams(**dataclasses.asdict(jsim.params)),
                      default_template=InstanceTemplate(
                          mips=8000.0, limit_mips=16000.0, replicas=1),
                      vm_mips=np.full(4, 64000.0, np.float32), device="cpu")
    return jsim, tsim


def test_burn_gate_beside_util_gate_matches_reference():
    """One sweep of the util gate and the burn gate (``hs_mode`` is a
    swept value), and the burn gate without objectives: the burn gate
    scales out on firing alerts, never without objectives."""
    jsim, tsim = _burn_pair()
    arms = (dict(hs_mode="util"), dict(hs_mode="slo_burn"),
            dict(hs_mode="slo_burn", slo_budget=0.0, slo_ms=1000.0))
    jpts = [dataclasses.replace(jsim.params, **a) for a in arms]
    tpts = [dataclasses.replace(tsim.params, **a) for a in arms]
    res, rows, _ = run_both(jsim, tsim, "burn gate", jpts, tpts)
    out = res.state.counters.scale_out
    assert int(out[1]) > 0 and int(out[2]) == 0
    hold = res.state.alerts.hold_until
    assert float(hold[1].max()) > 0 and float(hold[0].max()) == 0.0
    _solo_equal(tsim, res, rows, 1, tpts[1])
