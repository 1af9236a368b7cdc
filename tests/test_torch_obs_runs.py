"""Whole runs of the port with telemetry and burn-rate alerting on,
against the JAX reference (non-partitionable threefry), on the golden
scenario of ``tests/test_layouts.py``: the uniform network without chaos
here, the other three combos in ``test_torch_obs_chaos.py``,
``test_torch_obs_fabric.py`` and ``test_torch_obs_fabric_chaos.py`` (one
combo a file keeps each file's CPU time short; the helpers here serve
them all).

Each run must equal the reference's in every leaf of the final state
(the telemetry ring, span ring, alert state and event ring included),
every trace and ``summarize``'s report; the metric rows it streams (the
flushes between ticks and the end-of-run drain, collected with
``export.collecting``) and its alert rows (``export.alert_collecting``)
must be the reference's, compared sorted by tag and window.  Telemetry
and alerting observe only: with ``hs_mode="util"`` and
``slo_eject_tighten=1`` every simulation leaf and trace equals the same
run with both off.  Tolerance zero throughout.
"""
from __future__ import annotations

import numpy as np
import torch

from test_layouts import matrix_sim
from test_torch_faults import _assert_runs_equal
from test_torch_phases import assert_trees_match, torch_tree_np
from test_torch_phases import jax_reference
from test_torch_sim import _port_matrix_sim

from repro.obs import export as jexport

from repro_torch.core import convert
from repro_torch.obs import export

torch.set_num_threads(1)

TEL_KW = dict(telemetry="stream", tel_window_ticks=16, tel_windows=8,
              tel_span_k=4, tel_span_cap=256)
# every completion misses slo_ms=1.0: alerts fire, resolve and append
# events (tests/test_slo.py's HOT_KW)
HOT_KW = dict(TEL_KW, alerting="burn", slo_budget=0.05, slo_ms=1.0,
              slo_short_wins=2, slo_long_wins=4, slo_for_ticks=2)
OBS_LEAVES = ("telemetry", "alerts")


def rows_sorted(rows) -> np.ndarray:
    """Metric rows as a float32 array sorted by (tag, window)."""
    c = export.RowCollector()
    for r in rows:
        c(r)
    a = c.rows_np()
    return a[np.lexsort((a[:, 0], a[:, 2]))]


def alerts_sorted(rows) -> list:
    return sorted(rows, key=lambda r: (r["tag"], r["time_s"], r["service"],
                                       r["rule"]))


def run_both(jsim, tsim, where, batch=None, tbatch=None):
    """The reference's and the port's run (``run_batch`` over the given
    points), every leaf, trace and report equal; returns (port result,
    port metric rows, port alert rows), the rows equal to the
    reference's."""
    with jax_reference():
        with jexport.collecting() as jr, jexport.alert_collecting() as ja:
            jres = jsim.run() if batch is None else jsim.run_batch(batch)
    with export.collecting() as tr, export.alert_collecting() as ta:
        tres = tsim.run() if tbatch is None else tsim.run_batch(tbatch)
    if batch is None:
        _assert_runs_equal(tres, jres, where, tsim, jsim)
    else:
        _assert_runs_equal(tres, jres, where)
    np.testing.assert_array_equal(rows_sorted(tr.rows).view(np.uint32),
                                  rows_sorted(jr.rows).view(np.uint32),
                                  err_msg=f"{where}: streamed rows")
    assert alerts_sorted(ta.rows) == alerts_sorted(ja.rows), where
    return tres, tr.rows, ta.rows


def sim_leaves(state) -> dict:
    d = convert.state_to_numpy(state)
    return {k: v for k, v in d.items() if k not in OBS_LEAVES}


def assert_observes_only(res, off, where):
    """Every simulation leaf and trace of ``res`` equals ``off``'s."""
    assert_trees_match(sim_leaves(res.state), sim_leaves(off.state),
                       where=f"{where}: telemetry on vs off: ")
    assert_trees_match(torch_tree_np(res.trace), torch_tree_np(off.trace),
                       where=f"{where}: telemetry on vs off: trace.")


def without_obs(kw: dict) -> dict:
    """``kw`` with telemetry and alerting off (the other knobs kept)."""
    return {k: v for k, v in kw.items()
            if not k.startswith("tel_") and k not in ("telemetry",
                                                      "alerting")}


def check_combo(network, faults):
    n_windows = 300 // 16
    for name, kw in (("telemetry", TEL_KW), ("alerting", HOT_KW)):
        where = f"{network}/{faults}/{name}"
        jsim = matrix_sim(network, faults, **kw)
        tres, rows, alerts = run_both(jsim, _port_matrix_sim(jsim), where)
        off = _port_matrix_sim(matrix_sim(network, faults,
                                          **without_obs(kw))).run()
        assert_observes_only(tres, off, where)
        assert len(rows) == n_windows
        export.validate_rows(rows)
        assert [int(r["window"]) for r in rows] == list(range(n_windows))
        if name == "alerting":
            export.validate_alert_rows(alerts)
            assert int(tres.state.alerts.fires.sum()) > 0
            assert sum(r["state"] == "firing" for r in alerts) == \
                int(tres.state.alerts.fires.sum())


def test_uniform_runs_match_reference():
    check_combo("uniform", "none")


def test_unaligned_run_delivers_every_window_once():
    """100 ticks in 8-tick windows and 16-tick flushes: six flushes
    deliver windows 0-11 between ticks and the drain none; 110 ticks:
    the drain delivers window 12 after six flushes.  Each row once, as
    the reference's."""
    for n_ticks, n_windows in ((100, 12), (110, 13)):
        kw = dict(TEL_KW, n_ticks=n_ticks, tel_window_ticks=8,
                  tel_windows=4, tel_span_cap=128)
        jsim = matrix_sim("uniform", "none", **kw)
        _, rows, _ = run_both(jsim, _port_matrix_sim(jsim),
                              f"{n_ticks} ticks")
        assert sorted(int(r["window"]) for r in rows) == \
            list(range(n_windows))


def test_run_state_in_pieces_flushes_on_the_absolute_cadence():
    """``run_state`` flushes after the ticks that end a flush interval
    counted from tick 0 (``first_tick``), so a run cut in pieces and a
    final drain deliver the same rows as one run."""
    from repro_torch.obs import telemetry
    jsim = matrix_sim("uniform", "none", n_ticks=100, **dict(
        TEL_KW, tel_window_ticks=8, tel_windows=4))
    tsim = _port_matrix_sim(jsim)
    with export.collecting() as whole:
        tsim.run()
    with export.collecting() as pieces:
        state = tsim.init_state()
        first = 0
        for n in (7, 30, 40, 23):
            state, _ = tsim.run_state(state, n_ticks=n, first_tick=first)
            first += n
        tsim.deliver_rows()
        telemetry.drain_to_exporter(state, tsim.params)
    np.testing.assert_array_equal(rows_sorted(pieces.rows),
                                  rows_sorted(whole.rows))
