"""The port's telemetry functions (``repro_torch.obs.telemetry``,
``export``, ``spans``, ``profile``) against the JAX reference's, one by
one, on the same inputs.

The inputs are a mid-run state of the golden scenario with every
request sampled (``tel_span_k=1``), on the fabric under chaos (so the
span rows carry ``edge``, ``attempt`` and ``src_host``), taken by the
reference and carried into the port (``core.convert``), with the
``FinishInfo`` of the reference's ``execute`` from it.  The reference runs
each function jitted, under the non-partitionable threefry derivation.
Tolerance zero: every integer and float leaf equal, bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_layouts import matrix_sim
from test_torch_phases import assert_trees_match, jax_reference, jax_tree_np

from repro.core import scheduler as jsched
from repro.core.types import DynParams as JDyn
from repro.core.types import SimParams as JParams
from repro.core.types import TickTrace as JTrace
from repro.core.types import validate_telemetry as jvalidate
from repro.obs import spans as jspans
from repro.obs import telemetry as jtel

from repro_torch.core import SimParams, convert
from repro_torch.core import scheduler as tsched
from repro_torch.core.types import DynParams as TDyn
from repro_torch.core.types import TickTrace as TTrace
from repro_torch.core.types import resolve_layout, validate_telemetry
from repro_torch.obs import export, profile, spans, telemetry

torch.set_num_threads(1)

SPAN_KW = dict(telemetry="stream", tel_window_ticks=16, tel_windows=8,
               tel_span_k=1, tel_span_cap=2048)


@pytest.fixture(scope="module")
def mid():
    """The reference's state after 135 ticks and its ``execute`` from
    there: (reference sim, state after execute, finish info)."""
    with jax_reference():
        jsim = matrix_sim("fabric", "chaos", n_ticks=135, **SPAN_KW)
        jst = jsim.run().state
        dyn = JDyn.from_params(jsim.params)
        st_x, info = jax.jit(lambda st, d, a: jsched.execute(
            st, a, jsim.caps, jsim.params, d))(jst, dyn, jsim.app)
    assert int(np.asarray(info.fin).sum()) > 4
    return jsim, st_x, info


def _port_state(d: dict, params):
    return convert.state_from_numpy(d, resolve_layout(params), device="cpu")


def _port_info(info):
    return tsched.FinishInfo(*[torch.from_numpy(np.array(x)) for x in info])


def _tel(state) -> dict:
    return convert.state_to_numpy(state)["telemetry"]


@pytest.mark.parametrize("tick_cap,room", [(0, None), (3, None), (0, 2),
                                           (5, 1)],
                         ids=["uncapped", "tick_cap", "ring_overflow",
                              "both"])
def test_record_spans_matches_reference(mid, tick_cap, room):
    """The span pass, with and without the per-tick staging budget, and
    with the ring ``room`` rows short of full (overflow counted)."""
    jsim, st_x, info = mid
    params = dataclasses.replace(jsim.params, tel_span_tick_cap=tick_cap)
    d = jax_tree_np(st_x)
    if room is not None:
        SP = d["telemetry"]["span_i"].shape[0]
        d["telemetry"]["span_n"] = np.array([SP - room], np.int32)
    jst = st_x._replace(telemetry=type(st_x.telemetry)(
        **{k: jnp.asarray(v) for k, v in d["telemetry"].items()}))
    with jax_reference():
        want = jax.jit(lambda st, i: jtel.record_spans(st, i, params))(
            jst, info)
    got = telemetry.record_spans(_port_state(d, params), _port_info(info),
                                 SimParams(**dataclasses.asdict(params)))
    assert_trees_match(_tel(got), jax_tree_np(want.telemetry),
                       where="telemetry.")
    tel = jax_tree_np(want.telemetry)
    n_fin = int(np.asarray(info.fin).sum())
    kept = int(tel["span_n"][0]) - int(d["telemetry"]["span_n"][0])
    assert kept + int(tel["span_drops"][0]) \
        - int(d["telemetry"]["span_drops"][0]) == n_fin
    if room is not None or tick_cap:
        assert kept < n_fin                  # something was dropped


@pytest.mark.parametrize("tick", [135, 143], ids=["open", "seal"])
def test_close_window_matches_reference(mid, tick):
    """The window close on an open tick and on a window's last tick (a
    row sealed into the ring), from seeded trace values."""
    jsim, st_x, _ = mid
    rng = np.random.default_rng(7)
    ints = {f: np.int32(rng.integers(0, 500)) for f in JTrace._fields}
    vals = dict(ints, used_mips=np.float32(rng.random() * 1e5))
    d = jax_tree_np(st_x)
    d["tick"] = np.int32(tick)
    jst = st_x._replace(tick=jnp.int32(tick))
    params = jsim.params
    jdyn = JDyn.from_params(dataclasses.replace(params, tel_tag=3.0))
    with jax_reference():
        want = jax.jit(lambda st, d_, tr: jtel.close_window(
            st, params, d_, tr))(jst, jdyn, JTrace(**vals))
    tparams = SimParams(**dataclasses.asdict(params))
    got = telemetry.close_window(
        _port_state(d, params), tparams,
        TDyn.from_params(dataclasses.replace(tparams, tel_tag=3.0)),
        TTrace(**{k: torch.tensor(v) for k, v in vals.items()}))
    assert_trees_match(_tel(got), jax_tree_np(want.telemetry),
                       where="telemetry.")
    w0, w1 = int(d["telemetry"]["win"][0]), int(_tel(got)["win"][0])
    assert w1 == w0 + (tick % 16 == 15)


def test_drain_rows_matches_reference(mid):
    """The ring's unflushed tail, solo and over a batch of two points at
    different window counts."""
    jsim, st_x, _ = mid
    d = jax_tree_np(st_x)
    rng = np.random.default_rng(3)
    W, K = d["telemetry"]["ring"].shape
    ring = rng.random((2, W, K)).astype(np.float32)
    win = np.array([[13], [16]], np.int32)
    for b in range(2):
        dd = dict(d, telemetry=dict(d["telemetry"], ring=ring[b],
                                    win=win[b]))
        jst = st_x._replace(telemetry=st_x.telemetry._replace(
            ring=jnp.asarray(ring[b]), win=jnp.asarray(win[b])))
        got = telemetry.drain_rows(_port_state(dd, jsim.params),
                                   jsim.params)
        np.testing.assert_array_equal(got, jtel.drain_rows(jst,
                                                           jsim.params))
    jb = st_x._replace(telemetry=st_x.telemetry._replace(
        ring=jnp.asarray(ring), win=jnp.asarray(win)))
    tb = _port_state(d, jsim.params)
    tb = tb._replace(telemetry=tb.telemetry._replace(
        ring=torch.from_numpy(ring), win=torch.from_numpy(win)))
    want = jtel.drain_rows(jb, jsim.params)
    assert want.shape[0] == 1                # 13 → 1 row; 16 → 0 rows
    np.testing.assert_array_equal(telemetry.drain_rows(tb, jsim.params),
                                  want)


def test_flush_cadence_and_validation_match_reference():
    p = SimParams(tel_window_ticks=16, tel_windows=8, telemetry="stream")
    assert telemetry.flush_ticks(p) == jtel.flush_ticks(
        JParams(tel_window_ticks=16, tel_windows=8)) == 64
    assert telemetry.flush_after(p, 0, 130) == [63, 127]
    assert telemetry.flush_after(p, 60, 10) == [3]
    assert telemetry.flush_after(dataclasses.replace(p, telemetry="none"),
                                 0, 130) == []
    for kw in (dict(telemetry="stream", tel_windows=3),
               dict(telemetry="sometimes"),
               dict(telemetry="stream", tel_span_k=0),
               dict(telemetry="stream", tel_span_tick_cap=-1)):
        with pytest.raises(ValueError) as want:
            jvalidate(JParams(**kw))
        with pytest.raises(ValueError) as got:
            validate_telemetry(SimParams(**kw))
        assert str(got.value) == str(want.value)


def test_flusher_hands_over_the_half_sealed_last(mid):
    """On the CPU a flush is handed to the exporter at once: the rows of
    the half of the ring before ``win``, per point, as the reference's
    ``flush`` slices them."""
    jsim, st_x, _ = mid
    W, K = 8, 15
    ring = np.arange(2 * W * K, dtype=np.float32).reshape(2, W, K)
    tel = jax_tree_np(st_x)["telemetry"]
    tel = dict(tel, ring=ring, win=np.array([[4], [8]], np.int32))
    tstate = type(_port_state(jax_tree_np(st_x), jsim.params).telemetry)(
        **{k: torch.from_numpy(np.array(v))
           for k, v in tel.items()})
    f = telemetry.Flusher(SimParams(**SPAN_KW), 1, 2, "cpu")
    with export.collecting() as col:
        f.flush(tstate)
    want = np.concatenate([ring[0, 0:4], ring[1, 4:8]])
    np.testing.assert_array_equal(col.rows_np(), want)
    assert not f.pending


def test_renderers_and_validators():
    rows = [{n: float(i) if n != "window" else float(j)
             for i, n in enumerate(export.TEL_METRIC_COLUMNS)}
            for j in range(3)]
    export.validate_rows(rows)
    assert "repro_completed" in export.prometheus_line(rows[0])
    assert '"window": 1' in export.otel_json(rows[1])
    with pytest.raises(ValueError, match="contiguous"):
        export.validate_rows(rows[1:])
    with pytest.raises(ValueError, match="no telemetry rows"):
        export.validate_rows([])
    ev = dict(time_s=1.0, tag=0.0, service=2, rule="SLOFastBurn",
              state="firing")
    export.validate_alert_rows([ev, dict(ev, time_s=2.0)])
    with pytest.raises(ValueError, match="decreases"):
        export.validate_alert_rows([dict(ev, time_s=2.0), ev])
    with pytest.raises(ValueError, match="unknown state"):
        export.validate_alert_rows([dict(ev, state="on fire")])
    assert "ALERTS{" in export.prometheus_alert_line(ev)


def test_trace_reconstruction_matches_reference():
    """``verify_traces`` on the port's run equals the reference's on its
    own (equal) run, check by check; every completed, retry-free,
    non-failed trace is exact (tolerance 0), and the span tree of a
    diamond request has one root and bitwise parent links."""
    from test_torch_sim import _port_matrix_sim
    kw = dict(SPAN_KW, tel_span_k=2, tel_span_cap=1024)
    with jax_reference():
        jsim = matrix_sim("fabric", "chaos", **kw)
        jres = jsim.run()
    tsim = _port_matrix_sim(jsim)
    tres = tsim.run()
    d_max = int(tsim.app.succ.shape[1])
    want = jspans.verify_traces(jres.state, jsim.graph, d_max)
    got = spans.verify_traces(tres.state, tsim.graph, d_max)
    assert [dataclasses.astuple(c)[:-1] for c in got] == \
        [dataclasses.astuple(c)[:-1] for c in want]
    for g, w in zip(got, want):
        assert (g.graph is None) == (w.graph is None)
        if g.graph is not None:
            np.testing.assert_allclose(float(g.graph), float(w.graph),
                                       rtol=1e-6)
    eligible = [c for c in got if not c.failed and c.retry_free]
    assert len(eligible) >= 5
    assert all(c.exact for c in eligible)
    full = [c for c in eligible if c.n_spans >= 4]
    roots = spans.trace_tree(spans.spans_of(tres.state, full[0].req),
                             tsim.graph.n_services, d_max)
    assert len(roots) == 1
    for s in spans._all_spans(roots):
        if s.parent is not None:
            assert np.float32(s.parent.finish) == np.float32(s.arrival)
    assert spans.format_trace(roots)
    np.testing.assert_array_equal(spans.sampled_requests(tres.state),
                                  jspans.sampled_requests(jres.state))
    a = np.array([[-np.inf, 1.0, -np.inf], [-np.inf, -np.inf, 2.0],
                  [-np.inf] * 3])
    np.testing.assert_array_equal(spans.np_tropical_closure(a, 3),
                                  jspans.np_tropical_closure(a, 3))


@pytest.mark.parametrize("network,faults,extra", [
    ("uniform", "none", {}), ("fabric", "chaos", {}),
    ("uniform", "none", dict(alerting="burn")),
    ("fabric", "chaos", dict(alerting="burn", scaling_policy=1)),
])
def test_profile_labels_match_reference(network, faults, extra):
    """``tick_phases`` names the reference's phases for the mode combo;
    ``phase_breakdown`` gives them and a final ``"Trace+rest"``, and
    ``disruption_breakdown`` the Disruption stages, with finite times."""
    from repro.obs import profile as jprof
    from test_torch_sim import _port_matrix_sim
    jsim = matrix_sim(network, faults, n_ticks=4, **SPAN_KW, **extra)
    tsim = _port_matrix_sim(jsim)
    want = jprof.tick_phases(jsim)
    assert profile.tick_phases(tsim) == want
    rows = profile.phase_breakdown(tsim, reps=1)
    assert [r.label for r in rows] == want + ["Trace+rest"]
    times = profile.profile_np(rows)
    assert np.isfinite(times).all() and (times[:, 1] >= 0).all()
    assert rows[-1].wall_s == pytest.approx(sum(r.delta_s for r in rows))
    assert "| Generation |" in profile.format_table(rows)
    if faults == "chaos":
        stages = profile.disruption_breakdown(tsim, reps=1)
        assert [r.label for r in stages] == \
            list(jprof.DISRUPTION_STAGES) + ["ejection"]
        assert np.isfinite(profile.profile_np(stages)).all()
    else:
        with pytest.raises(ValueError, match="faults='chaos'"):
            profile.disruption_breakdown(tsim)
