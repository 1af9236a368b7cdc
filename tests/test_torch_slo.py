"""The port's SLO burn-rate alerting (``repro_torch.obs.slo``) against the
JAX reference's ``repro.obs.slo``, function by function, on the same
inputs: the lookback fractions across the SLI ring's wrap, the rule
conditions over seeded SLI rings, the four state-machine cases of the
reference's tests, the whole Alerting stage from a mid-run state (and
with the event ring overflowing, and with targets set on the finished
hops' own sojourns, where a third rounding would flip a hop), and the
end-of-run event drain.  The
reference runs jitted, under the non-partitionable threefry derivation.
Tolerance zero: every leaf equal, floats bit for bit.
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
from repro.core.types import validate_alerting as jvalidate
from repro.obs import slo as jslo

from repro_torch.core import SimParams, convert
from repro_torch.core import scheduler as tsched
from repro_torch.core.batch import dyn_tensors
from repro_torch.core.types import (ALERT_FIRING, ALERT_INACTIVE,
                                    ALERT_PENDING, ALERT_RESOLVED,
                                    DynParams as TDyn, resolve_layout,
                                    validate_alerting)
from repro_torch.obs import slo

torch.set_num_threads(1)

# every completion misses slo_ms=1.0: the fast rule fires within a few
# windows (tests/test_slo.py's HOT_KW)
HOT_KW = dict(telemetry="stream", tel_window_ticks=16, tel_windows=8,
              tel_span_k=4, tel_span_cap=256, alerting="burn",
              slo_budget=0.05, slo_ms=1.0, slo_short_wins=2,
              slo_long_wins=4, slo_for_ticks=2)


def _sli_ring(rng, L, S, w_closed):
    """A seeded [L, S, 2] ring of integer-valued (good, bad) counts for
    the windows before ``w_closed``, with fractions off every threshold's
    knife edge and some in between."""
    sli = np.zeros((L, S, 2), np.float32)
    for m in range(max(0, w_closed - L), w_closed):
        n = rng.integers(1, 40, size=S).astype(np.float32)
        bad = np.floor(n * rng.choice([0.0, 0.2, 0.5, 1.0], size=S))
        sli[m % L, :, 0] = n - bad
        sli[m % L, :, 1] = bad
    return sli


@pytest.mark.parametrize("w_closed", [0, 1, 3, 4, 6, 11, 100])
def test_lookback_frac_matches_reference_across_the_wrap(w_closed):
    rng = np.random.default_rng(w_closed)
    L, S = 6, 5
    sli = _sli_ring(rng, L, S, w_closed)
    for n in (1, 2, 4, 6):
        want = np.asarray(jax.jit(lambda s, w: jslo._lookback_frac(
            s, w, n))(jnp.asarray(sli), jnp.int32(w_closed)))
        got = slo._lookback_frac(torch.from_numpy(sli)[None],
                                 torch.tensor([w_closed], dtype=torch.int32),
                                 n)[0].numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_lookback_frac_ring_wraparound():
    """The reference test's case: windows 2, 3, 4 in slots 2, 0, 1; a
    one-window lookback reads only window 4."""
    sli = np.zeros((3, 1, 2), np.float32)
    sli[2, 0], sli[0, 0], sli[1, 0] = (10.0, 0.0), (10.0, 0.0), (0.0, 10.0)
    w = torch.tensor([5], dtype=torch.int32)
    f1 = float(slo._lookback_frac(torch.from_numpy(sli)[None], w, 1)[0, 0])
    f3 = float(slo._lookback_frac(torch.from_numpy(sli)[None], w, 3)[0, 0])
    assert f1 == 1.0 and f3 == np.float32(10.0) / np.float32(30.0)


def test_evaluate_rules_match_reference():
    """Both rules over seeded rings at several fill levels, budgets
    enabled, zero and negative (no objective), thresholds swept."""
    rng = np.random.default_rng(11)
    L, S = 6, 5
    budget = np.array([0.05, 0.1, 0.0, -1.0, 0.3], np.float32)
    for w_closed in (0, 1, 3, 6, 11):
        for fast, slow in ((14.4, 6.0), (2.0, 1.0), (5.0, 3.3)):
            params = JParams(telemetry="stream", alerting="burn",
                             slo_short_wins=2, slo_long_wins=4,
                             slo_fast_burn=fast, slo_slow_burn=slow)
            sli = _sli_ring(rng, L, S, w_closed)
            want = np.asarray(jax.jit(lambda s, w, b, d: jslo.evaluate_rules(
                s, w, b, params, d))(jnp.asarray(sli), jnp.int32(w_closed),
                                     jnp.asarray(budget),
                                     JDyn.from_params(params)))
            tp = SimParams(**dataclasses.asdict(params))
            got = slo.evaluate_rules(
                torch.from_numpy(sli)[None],
                torch.tensor([w_closed], dtype=torch.int32),
                torch.from_numpy(budget)[None], tp,
                dyn_tensors(TDyn.from_params(tp), "cpu"))[0].numpy()
            np.testing.assert_array_equal(got, want)
            assert not got[2].any() and not got[3].any()


def _drive(step, conds, for_ticks):
    st = np.full((1,), ALERT_INACTIVE, np.int32)
    pend = np.zeros((1,), np.int32)
    out = []
    for c in conds:
        st, pend = step(st, pend, np.asarray([bool(c)]), for_ticks)
        out.append(int(np.asarray(st)[0]))
    return out


def _torch_step(st, pend, cond, for_ticks):
    st, pend = slo.step_machine(torch.as_tensor(st), torch.as_tensor(pend),
                                torch.as_tensor(cond), for_ticks)
    return st.numpy(), pend.numpy()


@pytest.mark.parametrize("conds,for_ticks,want", [
    ([1, 1, 1, 1, 0, 0], 3,
     [ALERT_PENDING, ALERT_PENDING, ALERT_FIRING, ALERT_FIRING,
      ALERT_RESOLVED, ALERT_INACTIVE]),
    ([1, 1, 0, 1, 1, 0, 1], 3,
     [ALERT_PENDING, ALERT_PENDING, ALERT_INACTIVE, ALERT_PENDING,
      ALERT_PENDING, ALERT_INACTIVE, ALERT_PENDING]),
    ([1, 0, 1], 1, [ALERT_FIRING, ALERT_RESOLVED, ALERT_FIRING]),
    ([1, 1, 0, 0, 1, 1], 2,
     [ALERT_PENDING, ALERT_FIRING, ALERT_RESOLVED, ALERT_INACTIVE,
      ALERT_PENDING, ALERT_FIRING]),
], ids=["round_trip", "hysteresis_gap", "for_ticks_one", "refire"])
def test_step_machine_matches_reference(conds, for_ticks, want):
    """The reference tests' four transition cases, each step against the
    reference's ``step_machine``."""
    j = _drive(lambda s, p, c, f: jslo.step_machine(
        jnp.asarray(s), jnp.asarray(p), jnp.asarray(c), f), conds,
        for_ticks)
    assert _drive(_torch_step, conds, for_ticks) == j == want


@pytest.fixture(scope="module")
def hot():
    """The reference's hot run (every completion an SLO miss) after 120
    ticks, and its ``execute`` from there."""
    with jax_reference():
        jsim = matrix_sim("uniform", "none", n_ticks=120, **HOT_KW)
        jst = jsim.run().state
        dyn = JDyn.from_params(jsim.params)
        st_x, info = jax.jit(lambda st, d, a: jsched.execute(
            st, a, jsim.caps, jsim.params, d))(jst, dyn, jsim.app)
    assert int(np.asarray(jst.alerts.fires).sum()) > 0
    return jsim, st_x, info


def _alert_step_both(jsim, st_x, info, d, tick):
    jst = convert.state_from_numpy(d, resolve_layout(jsim.params), "cpu")
    j_in = st_x._replace(tick=jnp.int32(tick), alerts=type(st_x.alerts)(
        **{k: jnp.asarray(v) for k, v in d["alerts"].items()}))
    params = jsim.params
    with jax_reference():
        want = jax.jit(lambda st, i, dd, a: jslo.alert_step(
            st, i, params, dd, a))(j_in, info, JDyn.from_params(params),
                                   jsim.app)
    from test_torch_phases import torch_app
    tp = SimParams(**dataclasses.asdict(params))
    got = slo.alert_step(jst, tsched.FinishInfo(*[
        torch.from_numpy(np.array(x)) for x in info]), tp,
        TDyn.from_params(tp), torch_app(jsim.app))
    return convert.state_to_numpy(got)["alerts"], jax_tree_np(want.alerts)


@pytest.mark.parametrize("tick", [120, 127], ids=["open", "seal"])
def test_alert_step_matches_reference(hot, tick):
    """The Alerting stage on an open tick and on a window's last tick
    (an SLI window sealed, the rules evaluated over it)."""
    jsim, st_x, info = hot
    d = jax_tree_np(st_x)
    d["tick"] = np.int32(tick)
    got, want = _alert_step_both(jsim, st_x, info, d, tick)
    assert_trees_match(got, want, where="alerts.")


def test_alert_step_event_ring_overflow_matches_reference(hot):
    """Every (service, rule) leaves RESOLVED in one tick (a one-tick
    state), so all S·NR transitions append at once into a ring three
    rows short of full: three land, the rest are counted as dropped."""
    jsim, st_x, info = hot
    d = jax_tree_np(st_x)
    al = d["alerts"]
    AP = al["ev_time"].shape[0]
    al["astate"] = np.full_like(al["astate"], ALERT_RESOLVED)
    al["ev_n"] = np.array([AP - 3], np.int32)
    got, want = _alert_step_both(jsim, st_x, info, d, int(d["tick"]))
    assert_trees_match(got, want, where="alerts.")
    n_tr = al["astate"].size
    assert int(got["ev_n"][0]) == AP
    assert int(got["ev_drops"][0]) - int(al["ev_drops"][0]) == n_tr - 3


def test_objectives_and_validation_match_reference():
    """Per-service objectives fall back to the swept defaults; the
    validators raise the reference's errors."""
    from test_torch_phases import torch_app
    jsim = matrix_sim("uniform", "none", **HOT_KW)
    app = jsim.app._replace(
        slo_target_ms=jnp.asarray([50.0, -1.0, 80.0, -1.0], jnp.float32),
        slo_budget=jnp.asarray([-1.0, 0.2, -1.0, 0.01], jnp.float32))
    dyn = JDyn.from_params(jsim.params)
    want = [np.asarray(x) for x in jslo.objectives(app, dyn)]
    tp = SimParams(**dataclasses.asdict(jsim.params))
    got = slo.objectives(torch_app(app), dyn_tensors(TDyn.from_params(tp),
                                                     "cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[0], w)
    assert slo.enabled(tp) and not slo.enabled(SimParams())
    for kw in (dict(alerting="burn"), dict(alerting="sometimes"),
               dict(hs_mode="vibes"), dict(hs_mode="slo_burn"),
               dict(telemetry="stream", alerting="burn", slo_short_wins=4,
                    slo_long_wins=2),
               dict(telemetry="stream", alerting="burn", slo_for_ticks=0),
               dict(telemetry="stream", alerting="burn",
                    slo_eject_tighten=0.0)):
        with pytest.raises(ValueError) as w:
            jvalidate(JParams(**kw))
        with pytest.raises(ValueError) as g:
            validate_alerting(SimParams(**kw))
        assert str(g.value) == str(w.value)


def test_drain_events_matches_reference(hot):
    """The event rows of a solo state and of a batch of two (the second
    with a shorter ring fill), with and without tags."""
    _, st_x, _ = hot
    al = st_x.alerts
    n = int(np.asarray(al.ev_n)[0])
    assert n > 2
    talerts = convert.state_from_numpy(
        jax_tree_np(st_x), resolve_layout(SimParams(**HOT_KW)),
        "cpu").alerts
    assert slo.drain_events(talerts) == jslo.drain_events(al)
    assert slo.drain_events(talerts, tags=np.float32([7.0])) == \
        jslo.drain_events(al, tags=np.float32([7.0]))
    stack = lambda x, y: np.stack([np.asarray(x), np.asarray(y)])
    ev_n2 = np.array([n - 2], np.int32)
    jb = type(al)(*[stack(x, ev_n2 if f == "ev_n" else x)
                    for f, x in zip(al._fields, al)])
    tb = type(talerts)(*[torch.from_numpy(np.array(x)) for x in jb])
    for tags in (None, np.float32([3.0, 5.0])):
        assert slo.drain_events(tb, tags=tags) == \
            jslo.drain_events(jb, tags=tags)
    assert slo.drain_events(convert.state_from_numpy(
        jax_tree_np(st_x), resolve_layout(SimParams()), "cpu").alerts
        ._replace(ev_time=torch.zeros(0))) == []


def test_sojourn_rounding_matches_reference_at_the_threshold(hot):
    """``sojourn_ms = (tfin - arrival) * 1000`` is two float32 roundings
    in the compiled reference too: with each service's target set to
    exactly the two-rounding sojourn of one of its finished hops (and of
    another hop one ULP below it), the hops on the threshold count good
    and the reference's SLI sums equal the port's."""
    from test_torch_phases import torch_app
    jsim, st_x, info = hot
    fin = np.asarray(info.fin)
    svc = np.asarray(info.pre_service)
    lay = resolve_layout(jsim.params)
    arrival = np.asarray(st_x.cloudlets.flts)[:, lay.f("arrival")]
    soj = (np.asarray(info.tfin) - arrival) * np.float32(1000.0)
    assert soj.dtype == np.float32
    hops = np.flatnonzero(fin & (svc >= 0))
    assert len(hops) >= 2
    target = np.full(jsim.app.slo_target_ms.shape, -1.0, np.float32)
    for i in hops[::-1]:
        target[svc[i]] = soj[i]
    # one hop a hair below its target: one ULP apart, counted good
    target[svc[hops[0]]] = np.nextafter(soj[hops[0]], np.float32(np.inf))
    app = jsim.app._replace(slo_target_ms=jnp.asarray(target))
    params = jsim.params
    with jax_reference():
        want = jax.jit(lambda st, i, dd, a: jslo.alert_step(
            st, i, params, dd, a))(st_x, info, JDyn.from_params(params),
                                   app)
    tp = SimParams(**dataclasses.asdict(params))
    got = slo.alert_step(
        convert.state_from_numpy(jax_tree_np(st_x), lay, "cpu"),
        tsched.FinishInfo(*[torch.from_numpy(np.array(x)) for x in info]),
        tp, TDyn.from_params(tp), torch_app(app))
    got_acc = got.alerts.sli_acc.numpy()
    np.testing.assert_array_equal(got_acc, np.asarray(want.alerts.sli_acc))
    d_acc = got_acc - jax_tree_np(st_x)["alerts"]["sli_acc"]
    on_target = np.zeros_like(d_acc)
    for i in hops:
        on_target[svc[i], int(soj[i] > target[svc[i]])] += 1
    np.testing.assert_array_equal(d_acc, on_target)
