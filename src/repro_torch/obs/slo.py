"""SLO objectives and multi-window burn-rate alerting (DESIGN.md §10), as
the reference's ``repro.obs.slo``.

The Alerting tick stage turns the paper's QoS metrics into an in-sim
feedback signal: per-service latency SLIs accumulate on the telemetry
window cadence, Google-SRE-style short/long burn-rate rules evaluate over
the closed windows, and a per-(service, rule) state machine
(inactive → pending → firing → resolved, with ``for_ticks`` hysteresis)
carries the ``AlertState`` tensors.  Firing alerts gate the
``hs_mode="slo_burn"`` autoscaler (``core/scaling.py``) and tighten the
outlier ejection (``core/faults.py``).

The stage draws no key and only re-reads pool columns other phases
already carry, so no layout grows.  With every objective disabled
(budget ≤ 0 after the per-service fallback) the rule conditions are
constant-false and the tensors stay zero.  Transitions append into a
fixed ring (exact drop counting, as the span ring) that drains on the
host at the end of a run through ``export.py``'s alert sinks.

The sums are of integer-valued float32, so any order gives the
reference's bits; the two divisions are tensor by tensor (IEEE on every
device).  Every function runs over the tick's batch axis
(``core.batch``); a solo call is a batch of one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.batch import solo_as_batch
from ..core.pool import add_drop, set_drop, take
from ..core.types import (ALERT_FIRING, ALERT_INACTIVE, ALERT_PENDING,
                          ALERT_RESOLVED, ALERT_RULES, ALERT_STATES,
                          AlertState, SimParams, SimState)

N_RULES = len(ALERT_RULES)
i32, f32 = torch.int32, torch.float32


def enabled(params: SimParams) -> bool:
    """True when the Alerting stage runs in the tick."""
    return params.telemetry == "stream" and params.alerting == "burn"


def objectives(app, dyn):
    """Per-service (target_ms, budget), ``[B, S]`` each: the app's
    per-service values where declared (> 0), the run-wide swept defaults
    otherwise.  A service whose budget is ≤ 0 has no objective."""
    target_ms = torch.where(app.slo_target_ms > 0, app.slo_target_ms,
                            dyn.slo_ms[:, None])
    budget = torch.where(app.slo_budget > 0, app.slo_budget,
                         dyn.slo_budget[:, None])
    return target_ms, budget


def _lookback_frac(sli_win: torch.Tensor, w_closed: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Per-service bad-completion fraction over the last ``n`` closed
    windows of the ``[B, L, S, 2]`` SLI ring (0 where none landed);
    ``w_closed`` is ``[B]``.  ``[B, S]``."""
    L = sli_win.shape[1]
    idx = torch.arange(L, dtype=i32, device=sli_win.device)
    w = w_closed[:, None]
    # window id stored at ring slot p: the largest m < w_closed with
    # m % L == p (negative: the slot was never written)
    m = w - 1 - ((w - 1 - idx) % L)
    mask = ((m >= w - n) & (m >= 0)).to(f32)[:, :, None]        # [B, L, 1]
    good = torch.sum(sli_win[..., 0] * mask, dim=1)
    bad = torch.sum(sli_win[..., 1] * mask, dim=1)
    return bad / torch.clamp_min(good + bad, 1.0)


def evaluate_rules(sli_win: torch.Tensor, w_closed: torch.Tensor,
                   budget: torch.Tensor, params: SimParams, dyn):
    """Burn-rate rule conditions, ``[B, S, N_RULES]`` bool.

    Rule 0 (fast / page): burn over the short lookback and over the last
    single window both ≥ ``slo_fast_burn``.  Rule 1 (slow / ticket):
    burn over the long lookback and over the short lookback both ≥
    ``slo_slow_burn``.  Services with budget ≤ 0 have no objective."""
    active = budget > 0
    safe_budget = torch.clamp_min(budget, 1e-9)
    burn1, burn_s, burn_l = (
        _lookback_frac(sli_win, w_closed, n) / safe_budget
        for n in (1, params.slo_short_wins, params.slo_long_wins))
    fast_t = dyn.slo_fast_burn[:, None]
    slow_t = dyn.slo_slow_burn[:, None]
    fast = active & (burn_s >= fast_t) & (burn1 >= fast_t)
    slow = active & (burn_l >= slow_t) & (burn_s >= slow_t)
    return torch.stack([fast, slow], dim=2)


def step_machine(astate: torch.Tensor, pending: torch.Tensor,
                 cond: torch.Tensor, for_ticks: int):
    """One tick of the per-(service, rule) alert state machine.

    ``held`` counts the consecutive ticks (this one included) the
    condition has held; FIRING needs ``held >= for_ticks``.  RESOLVED is
    a one-tick state entered from FIRING when the condition clears."""
    held = torch.where(cond, torch.where(astate == ALERT_PENDING, pending,
                                         0) + 1, 0)
    firing_now = astate == ALERT_FIRING
    new_state = torch.where(
        firing_now,
        torch.where(cond, ALERT_FIRING, ALERT_RESOLVED),
        torch.where(cond & (held >= for_ticks), ALERT_FIRING,
                    torch.where(cond, ALERT_PENDING, ALERT_INACTIVE)))
    new_pending = torch.where(new_state == ALERT_PENDING, held, 0)
    return new_state.to(i32), new_pending.to(i32)


def firing_mask(alerts: AlertState) -> torch.Tensor:
    """``[..., S]`` bool: any rule firing for the service."""
    return (alerts.astate == ALERT_FIRING).any(dim=-1)


def active_mask(alerts: AlertState) -> torch.Tensor:
    """``[..., S]`` bool: any rule pending or firing (the burn-mode
    scale-in guard)."""
    return ((alerts.astate == ALERT_PENDING)
            | (alerts.astate == ALERT_FIRING)).any(dim=-1)


@solo_as_batch("state")
def alert_step(state: SimState, info, params: SimParams, dyn,
               app) -> SimState:
    """The Alerting tick stage: accumulate SLIs from this tick's finished
    hops, seal the SLI window on the telemetry cadence, evaluate the burn
    rules over the closed windows, advance the state machines and append
    the transitions into the event ring.  Runs right after the span pass
    (after Execute), on the same ``FinishInfo``."""
    al = state.alerts
    cl = state.cloudlets
    B, S = al.sli_acc.shape[:2]
    dev = al.sli_acc.device

    target_ms, budget = objectives(app, dyn)

    # --- SLI accumulate: (good, bad) completions per service this tick --
    fin = info.fin & (info.pre_service >= 0)
    svc_safe = torch.clamp(info.pre_service, 0, S - 1)
    arrival = cl.flts[..., cl.layout.f("arrival")]
    sojourn_ms = (info.tfin - arrival) * 1000.0
    bad = fin & (sojourn_ms > take(target_ms, svc_safe))
    # one [C, 2] scatter-add of integer-valued counts: exact in any order
    gb = torch.stack([(fin & ~bad).to(f32), bad.to(f32)], dim=2)
    acc = al.sli_acc + add_drop(torch.zeros_like(al.sli_acc),
                                info.pre_service, gb, fin)

    # --- window seal: the telemetry metric ring's cadence ----------------
    L = al.sli_win.shape[1]
    Wt = params.tel_window_ticks
    due = (state.tick % Wt) == (Wt - 1)                          # [B]
    w = al.win[:, 0]
    seal = due[:, None] & (torch.arange(L, device=dev) == (w % L)[:, None])
    sli_win = torch.where(seal[:, :, None, None], acc[:, None],
                          al.sli_win)
    acc = torch.where(due[:, None, None], 0.0, acc)
    w_closed = w + due.to(i32)

    # --- burn rules + state machine -------------------------------------
    cond = evaluate_rules(sli_win, w_closed, budget, params, dyn)
    st0 = al.astate
    st1, pending1 = step_machine(st0, al.pending, cond, params.slo_for_ticks)
    fired = (st1 == ALERT_FIRING) & (st0 != ALERT_FIRING)
    resolved = st1 == ALERT_RESOLVED        # only reachable from FIRING

    # --- transition events into the append-until-full ring --------------
    changed = (st1 != st0).reshape(B, -1)                     # [B, S*NR]
    svc_id = torch.arange(S, dtype=i32, device=dev).repeat_interleave(
        N_RULES)
    rule_id = torch.arange(N_RULES, dtype=i32, device=dev).repeat(S)
    AP = al.ev_time.shape[1]
    rank = torch.cumsum(changed, 1, dtype=i32) - 1
    dst = al.ev_n + rank
    keep = changed & (dst < AP)
    n_keep = torch.sum(keep, 1, dtype=i32)
    n_changed = torch.sum(changed, 1, dtype=i32)
    t_now = (state.time + dyn.dt)[:, None]
    ev = lambda ring, v: set_drop(ring, dst, v, keep)
    return state._replace(alerts=al._replace(
        sli_win=sli_win,
        sli_acc=acc,
        win=al.win + due.to(i32)[:, None],
        astate=st1,
        pending=pending1,
        fires=al.fires + fired.to(i32),
        resolves=al.resolves + resolved.to(i32),
        firing_ticks=al.firing_ticks + (st1 == ALERT_FIRING).to(i32),
        ev_time=ev(al.ev_time, t_now.expand(B, S * N_RULES)),
        ev_service=ev(al.ev_service, svc_id.expand(B, -1)),
        ev_rule=ev(al.ev_rule, rule_id.expand(B, -1)),
        ev_state=ev(al.ev_state, st1.reshape(B, -1)),
        ev_n=al.ev_n + n_keep[:, None],
        ev_drops=al.ev_drops + (n_changed - n_keep)[:, None],
    ))


# --------------------------------------------------------------------------
# Host-side end-of-run drain
# --------------------------------------------------------------------------

def drain_events(alerts: AlertState, tags=None) -> list:
    """The alert-transition rows of a final ``AlertState``, solo (``[AP]``
    rings) or of a sweep (``[B, AP]``); ``tags`` labels each point
    (default: its index, as ``run_batch``'s automatic ``tel_tag``).  Rows
    carry the ``export.ALERT_COLUMNS`` schema with the rule and state as
    label strings."""
    host = lambda t: np.asarray(t.detach().cpu().numpy()
                                if isinstance(t, torch.Tensor) else t)
    ev_time = host(alerts.ev_time)
    if ev_time.size == 0 and ev_time.ndim <= 1:
        return []
    batched = ev_time.ndim == 2
    B = ev_time.shape[0] if batched else 1
    cols = {f: host(getattr(alerts, f)) for f in
            ("ev_n", "ev_time", "ev_service", "ev_rule", "ev_state")}
    lane = lambda f, b: cols[f][b] if batched else cols[f]

    if tags is None:
        tag_of = lambda b: float(b)
    else:
        t = np.asarray(tags).reshape(-1)
        tag_of = lambda b: float(t[b]) if t.size > 1 else float(t[0])

    rows = []
    for b in range(B):
        n = int(lane("ev_n", b).reshape(-1)[0])
        times, svcs = lane("ev_time", b), lane("ev_service", b)
        rules, states = lane("ev_rule", b), lane("ev_state", b)
        for j in range(min(n, times.shape[0])):
            rows.append({
                "time_s": float(times[j]),
                "tag": tag_of(b),
                "service": int(svcs[j]),
                "rule": ALERT_RULES[int(rules[j])],
                "state": ALERT_STATES[int(states[j])],
            })
    return rows


def drain_to_exporter(state: SimState, params: SimParams,
                      tags=None) -> None:
    """Push the final state's alert transitions to the installed alert
    sinks (``export.install_alert``); ``Simulation.run`` and
    ``run_batch`` call it after the telemetry drain."""
    if not enabled(params):
        return
    from . import export
    rows = drain_events(state.alerts, tags=tags)
    if rows:
        export.dispatch_alerts(rows)
