"""Device-side telemetry: the metric-row ring and the sampled span ring
(§9), as the reference's ``repro.obs.telemetry``.

Two fixed-capacity buffers ride the state (``TelemetryState``):

- the **metric ring** ``[W, K]`` holds one row per closed window of
  ``tel_window_ticks`` ticks.  It is flushed in halves: every
  ``flush_ticks`` ticks the run's loop copies the half just sealed to the
  host (:class:`Flusher`: an asynchronous copy into pinned memory and an
  event, between two replayed ticks) while the next ticks seal rows into
  the other half;
- the **span ring** ``[SP, NSI|NSF]`` appends one span per finished
  cloudlet (hop) of a seeded 1-in-k request sample; at capacity it never
  overwrites, it counts every dropped span exactly.

Everything here observes only: no tick key is drawn (the sample mask is
drawn once at init from a named ``fold_in`` stream), no simulation leaf
is written, and the pool layout is unchanged (``types._layout_for``
rejects any Telemetry phase column outside the mode's set).  The windows
close on a fixed cadence (``tick % tel_window_ticks``), so the host knows
which ticks end a flush without reading the device.  Every function runs
over the tick's batch axis (``core.batch``); a solo call is a batch of
one.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..core import network as netmod
from ..core.batch import solo_as_batch
from ..core.pool import set_drop, take
from ..core.types import (TEL_METRIC_COLUMNS, DynParams, SimParams,
                          SimState, TickTrace)
from . import export

i32, f32 = torch.int32, torch.float32


def flush_ticks(params: SimParams) -> int:
    """Ticks between flushes: half the ring's windows."""
    return params.tel_window_ticks * (params.tel_windows // 2)


def flush_after(params: SimParams, first_tick: int, n: int) -> list:
    """The indices ``i`` (0-based, within a run of ``n`` ticks from tick
    ``first_tick``) of the ticks after which the loop flushes: those that
    complete a multiple of ``flush_ticks`` ticks from tick 0."""
    if params.telemetry != "stream":
        return []
    chunk = flush_ticks(params)
    return [i for i in range(n) if (first_tick + i + 1) % chunk == 0]


# ----------------------------------------------------------------------
# In-tick recording
# ----------------------------------------------------------------------
@solo_as_batch("state")
def record_spans(state: SimState, info, params: SimParams) -> SimState:
    """Append one span per finished cloudlet of a sampled request.

    Runs between Execute and Derive: ``execute`` clears only
    status/rem/inst on finish, so the descriptive columns (req, service,
    wait_ticks, arrival, start, and edge/attempt/src_host where the mode
    carries them) are still readable, and Derive has not yet respawned
    over the freed slots.

    The sampled finishers are rank-compacted into ``KB = min(SP, C,
    tel_span_tick_cap)`` slots first (a ``searchsorted`` over the int32
    cumsum, per point), so the row build and the scatter touch KB slots,
    not the pool.  A sampled finisher of rank ≥ KB either cannot exist
    or would have overflowed the ring (or the per-tick budget): its span
    is counted in ``span_drops``, exactly.  Rows past the ring's end go
    to the drop sentinel (``pool.set_drop``)."""
    cl, tel = state.cloudlets, state.telemetry
    B, C = info.fin.shape
    SP = tel.span_i.shape[1]
    KB = min(SP, C)
    if params.tel_span_tick_cap:
        KB = min(KB, params.tel_span_tick_cap)
    dev = info.fin.device

    sampled = info.fin & (info.pre_req >= 0) & (
        take(tel.sample, torch.clamp_min(info.pre_req, 0)) > 0)
    csum = torch.cumsum(sampled, 1, dtype=i32)
    n_want = csum[:, C - 1]
    # slot j ← pool index of the (j+1)-th sampled finisher: the cumsum
    # reaches j+1 exactly there (past-the-end queries give C = invalid)
    want = torch.arange(1, KB + 1, dtype=i32, device=dev).expand(B, KB)
    src = torch.searchsorted(csum, want.contiguous(), side="left",
                             out_int32=True)
    valid = src < C
    sc = torch.clamp_max(src, C - 1)

    L = cl.layout
    gi, gf = take(cl.ints, sc), take(cl.flts, sc)     # [B, KB, NI|NF]
    inst_k = take(info.pre_inst, sc)
    host = torch.where(inst_k >= 0,
                       take(state.instances.host, torch.clamp_min(inst_k, 0)),
                       -1)
    neg1 = torch.full((B, KB), -1, dtype=i32, device=dev)
    col = lambda n: gi[..., L.i(n)]
    opt = lambda n, absent: col(n) if n in L else absent
    # column order == TEL_SPAN_I_COLUMNS / TEL_SPAN_F_COLUMNS
    rows_i = torch.stack([col("req"), col("service"), inst_k, host,
                          opt("src_host", neg1), opt("edge", neg1),
                          opt("attempt", torch.zeros_like(neg1)),
                          col("wait_ticks")], dim=2)
    rows_f = torch.stack([gf[..., L.f("arrival")], gf[..., L.f("start")],
                          take(info.tfin, sc)], dim=2)

    dst = tel.span_n + torch.arange(KB, dtype=i32, device=dev)
    keep = valid & (dst < SP)
    n_keep = torch.sum(keep, 1, dtype=i32)
    tel = tel._replace(
        span_i=set_drop(tel.span_i, dst, rows_i, keep),
        span_f=set_drop(tel.span_f, dst, rows_f, keep),
        span_n=tel.span_n + n_keep[:, None],
        span_drops=tel.span_drops + (n_want - n_keep)[:, None])
    return state._replace(telemetry=tel)


@solo_as_batch("state")
def close_window(state: SimState, params: SimParams, dyn: DynParams,
                 trace: TickTrace) -> SimState:
    """Accumulate this tick into the open window; on the window's last
    tick, seal a metric row into the ring slot ``win % W``."""
    tel = state.telemetry
    W, Wt = params.tel_windows, params.tel_window_ticks
    dev = state.time.device
    acc = tel.acc + torch.stack([trace.completed.to(f32),
                                 trace.generated.to(f32)], dim=1)
    due = (state.tick % Wt) == (Wt - 1)                         # [B]
    zero = torch.zeros_like(state.time)
    inflight = netmod.inflight_mb(state.cloudlets) \
        if params.network == "fabric" else zero
    if params.faults == "chaos":
        failed = state.fstats.failed_attempts.to(f32)
        retries = state.fstats.retries.to(f32)
    else:
        failed = retries = zero
    row = torch.stack([                    # order == TEL_METRIC_COLUMNS
        tel.win[:, 0].to(f32),
        state.time + dyn.dt,
        dyn.tel_tag,
        acc[:, 0], acc[:, 1],
        trace.n_waiting.to(f32),
        trace.n_exec.to(f32),
        trace.n_transit.to(f32),
        trace.used_mips,
        trace.active_instances.to(f32),
        inflight, failed, retries,
        tel.span_n[:, 0].to(f32),
        tel.span_drops[:, 0].to(f32)], dim=1)                   # [B, K]
    slot = tel.win % W                                          # [B, 1]
    seal = due[:, None] & (torch.arange(W, device=dev) == slot)  # [B, W]
    tel = tel._replace(
        ring=torch.where(seal[:, :, None], row[:, None, :], tel.ring),
        acc=torch.where(due[:, None], 0.0, acc),
        win=tel.win + due.to(i32)[:, None])
    return state._replace(telemetry=tel)


# ----------------------------------------------------------------------
# Flushes (between ticks, on the host's cadence) and the end-of-run drain
# ----------------------------------------------------------------------
class Flusher:
    """The flushes of one run: ``n`` of them, for ``B`` points.

    Each :meth:`flush` gathers the half of the ring sealed last (slots
    ``(win - W/2 .. win - 1) % W``, per point, on the device) and copies
    it to the host: on the card asynchronously, into a pinned buffer of
    its own (all ``n`` are allocated here, before the loop), with an
    event behind it, so nothing waits for the device and no buffer is
    written twice.  :meth:`poll` hands every flush whose copy is done to
    the exporter, in order; :meth:`finish` waits for the rest.  On the
    CPU a flush is handed over at once."""

    def __init__(self, params: SimParams, n: int, B: int, device):
        self.W = params.tel_windows
        self.half = self.W // 2
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        K = len(TEL_METRIC_COLUMNS)
        self.bufs = [torch.empty((B, self.half, K), dtype=f32,
                                 pin_memory=self.cuda) for _ in range(n)]
        self.events = [torch.cuda.Event() if self.cuda else None
                       for _ in range(n)]
        self.offsets = torch.arange(self.half, device=device)
        self.n = 0
        self.pending: collections.deque = collections.deque()

    def flush(self, tel) -> None:
        """Copy out the half of ``tel``'s ring (batched: ``[B, W, K]``)
        sealed last."""
        idx = (tel.win - self.half + self.offsets) % self.W      # [B, half]
        rows = take(tel.ring, idx)
        buf, ev = self.bufs[self.n], self.events[self.n]
        self.n += 1
        buf.copy_(rows, non_blocking=self.cuda)
        if ev is None:
            export.dispatch(buf.numpy())
            return
        ev.record()
        self.pending.append((ev, buf))
        self.poll()

    def poll(self) -> None:
        """Hand every flush whose copy has completed to the exporter (no
        wait)."""
        while self.pending and self.pending[0][0].query():
            export.dispatch(self.pending.popleft()[1].numpy())

    def finish(self) -> None:
        """Wait for the flushes still in flight and hand them over."""
        while self.pending:
            ev, buf = self.pending.popleft()
            ev.synchronize()
            export.dispatch(buf.numpy())


def drain_rows(state: SimState, params: SimParams) -> np.ndarray:
    """The sealed-but-unflushed tail of the metric ring, ``[n, K]``
    float32 (empty with telemetry off); a batched final state (``[B, W,
    K]`` rings) drains point by point, concatenated."""
    ring = state.telemetry.ring.detach().cpu().numpy()
    win = state.telemetry.win.detach().cpu().numpy()
    if ring.size == 0:
        return np.zeros((0, len(TEL_METRIC_COLUMNS)), np.float32)
    if ring.ndim == 3:
        return np.concatenate(
            [_drain_one(ring[b], int(win[b, 0]), params)
             for b in range(ring.shape[0])], axis=0)
    return _drain_one(ring, int(win[0]), params)


def _drain_one(ring: np.ndarray, w: int, params: SimParams) -> np.ndarray:
    W = params.tel_windows
    half = W // 2
    flushed = (w // half) * half            # sealed rows already flushed
    idx = [(flushed + j) % W for j in range(w - flushed)]
    if not idx:
        return np.zeros((0, ring.shape[1]), np.float32)
    return ring[idx]


def drain_to_exporter(state: SimState, params: SimParams) -> None:
    rows = drain_rows(state, params)
    if rows.size:
        export.dispatch(rows)
