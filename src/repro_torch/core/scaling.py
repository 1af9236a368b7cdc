"""Service scaling policies (paper §5.3, Algorithms 4–5).

* NS — no scaling (paper §6.4 baseline).
* HS — horizontal (Alg 4): replicate a hot service onto a VM with
  head-room; scale-in drains the newest replica of a cold service.
* VS — vertical (Alg 5): raise/lower the CPU share of hot/cold instances
  within the requests/limits band, with a per-VM fair-share clamp.
* HYBRID — HS, then VS.

The reference runs HS as a loop over services with a data-dependent
``lax.cond`` per service.  Here the loop over services stays sequential in
Python (each scale-out takes a slot the next one must see), each step over
every point of the batch at once, and each branch is computed and selected
with ``torch.where`` — no value ever comes back to the host.
"""
from __future__ import annotations

import torch

from .. import random as rnd
from ..obs import slo as slomod
from . import policies
from .app import AppStatic
from .batch import solo_as_batch
from .pool import add_drop, at, take
from .types import (DynParams, INST_DRAIN, INST_FREE, INST_ON, SimCaps,
                    SimParams, SimState)

i32, f32 = torch.int32, torch.float32


def _service_util(state: SimState, n_services: int) -> torch.Tensor:
    """Mean utilization EMA over the ON replicas of each service."""
    inst = state.instances
    on = inst.status == INST_ON
    sid = torch.where(on, inst.service, -1)
    z = torch.zeros((on.shape[0], n_services), dtype=f32, device=on.device)
    tot = add_drop(z, sid, torch.where(on, inst.util_ema, 0.0), sid >= 0)
    cnt = add_drop(z, sid, on.to(f32), sid >= 0)
    return tot / torch.clamp_min(cnt, 1.0)


def _onehot(n: int, i: torch.Tensor) -> torch.Tensor:
    """``[B, n]``: True at ``i[b]`` in row ``b``."""
    return torch.arange(n, device=i.device) == i[:, None]


# ===========================================================================
# Horizontal scaling (Algorithm 4)
# ===========================================================================

def horizontal(state: SimState, app: AppStatic, caps: SimCaps,
               dyn: DynParams, params: SimParams | None = None) -> SimState:
    S = app.n_services
    util = _service_util(state, S)
    reps = state.sched.svc_replicas
    can_grow = (reps >= 1) & (reps < caps.max_replicas)
    want_out = (util > dyn.hs_util_hi[:, None]) & can_grow
    want_in = (util < dyn.hs_util_lo[:, None]) & (reps > 1)
    if params is not None and params.telemetry == "stream" \
            and params.alerting == "burn":
        # the burn-rate gate: at the points whose hs_mode is "slo_burn",
        # scale out on a firing burn alert once the service's
        # stabilization window has passed (not on the util EMA), and
        # never scale in while an alert is pending or firing.  hs_mode is
        # a swept value, so both gates are computed and selected per
        # point; at "util" points the util masks pass unchanged.
        al = state.alerts
        firing = slomod.firing_mask(al)
        burn = (dyn.hs_mode == policies.HS_SLO_BURN)[:, None]
        t = state.time[:, None]
        want_out_burn = firing & (t >= al.hold_until) & can_grow
        want_out = torch.where(burn, want_out_burn, want_out)
        want_in = torch.where(burn, want_in & ~slomod.active_mask(al),
                              want_in)
        # the stabilization clock arms on the scale-out attempt (the
        # commit may still fail on capacity)
        state = state._replace(alerts=al._replace(hold_until=torch.where(
            burn & want_out, t + dyn.slo_stabilize_s[:, None],
            al.hold_until)))
    for s in range(S):
        state = _scale_out(state, s, app, want_out[:, s])
        state = _scale_in(state, s, want_in[:, s])
    return state


def _scale_out(state: SimState, s: int, app: AppStatic,
               want: torch.Tensor) -> SimState:
    """Alg 4: create a replica; bind on success, no-op on failure (each
    point of the batch on its own: ``want`` is ``[B]``)."""
    inst, vms, sched = state.instances, state.vms, state.sched
    I = inst.status.shape[1]
    free_slot = inst.status == INST_FREE
    slot = torch.argmax(free_slot.to(i32), dim=1)
    has_slot = at(free_slot, slot)
    # VM queue sorted by descending available resources; down hosts are
    # excluded (all up with faults off).
    free = torch.where(state.fault.host_up > 0, vms.mips - vms.mips_used,
                       float("-inf"))
    vm = torch.argmax(free, dim=1)
    need_mips = app.tmpl_mips[:, s]
    need_ram = app.tmpl_ram[:, s]
    fits = (at(free, vm) >= need_mips) & \
        (at(vms.ram, vm) - at(vms.ram_used, vm) >= need_ram)
    do = want & has_slot & fits

    at_slot = do[:, None] & _onehot(I, slot)
    put = lambda x, v: torch.where(at_slot, v, x)
    vm32 = vm.to(i32)[:, None]
    instances = inst._replace(
        status=put(inst.status, INST_ON), service=put(inst.service, s),
        vm=put(inst.vm, vm32), host=put(inst.host, vm32),
        mips=put(inst.mips, need_mips[:, None]),
        limit_mips=put(inst.limit_mips, app.tmpl_limit_mips[:, s, None]),
        request_mips=put(inst.request_mips, need_mips[:, None]),
        ram=put(inst.ram, need_ram[:, None]),
        limit_ram=put(inst.limit_ram, app.tmpl_limit_ram[:, s, None]),
        bw=put(inst.bw, app.tmpl_bw[:, s, None]),
        util_ema=put(inst.util_ema, 0.5))
    at_vm = do[:, None] & _onehot(vms.mips.shape[1], vm)
    vms = vms._replace(
        mips_used=torch.where(at_vm, vms.mips_used + need_mips[:, None],
                              vms.mips_used),
        ram_used=torch.where(at_vm, vms.ram_used + need_ram[:, None],
                             vms.ram_used))
    Rm = sched.inst_of_rank.shape[2]
    rank = sched.svc_replicas[:, s]
    cell = do[:, None] & _onehot(Rm, rank)
    iof = sched.inst_of_rank.clone()
    iof[:, s] = torch.where(cell, slot.to(i32)[:, None], iof[:, s])
    reps = sched.svc_replicas.clone()
    reps[:, s] = torch.where(do, torch.clamp_max(rank + 1, Rm), rank)
    counters = state.counters._replace(
        scale_out=state.counters.scale_out + do.to(i32))
    return state._replace(
        instances=instances, vms=vms,
        sched=sched._replace(inst_of_rank=iof, svc_replicas=reps),
        counters=counters)


def _scale_in(state: SimState, s: int, want: torch.Tensor) -> SimState:
    """Drain the newest ON replica; the slot frees once its queue empties.
    When the newest ON replica is not the newest rank, the last rank's
    entry moves into the vacated rank.  Rank 0 is never drained."""
    sched, inst = state.sched, state.instances
    Rm = sched.inst_of_rank.shape[2]
    I = inst.status.shape[1]
    idx = torch.arange(Rm, device=inst.status.device)
    slots = sched.inst_of_rank[:, s]                          # [B, Rm]
    nrep = sched.svc_replicas[:, s]                           # [B]
    on = ((idx < nrep[:, None]) & (slots >= 0)
          & (take(inst.status, torch.clamp_min(slots, 0)) == INST_ON))
    any_on = on.any(dim=1)
    rank = torch.where(any_on,
                       Rm - 1 - torch.argmax(on.flip(1).to(i32), dim=1), -1)
    slot = at(slots, torch.clamp_min(rank, 0))
    ok = want & any_on & (rank >= 1)

    status = torch.where(ok[:, None] & _onehot(I, slot), INST_DRAIN,
                         inst.status)
    last = torch.clamp(nrep - 1, 0, Rm - 1)
    row = torch.where(ok[:, None] & (idx == rank[:, None]),
                      torch.where(rank == last, -1, at(slots, last))[:, None],
                      slots)
    row = torch.where(ok[:, None] & (idx == last[:, None]), -1, row)
    iof = sched.inst_of_rank.clone()
    iof[:, s] = row
    reps = sched.svc_replicas.clone()
    reps[:, s] = torch.where(ok, torch.clamp_min(nrep - 1, 0), nrep)
    counters = state.counters._replace(
        scale_in=state.counters.scale_in + ok.to(i32))
    return state._replace(
        instances=inst._replace(status=status),
        sched=sched._replace(inst_of_rank=iof, svc_replicas=reps),
        counters=counters)


# ===========================================================================
# Vertical scaling (Algorithm 5) — vectorized with per-VM fair-share clamp
# ===========================================================================

def vertical(state: SimState, app: AppStatic, caps: SimCaps,
             dyn: DynParams) -> SimState:
    inst, vms = state.instances, state.vms
    B, V = vms.mips.shape
    on = inst.status == INST_ON

    want_up = on & (inst.util_ema > dyn.vs_util_hi[:, None]) & \
        (inst.mips < inst.limit_mips)
    want_down = on & (inst.util_ema < dyn.vs_util_lo[:, None]) & \
        (inst.mips > inst.request_mips)
    target = torch.where(
        want_up, torch.minimum(inst.mips * dyn.vs_up_factor[:, None],
                               inst.limit_mips),
        torch.where(want_down,
                    torch.maximum(inst.mips * dyn.vs_down_factor[:, None],
                                  inst.request_mips),
                    inst.mips))
    delta = target - inst.mips
    dec = torch.clamp_max(delta, 0.0)
    inc = torch.clamp_min(delta, 0.0)

    zv = torch.zeros((B, V), dtype=f32, device=on.device)
    vm_ok = inst.vm >= 0
    dec_per_vm = add_drop(zv, inst.vm, dec, vm_ok)
    inc_per_vm = add_drop(zv, inst.vm, inc, vm_ok)
    # Alg 5: release first, then grant the new requests, scaled down per
    # VM when the combined asks exceed head-room.
    headroom = vms.mips - (vms.mips_used + dec_per_vm)
    grant = torch.clamp(headroom / torch.clamp_min(inc_per_vm, 1e-9),
                        0.0, 1.0)
    vm_idx = torch.where(vm_ok, inst.vm, V)
    grant_i = take(grant, torch.clamp_max(vm_idx, V - 1))
    inc_granted = inc * grant_i

    new_mips = rnd.fma32(inc, grant_i, inst.mips + dec)
    applied = dec + inc_granted
    vms = vms._replace(mips_used=vms.mips_used
                       + add_drop(zv, inst.vm, applied, vm_ok))
    counters = state.counters._replace(
        scale_up=state.counters.scale_up
        + torch.sum(want_up & (inc_granted > 0), dim=1, dtype=i32),
        scale_down=state.counters.scale_down
        + torch.sum(want_down, dim=1, dtype=i32))
    return state._replace(
        instances=inst._replace(mips=new_mips), vms=vms, counters=counters)


# ===========================================================================

@solo_as_batch("state")
def scaling_event(state: SimState, app: AppStatic, caps: SimCaps,
                  params: SimParams, dyn: DynParams) -> SimState:
    """Dispatch to the configured policy (paper §6.4: NS / HS / VS)."""
    if params.scaling_policy == policies.SCALE_NONE:
        return state
    if params.scaling_policy == policies.SCALE_HORIZONTAL:
        return horizontal(state, app, caps, dyn, params)
    if params.scaling_policy == policies.SCALE_VERTICAL:
        return vertical(state, app, caps, dyn)
    if params.scaling_policy == policies.SCALE_HYBRID:
        state = horizontal(state, app, caps, dyn, params)
        return vertical(state, app, caps, dyn)
    raise ValueError(f"unknown scaling policy {params.scaling_policy}")
