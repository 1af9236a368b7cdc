"""Network fabric (``network="fabric"``, DESIGN.md §6): host NICs, payload
transit and max-min fair contention, as the reference's
``repro.core.network``, in both fault modes.

* every instance is attached to a host NIC (``Instances.host``);
* every RPC carries a Gaussian payload sampled from the edge it traverses
  and is addressed to a replica at spawn time (``pick_replicas``);
* in-flight transfers sit in the stacked pool under ``CL_TRANSIT`` with
  ``rem_bytes``/``src_host`` columns; each tick the water-filling kernel
  (``kernels/link_share``) splits every egress and ingress port among its
  transfers before ``dispatch`` admits the arrivals;
* intra-host hops take the loopback fast path (straight to the waiting
  queue, no NIC);
* under ``faults="chaos"`` a degraded NIC runs at its brownout factor
  (``FaultState.nic_factor``, which may be 0), a transfer across a cut
  zone pair leaves the water-fill (it stalls, nothing crashes), and
  spawn-time addressing skips ejected replicas (``policies.eject_view``).

No function here synchronises with the device.  The statistics
(``NetStats``) are float sums over the pool, taken in the reference's
order, which depends on the shape: while the one-hot ``[C, H]`` matrix
fits ``ONE_HOT_BUDGET`` the per-host sums are compiled reductions (the
32-wide tree of ``pool.tree_sum``), past it ordered scatters in lane
order (``segment_sum``); ``transit_sum`` is always a compiled reduction.

Where the reference's compiled simulation tick contracts a multiply-add,
the port fuses it too (``random.fma32``): the payload's ``mean +
std·noise``, ``busy + util·dt`` and the water-fill's port drain
``rem - λ·n``.  The transfers' ``rem - rate·dt`` it rounds as two
operations, and so does the port.  (The reference's Transit phase jitted
on its own rounds the port drain twice: which sites XLA contracts
depends on the program around them, and the tick is the one whose
results the simulator reports.)
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import random as rnd
from ..kernels.link_share import link_share
from . import policies
from .app import AppStatic
from .batch import solo_as_batch
from .pool import segment_rank, segment_sum, take, tree_sum
from .types import (CL_TRANSIT, CL_WAITING, DynParams, INST_ON, SimCaps,
                    SimParams, SimState)

i32, f32 = torch.int32, torch.float32

# Payload floor (MB): a transfer carries at least one packet.
MIN_PAYLOAD_MB = 1e-6

# NIC capacities are configured in Mbit/s; transfers account in MByte.
MBIT_PER_S_TO_MBYTE_PER_S = 1.0 / 8.0

# The reference takes the per-host sums as one-hot [C, H] reductions while
# they fit this element budget, as ordered scatters past it.
ONE_HOT_BUDGET = 1 << 22


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx]`` per point with the index clamped into range, as
    the reference's gathers clamp."""
    return take(table, idx.clamp(0, table.shape[1] - 1))


@solo_as_batch("state", "svc", "live")
def pick_replicas(svc: torch.Tensor, live: torch.Tensor, state: SimState,
                  caps: SimCaps, params: SimParams, rng: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Client-side load balancing at spawn time: each new RPC of the wave
    is addressed to a replica of its target service.  Round-robin ranks
    FCFS within the wave.  Returns ([B, K] target instance ids, -1 where
    no live replica exists; the updated round-robin cursors)."""
    sched, inst = state.sched, state.instances
    B, S = sched.svc_replicas.shape
    if params.faults == "chaos":
        iof, reps = policies.eject_view(sched, state.fault.inst_eject_until,
                                        state.time)
    else:
        iof, reps = sched.inst_of_rank, sched.svc_replicas
    Rm = iof.shape[2]
    svc_safe = torch.where(live, svc, 0)
    replicas = take(reps, svc_safe)
    rep_safe = torch.clamp_min(replicas, 1)

    rr_policy = params.lb_policy == policies.LB_ROUND_ROBIN
    offset = (segment_rank(svc_safe, live, S).to(i32) if rr_policy
              else torch.zeros(svc.shape, dtype=i32, device=svc.device))
    rank = policies.lb_rank(
        params.lb_policy, state.rr, svc_safe, rep_safe, offset, rng,
        iof, inst.status, inst.n_exec, inst.mips)

    target = take(iof.reshape(B, -1), svc_safe * Rm
                  + torch.clamp_max(rank, caps.max_replicas - 1))
    ok = live & (replicas > 0) & (target >= 0)
    tgt_safe = torch.where(ok, target, 0)
    ok = ok & (take(inst.status, tgt_safe) == INST_ON)

    new_rr = state.rr
    if rr_policy:
        # only addressed spawns step the cursor: a parked one is served
        # (and counted) by dispatch's own balancing
        n_ok = segment_sum(ok.to(i32), torch.where(ok, svc, -1), S)
        new_rr = (state.rr + n_ok) % torch.clamp_min(sched.svc_replicas, 1)
    return torch.where(ok, target, -1), new_rr


def sample_payload(mean: torch.Tensor, std: torch.Tensor,
                   rng: torch.Tensor, lone: bool = False) -> torch.Tensor:
    """Gaussian per-RPC payload (MB), floored at MIN_PAYLOAD_MB; ``mean +
    std·noise`` is one fused multiply-add, as in the reference's compiled
    program (``lone``: std comes from a one-entry table, see
    ``random.normal_fma``).  ``mean``/``std`` are ``[n]`` or ``[B, n]``:
    the noise is one draw of ``n``, shared by the points."""
    return torch.clamp_min(
        rnd.normal_fma(rng, tuple(mean.shape[-1:]), std, mean, lone,
                       device=mean.device), MIN_PAYLOAD_MB)


def inflight_mb(cl) -> torch.Tensor:
    """Σ remaining MB of the transfers on the fabric (per point of a
    batched pool)."""
    x = torch.where(cl.status == CL_TRANSIT, cl.rem_bytes, 0.0)
    return tree_sum(x, dim=x.dim() - 1)


@solo_as_batch("state")
def transit(state: SimState, caps: SimCaps, params: SimParams,
            dyn: DynParams, app: AppStatic | None = None) -> SimState:
    """One fabric tick: water-fill every NIC port, advance the transfers,
    deliver the arrivals into the waiting queue (Transit phase)."""
    cl, inst, net = state.cloudlets, state.instances, state.net
    B, H = state.hosts.egress_scale.shape
    NB = net.hist.shape[1]
    dt = dyn.dt[:, None]
    time = state.time[:, None]

    status = cl.status
    active = status == CL_TRANSIT
    dst = torch.where(active & (cl.inst >= 0), _take(inst.host, cl.inst), -1)
    src = cl.src_host
    cap_e = (state.hosts.egress_scale * dyn.nic_egress_mbps[:, None]
             * MBIT_PER_S_TO_MBYTE_PER_S)
    cap_i = (state.hosts.ingress_scale * dyn.nic_ingress_mbps[:, None]
             * MBIT_PER_S_TO_MBYTE_PER_S)
    flowing = active & (dst >= 0)
    if params.faults == "chaos":
        nic = state.fault.nic_factor
        cap_e = cap_e * nic
        cap_i = cap_i * nic
        if app is not None:
            # a transfer across a cut zone pair leaves the water-fill
            # (client ingress, src = -1, is never cut)
            hz, cut = app.host_zone, state.fault.zone_cut
            zs, zd = _take(hz, src), _take(hz, dst)
            cut = ((src >= 0) & (dst >= 0)
                   & (take(cut.reshape(B, -1), zs * H + zd) > 0))
            flowing = flowing & ~cut

    rate = link_share(src.contiguous(), dst.contiguous(), flowing, cap_e,
                      cap_i, iters=params.waterfill_iters)

    if params.egress_shaping:
        # an instance's concurrent transfers share its own Instances.bw
        # allowance on top of the port-level water-fill (only lowers rates)
        I = inst.status.shape[1]
        sin = cl.src_inst
        shaped = active & (sin >= 0)
        n_from = segment_sum(shaped.to(f32), torch.where(shaped, sin, -1), I)
        share = (_take(inst.bw, sin) * MBIT_PER_S_TO_MBYTE_PER_S
                 / torch.clamp_min(_take(n_from, sin), 1.0))
        rate = torch.where(shaped, torch.minimum(rate, share), rate)

    rem = cl.rem_bytes
    prog = rate * dt
    # a transfer whose target vanished has no NIC to arrive at: deliver it
    # now and let dispatch re-balance it
    stranded = active & (dst < 0)
    arrived = (active & (rem <= prog) & (rate > 0)) | stranded
    t_arr = torch.clamp(time + rem / torch.clamp_min(rate, 1e-9),
                        time, time + dt)
    t_arr = torch.where(stranded, time, t_arr)
    moved = torch.where(active, torch.minimum(prog, rem), 0.0)
    new_rem = torch.where(arrived, 0.0, torch.where(
        active, torch.clamp_min(rem - prog, 0.0), rem))

    cloudlets = cl.with_cols(status=torch.where(arrived, CL_WAITING, status),
                             rem_bytes=new_rem)

    # --- transit-time statistics (sub-tick arrival vs spawn time);
    # stranded deliveries are not fabric crossings ------------------------
    real = arrived & ~stranded
    dur = torch.where(real, t_arr - cl.arrival, 0.0)

    # --- per-host accounting (goodput: bytes moved / port capacity), the
    # sums in the reference's order -----------------------------------------
    C = src.shape[1]
    if C * H <= ONE_HOT_BUDGET:
        hosts = torch.arange(H, dtype=i32, device=src.device)
        on_e = (active & (src >= 0))[:, :, None] & (src[:, :, None] == hosts)
        on_i = (active & (dst >= 0))[:, :, None] & (dst[:, :, None] == hosts)
        mv = moved[:, :, None]
        sums = tree_sum(torch.cat([torch.where(on_e, mv, 0.0),
                                   torch.where(on_i, mv, 0.0),
                                   dur[:, :, None]], dim=2), dim=1)
        out_mb, in_mb, dur_sum = (sums[:, :H], sums[:, H:2 * H],
                                  sums[:, 2 * H])
    else:
        out_mb = segment_sum(moved, torch.where(active, src, -1), H)
        in_mb = segment_sum(moved, torch.where(active, dst, -1), H)
        dur_sum = tree_sum(dur, dim=1)
    util_e = out_mb / torch.clamp_min(cap_e * dt, 1e-9)
    util_i = in_mb / torch.clamp_min(cap_i * dt, 1e-9)

    bucket = torch.clamp(rnd.div32(dur, params.net_hist_bin_s).to(i32),
                         0, NB - 1)
    hist = net.hist + segment_sum(torch.ones_like(bucket),
                                  torch.where(real, bucket, -1), NB)
    net = net._replace(
        bytes_out=net.bytes_out + out_mb,
        bytes_in=net.bytes_in + in_mb,
        egress_busy=rnd.fma32(util_e, dt, net.egress_busy),
        ingress_busy=rnd.fma32(util_i, dt, net.ingress_busy),
        transits=net.transits + torch.sum(real, dim=1, dtype=i32),
        transit_sum=net.transit_sum + dur_sum,
        hist=hist)
    return state._replace(cloudlets=cloudlets, net=net)
