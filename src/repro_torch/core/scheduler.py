"""Cloudlet scheduler phases (paper §4.2) + derivative spawning (§4.1.2),
for both network modes (uniform latency and the fabric) and both fault
modes.

Every tick runs, in order:

  ``gen_spawn``   — new requests fire root cloudlets at API entry services
  ``disruption``  — (chaos mode, core/faults.py) hosts crash and recover,
                    instances die, doomed work fails, retries respawn,
                    circuit breakers and outlier ejection advance
  ``transit``     — (fabric mode, core/network.py) in-flight payloads share
                    host NICs max-min fairly; arrivals join the waiting queue
  ``dispatch``    — waiting→execution transition with load balancing
  ``execute``     — time-shared progress + finish detection + usage history
  ``derive``      — finished cloudlets spawn successors along the DAG
  ``complete``    — requests whose last cloudlet finished get a response

The paper's waiting/execution/finished queues are status masks on the
active cloudlet buffer; the finished queue is folded into per-request and
per-service aggregates.  Spawn waves write the stacked pool with two row
scatters (``scatter_pool``); the execution phase folds progress plus every
finish-side reduction into one op (``cloudlet_finish``: the CUDA kernel on
the card, its plain version on the CPU).

No phase synchronises with the device: no ``.item()``, no boolean-mask
indexing, no ``nonzero``; every shape is static.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import random as rnd
from ..analysis import streams
from ..kernels.cloudlet_step import cloudlet_finish_pool
from . import network as netmod
from . import policies
from .app import AppStatic
from .batch import solo_as_batch
from .pool import (add_drop, assign_free_slots, scatter_pool, segment_rank,
                   segment_sum, set_drop, take, tree_sum)
from .types import (CL_EXEC, CL_FREE, CL_TRANSIT, CL_WAITING, DynParams,
                    INST_DRAIN, INST_FREE, INST_ON, SimCaps, SimParams,
                    SimState)

i32, f32 = torch.int32, torch.float32


def _sum_i32(x: torch.Tensor) -> torch.Tensor:
    """Count along the last axis (per point)."""
    return torch.sum(x, dim=-1, dtype=i32)


def _spawn_length(app: AppStatic, svc: torch.Tensor, rng,
                  dev) -> torch.Tensor:
    """Gaussian cloudlet lengths (MI, at least 1) of a spawn wave's ranks
    (``svc`` [B, K]; a dead rank's -1 reads service 0, its length is
    never written)."""
    s = torch.clamp_min(svc, 0)
    return torch.clamp_min(rnd.normal_fma(
        rng, (svc.shape[1],), take(app.len_std, s), take(app.len_mean, s),
        lone=app.len_std.shape[-1] == 1, device=dev), 1.0)


# ===========================================================================
# Generation: new requests + root cloudlets (paper Alg 1 + "Dispatching")
# ===========================================================================

class GenResult(NamedTuple):
    n_new_requests: torch.Tensor


@solo_as_batch("state", "fired", "api", "wait_proposal")
def gen_spawn(state: SimState, app: AppStatic, caps: SimCaps,
              fired: torch.Tensor, api: torch.Tensor,
              wait_proposal: torch.Tensor, rng: torch.Tensor,
              dyn: DynParams, params: SimParams | None = None,
              net_rng: torch.Tensor | None = None
              ) -> Tuple[SimState, GenResult]:
    """Allocate request slots for fired clients and spawn root cloudlets.

    With ``net_rng`` (fabric mode) each root cloudlet is addressed to a
    replica and enters TRANSIT carrying the API's request payload; the
    client is external, so only the destination's ingress port carries
    it (``src_host = -1``)."""
    req, cl, ctr = state.requests, state.cloudlets, state.counters
    B, R = req.api.shape
    dev = fired.device
    Nc = fired.shape[1]
    K = caps.k_fire if caps.k_fire > 0 else Nc
    K = min(K, Nc)
    E = app.api_entry.shape[2]
    count = req.count[:, None]
    now = state.time[:, None]

    rank = torch.cumsum(fired, 1, dtype=i32) - 1
    # Admission: per-tick budget AND the generator's numLimit (Alg 1).
    in_budget = fired & (rank < K) & (count + rank < dyn.num_limit[:, None])
    slot = count + rank
    has_slot = in_budget & (slot < R)
    n_accept = _sum_i32(has_slot)
    n_pool_drop = _sum_i32(in_budget & ~has_slot)

    # Accepted/pool-dropped clients rest; over-budget clients retry next
    # tick (backpressure); others count down.
    new_wait = torch.where(
        in_budget, wait_proposal,
        torch.where(fired, 0, torch.clamp_min(state.clients.wait - 1, 0)))

    # ---- write accepted requests (a fresh slot still holds its initial
    # values, so only api and arrival are written) -------------------------
    requests = req._replace(
        count=req.count + n_accept,
        api=set_drop(req.api, slot, api, has_slot),
        arrival=set_drop(req.arrival, slot, now, has_slot),
    )

    # ---- root cloudlet descriptors [B, K, E] in rank order --------------
    client_of_rank = set_drop(
        torch.zeros((B, K), dtype=i32, device=dev), rank,
        torch.arange(Nc, dtype=i32, device=dev), has_slot & (rank < K))
    ranks = torch.arange(K, dtype=i32, device=dev)
    r_live = ranks < n_accept[:, None]
    api_r = take(api, client_of_rank)                # [B, K]
    req_slot_r = count + ranks                       # [B, K]

    svc_d = take(app.api_entry, api_r)               # [B, K, E]
    n_ent = take(app.api_n_entry, api_r)             # [B, K]
    valid = (r_live[:, :, None]
             & (torch.arange(E, device=dev) < n_ent[:, :, None])
             & (svc_d >= 0)).reshape(B, -1)
    svc_flat = svc_d.reshape(B, -1)
    req_flat = req_slot_r[:, :, None].expand(B, K, E).reshape(B, -1)

    asg = assign_free_slots(cl.status == CL_FREE, valid)
    Ka = asg.dst.shape[1]
    svc_new = take(svc_flat, asg.src)
    req_new = torch.clamp_max(take(req_flat, asg.src), R - 1)
    chaos = "edge" in cl.layout
    if chaos or net_rng is not None:
        api_new = take(api_r[:, :, None].expand(B, K, E).reshape(B, -1),
                       asg.src)
    # client→entry edge id: after the S·d_max call edges (chaos mode)
    edge_new = app.n_services * app.succ.shape[2] + api_new if chaos else -1
    length = _spawn_length(app, svc_new, rng, dev)

    rr = state.rr
    if net_rng is None:                  # uniform mode
        status_new, inst_new, bytes_new = CL_WAITING, -1, 0.0
    else:                                # fabric mode: address + payload
        k_lb, k_pay = streams.split(net_rng, names=("lb", "payload"))
        tgt, rr = netmod.pick_replicas(svc_new, asg.live, state, caps,
                                       params, k_lb)
        payload = netmod.sample_payload(
            take(app.api_payload_mean, api_new),
            take(app.api_payload_std, api_new),
            k_pay, lone=app.api_payload_std.shape[-1] == 1)
        # no live replica yet: park in the waiting queue (dispatch
        # re-balances); clients are external, so no loopback fast path
        status_new = torch.where(tgt >= 0, CL_TRANSIT, CL_WAITING)
        inst_new = tgt
        bytes_new = torch.where(tgt >= 0, payload, 0.0)

    cloudlets = scatter_pool(
        cl, asg, status=status_new, req=req_new, service=svc_new,
        inst=inst_new, wait_ticks=0, depth=0, src_host=-1, attempt=0,
        edge=edge_new, src_inst=-1, length=length, rem=length,
        arrival=now, start=-1.0, rem_bytes=bytes_new)

    # A request with several entry cloudlets hits its counters repeatedly.
    requests = requests._replace(
        outstanding=add_drop(requests.outstanding, req_new, 1, asg.live),
        spawned=add_drop(requests.spawned, req_new, 1, asg.live))
    counters = ctr._replace(
        spawned=ctr.spawned + asg.n_assigned,
        dropped_cloudlets=ctr.dropped_cloudlets + asg.n_dropped,
        dropped_requests=ctr.dropped_requests + n_pool_drop)
    state = state._replace(
        rr=rr, clients=state.clients._replace(wait=new_wait),
        requests=requests, cloudlets=cloudlets, counters=counters)
    return state, GenResult(n_new_requests=n_accept)


# ===========================================================================
# Dispatch: waiting → execution with load balancing (paper §4.2)
# ===========================================================================

@solo_as_batch("state")
def dispatch(state: SimState, app: AppStatic, caps: SimCaps,
             params: SimParams, dyn: DynParams,
             rng: torch.Tensor, network: bool = False) -> SimState:
    cl, inst, sched = state.cloudlets, state.instances, state.sched
    chaos = params.faults == "chaos"
    B, C = cl.ints.shape[:2]
    I = inst.status.shape[1]
    S = app.n_services
    dev = cl.ints.device
    now = state.time[:, None]

    if network:
        # fabric mode: a waiting cloudlet has already crossed the network
        # (Transit, or the loopback fast path)
        waiting = cl.status == CL_WAITING
    else:
        # an RPC hop traverses the network (load-independent latency)
        # before it may be scheduled
        waiting = (cl.status == CL_WAITING) & \
            ((state.time + 1e-6)[:, None]
             >= cl.arrival + dyn.net_latency[:, None])
    if chaos:
        # dispatch around OPEN-ejected replicas (the identity view when
        # nothing is ejected)
        iof, reps = policies.eject_view(sched, state.fault.inst_eject_until,
                                        state.time)
    else:
        iof, reps = sched.inst_of_rank, sched.svc_replicas
    Rm = iof.shape[2]
    svc = torch.where(waiting, cl.service, 0)
    replicas = take(reps, svc)                              # [B, C]
    has_rep = waiting & (replicas > 0)
    rep_safe = torch.clamp_min(replicas, 1)

    rank = policies.lb_rank(
        params.lb_policy, state.rr, svc, rep_safe,
        torch.arange(C, dtype=i32, device=dev), rng,
        iof, inst.status, inst.n_exec, inst.mips)

    target = take(iof.reshape(B, -1),
                  svc * Rm + torch.clamp_max(rank, caps.max_replicas - 1))
    ok = has_rep & (target >= 0)
    tgt_safe = torch.where(ok, target, 0)
    ok = ok & (take(inst.status, tgt_safe) == INST_ON)

    if network:
        # honour the spawn-time address while that replica is still ON
        # and still serves this service (scale-in/out may have re-bound
        # the slot in flight); else take the fresh decision above
        pre = cl.inst
        pre_safe = torch.clamp_min(pre, 0)
        use_pre = (waiting & (pre >= 0)
                   & (take(inst.status, pre_safe) == INST_ON)
                   & (take(inst.service, pre_safe) == cl.service))
        if chaos:
            # nor a replica ejected while the payload was in flight
            use_pre = use_pre & ~(take(state.fault.inst_eject_until,
                                       pre_safe) > now)
        target = torch.where(use_pre, pre, target)
        ok = ok | use_pre
        tgt_safe = torch.where(ok, target, 0)

    if params.max_concurrent > 0:
        # Space-shared admission: FCFS rank within the target instance
        # must fit in the remaining concurrency budget.
        intra = segment_rank(torch.where(ok, target, I), ok, I + 1)
        cap_left = torch.clamp_min(
            dyn.max_concurrent[:, None] - inst.n_exec, 0)
        admit = ok & (intra < take(cap_left, tgt_safe))
    else:
        admit = ok

    # Admissions per instance maintain the incremental n_exec counter and,
    # folded over the instance table, the round-robin cursors.
    admit_per_inst = segment_sum(admit.to(i32),
                                 torch.where(admit, target, -1), I)
    if network:
        # pre-addressed cloudlets stepped the cursor at spawn already
        lb_admit = admit & ~use_pre
        disp_per_svc = segment_sum(
            segment_sum(lb_admit.to(i32), torch.where(lb_admit, target, -1),
                        I), inst.service, S)
    else:
        disp_per_svc = segment_sum(admit_per_inst, inst.service, S)
    rr = (state.rr + disp_per_svc) % torch.clamp_min(sched.svc_replicas, 1)

    cloudlets = cl.with_cols(
        status=torch.where(admit, CL_EXEC, cl.status),
        inst=torch.where(admit, target, cl.inst),
        start=torch.where(admit & (cl.start < 0), now, cl.start),
        wait_ticks=cl.wait_ticks + (waiting & ~admit).to(i32),
    )
    instances = inst._replace(n_exec=inst.n_exec + admit_per_inst)
    return state._replace(rr=rr, cloudlets=cloudlets, instances=instances)


# ===========================================================================
# Execute: time-shared progress, finish detection, usage history
# ===========================================================================

class FinishInfo(NamedTuple):
    fin: torch.Tensor       # [B, C] bool finished this tick
    tfin: torch.Tensor      # [B, C] f32 sub-tick finish timestamp
    pre_service: torch.Tensor  # [B, C] i32 service ids before slot clearing
    pre_req: torch.Tensor
    pre_depth: torch.Tensor
    pre_inst: torch.Tensor


@solo_as_batch("state")
def execute(state: SimState, app: AppStatic, caps: SimCaps,
            params: SimParams, dyn: DynParams
            ) -> Tuple[SimState, FinishInfo]:
    cl, inst, vms = state.cloudlets, state.instances, state.vms
    B, I = inst.status.shape
    S = app.n_services
    dt = dyn.dt[:, None]

    status_c, rem_c, inst_c = cl.status, cl.rem, cl.inst
    execm = status_c == CL_EXEC

    # n_exec is maintained incrementally (dispatch adds, finishes subtract).
    n_exec = inst.n_exec
    if params.share_policy == policies.SHARE_SRPT:
        w = torch.where(execm, 1.0 / (rem_c + 1.0), 0.0)
        wsum = segment_sum(w, torch.where(execm, inst_c, -1), I)
    else:  # equal time slice: the weight sum IS the execution count
        w = execm.to(f32)
        wsum = n_exec.to(f32)
    inst_safe = torch.where(execm, inst_c, 0)
    # Instances run at their host's CPU speed (1.0 by default: exact).
    mips_eff = inst.mips * take(state.hosts.cpu_scale,
                                torch.clamp_min(inst.host, 0))
    chaos = params.faults == "chaos"
    if chaos:
        # a fail-slow host runs its instances at a fraction of their
        # allocation (the scheduling weights are untouched)
        is_slow = (inst.host >= 0) & (take(state.fault.host_slow,
                                           torch.clamp_min(inst.host, 0)) > 0)
        mips_eff = torch.where(is_slow,
                               mips_eff * dyn.host_slow_factor[:, None],
                               mips_eff)
    rate = torch.where(execm, take(mips_eff, inst_safe) * w
                       / torch.clamp_min(take(wsum, inst_safe), 1e-9), 0.0)

    # --- fused finish reduction: progress + every per-finish aggregate ---
    req = state.requests
    out = cloudlet_finish_pool(cl, rate, state.time, dyn.dt, req.finish,
                               req.critical_len, req.outstanding, n_inst=I)
    fin, tfin = out.fin, out.tfin
    used_mips = out.inst_acc[:, :I, 0]
    fin_per_inst = out.inst_acc[:, :I, 1].to(i32)

    svc_of_inst = inst.service
    util = torch.where(inst.mips > 0,
                       used_mips / torch.clamp_min(inst.mips, 1e-9), 0.0)
    # Usage accounting (paper §5.2): idle floor on every ON instance plus a
    # resize surcharge on vertically-scaled instances.
    on = inst.status == INST_ON
    # (a*x + b*y sums: the reference's compiled program fuses the second
    # product into the add)
    acct_mips = rnd.fma32(
        torch.where(on, inst.mips, 0.0), dyn.idle_mips_frac[:, None],
        used_mips * (1.0 + torch.where(inst.mips > inst.request_mips,
                                       dyn.vs_overhead_frac[:, None], 0.0)))
    a = dyn.util_ema[:, None]
    keep = (1 - dyn.util_ema)[:, None]
    # (the compiled tick fuses the second product into the add; with
    # the Disruption phase in the program, the first)
    util_ema = torch.where(
        inst.status != INST_FREE,
        rnd.fma32(util, a, keep * inst.util_ema) if chaos
        else rnd.fma32(inst.util_ema, keep, a * util), 0.0)
    used_ram = torch.where(
        svc_of_inst >= 0,
        take(app.ram_per_cl, torch.clamp_min(svc_of_inst, 0))
        * n_exec.to(f32), 0.0)

    # --- per-service usage history / node-delay estimates: fold the
    # per-instance statistics into services with one stacked scatter ----
    st = state.svc_stats
    acct_dt = acct_mips * dt
    svc_rows = torch.cat([acct_dt[:, :, None], out.inst_acc[:, :I, 1:5]],
                         dim=2)
    svc_acc = add_drop(
        torch.zeros((B, S, 5), dtype=f32, device=rate.device), svc_of_inst,
        torch.where((svc_of_inst >= 0)[:, :, None], svc_rows, 0.0),
        svc_of_inst >= 0)
    svc_stats = st._replace(
        usage_sum=st.usage_sum + svc_acc[:, :, 0],
        finished=st.finished + svc_acc[:, :, 1].to(i32),
        delay_sum=st.delay_sum + svc_acc[:, :, 2],
        exec_sum=st.exec_sum + svc_acc[:, :, 3],
        wait_sum=st.wait_sum + svc_acc[:, :, 4],
    )

    requests = req._replace(outstanding=out.req_out, finish=out.req_finish,
                            critical_len=out.req_crit)

    info = FinishInfo(fin=fin, tfin=tfin, pre_service=cl.service,
                      pre_req=cl.req, pre_depth=cl.depth, pre_inst=inst_c)

    # --- clear finished slots (the "finished queue" is the aggregates) --
    cloudlets = cl.with_cols(
        status=torch.where(fin, CL_FREE, status_c),
        rem=out.new_rem,
        inst=torch.where(fin, -1, inst_c),
    )

    # --- drained instances release their VM share (HS scale-in) ---------
    n_exec_after = n_exec - fin_per_inst
    drain_done = (inst.status == INST_DRAIN) & (n_exec_after == 0)
    V = vms.mips.shape[1]
    rel_mips = segment_sum(torch.where(drain_done, inst.mips, 0.0),
                           inst.vm, V)
    rel_ram = segment_sum(torch.where(drain_done, inst.ram, 0.0), inst.vm, V)
    vms = vms._replace(mips_used=vms.mips_used - rel_mips,
                       ram_used=vms.ram_used - rel_ram)

    instances = inst._replace(
        status=torch.where(drain_done, INST_FREE, inst.status),
        service=torch.where(drain_done, -1, inst.service),
        vm=torch.where(drain_done, -1, inst.vm),
        host=torch.where(drain_done, -1, inst.host),
        mips=torch.where(drain_done, 0.0, inst.mips),
        ram=torch.where(drain_done, 0.0, inst.ram),
        n_exec=n_exec_after,
        used_mips=used_mips,
        used_ram=used_ram,
        util_ema=torch.where(drain_done, 0.0, util_ema),
        usage_sum=rnd.fma32(acct_mips, dt, inst.usage_sum),  # fused, as ref
        busy_ticks=inst.busy_ticks + (n_exec > 0).to(i32),
    )
    counters = state.counters._replace(
        finished=state.counters.finished + _sum_i32(fin))

    # --- per-edge / per-replica success counts (chaos mode), which the
    # next Disruption pass folds into the breaker and ejection EMAs -------
    fault = state.fault
    if chaos:
        E = fault.edge_succ.shape[1]
        fault = fault._replace(
            edge_succ=fault.edge_succ + segment_sum(
                fin.to(i32), torch.where(fin, cl.col("edge"), -1), E),
            inst_succ=fault.inst_succ + fin_per_inst,
            inst_lat_sum=fault.inst_lat_sum + out.inst_acc[:, :I, 2])
    return state._replace(cloudlets=cloudlets, instances=instances, vms=vms,
                          requests=requests, svc_stats=svc_stats,
                          counters=counters, fault=fault), info


# ===========================================================================
# Derive: finished cloudlets spawn successors (paper §4.1.2 "Derivative")
# ===========================================================================

@solo_as_batch("state")
def derive(state: SimState, app: AppStatic, caps: SimCaps,
           info: FinishInfo, rng: torch.Tensor,
           params: SimParams | None = None,
           net_rng: torch.Tensor | None = None) -> SimState:
    cl, req, ctr = state.cloudlets, state.requests, state.counters
    B, C = cl.ints.shape[:2]
    I = state.instances.status.shape[1]
    S, D = app.succ.shape[1:]
    dev = cl.ints.device

    def per_edge(x):           # [B, C] → [B, C·D], one lane per edge slot
        return x[:, :, None].expand(B, C, D).reshape(B, -1)

    parent_svc = torch.where(info.fin, torch.clamp_min(info.pre_service, 0),
                             0)
    child = take(app.succ, parent_svc)               # [B, C, D]
    valid = (info.fin[:, :, None] & (child >= 0)).reshape(B, -1)
    svc_flat = child.reshape(B, -1)
    req_flat = per_edge(info.pre_req)
    dep_flat = per_edge(info.pre_depth + 1)
    tf_flat = per_edge(info.tfin)
    pin_flat = per_edge(info.pre_inst)

    asg = assign_free_slots(cl.status == CL_FREE, valid, k_static=C)
    Ka = asg.dst.shape[1]
    svc_new = take(svc_flat, asg.src)
    req_new = take(req_flat, asg.src)
    # clamp is a no-op (acyclic graphs cap chains at S-1 hops)
    dep_new = torch.clamp_max(take(dep_flat, asg.src), S - 1)
    tf_new = take(tf_flat, asg.src)
    pin_new = take(pin_flat, asg.src)
    edge_new = -1
    if "edge" in cl.layout or net_rng is not None:
        # edge (row = parent service, column = successor slot)
        edge_new = take(per_edge(parent_svc), asg.src) * D + asg.src % D
    length = _spawn_length(app, svc_new, rng, dev)

    rr = state.rr
    if net_rng is None:                  # uniform mode
        status_new, inst_new = CL_WAITING, -1
        src_host_new, bytes_new = -1, 0.0
    else:                                # fabric mode: address + payload
        k_lb, k_pay = streams.split(net_rng, names=("lb", "payload"))
        tgt, rr = netmod.pick_replicas(svc_new, asg.live, state, caps,
                                       params, k_lb)
        payload = netmod.sample_payload(
            take(app.payload_mean.reshape(B, -1), edge_new),
            take(app.payload_std.reshape(B, -1), edge_new), k_pay,
            lone=S * D == 1)
        host = state.instances.host
        src_host = torch.where(pin_new >= 0,
                               take(host, torch.clamp_min(pin_new, 0)), -1)
        dst_host = torch.where(tgt >= 0, take(host, torch.clamp_min(tgt, 0)),
                               -1)
        # loopback fast path: co-located hops never touch a NIC
        loop = (tgt >= 0) & (src_host >= 0) & (src_host == dst_host)
        in_transit = (tgt >= 0) & ~loop
        status_new = torch.where(in_transit, CL_TRANSIT, CL_WAITING)
        inst_new = tgt
        src_host_new = torch.where(in_transit, src_host, -1)
        bytes_new = torch.where(in_transit, payload, 0.0)

    cloudlets = scatter_pool(
        cl, asg, status=status_new, req=req_new, service=svc_new,
        inst=inst_new, wait_ticks=0, depth=dep_new, src_host=src_host_new,
        attempt=0, edge=edge_new, src_inst=pin_new, length=length,
        rem=length, arrival=tf_new, start=-1.0, rem_bytes=bytes_new)

    # several successors of one parent share a request — intended collisions
    requests = req._replace(
        outstanding=add_drop(req.outstanding, req_new, 1, asg.live),
        spawned=add_drop(req.spawned, req_new, 1, asg.live))

    # Outbound-RPC bandwidth (linear usage model, paper §5.2).
    live_pinst = torch.where(asg.live, pin_new, -1)
    psvc = torch.where(asg.live, torch.clamp_min(
        take(state.instances.service, torch.clamp_min(live_pinst, 0)), 0), 0)
    bw = segment_sum(take(app.bytes_per_rpc, psvc) * asg.live.to(f32),
                     live_pinst, I)
    instances = state.instances._replace(used_bw=bw)

    counters = ctr._replace(
        spawned=ctr.spawned + asg.n_assigned,
        dropped_cloudlets=ctr.dropped_cloudlets + asg.n_dropped)
    return state._replace(rr=rr, cloudlets=cloudlets, requests=requests,
                          instances=instances, counters=counters)


# ===========================================================================
# Complete: close requests whose dependency tree drained (paper §4.3.2)
# ===========================================================================

@solo_as_batch("state")
def complete(state: SimState, dyn: DynParams, faults: bool = False
             ) -> Tuple[SimState, torch.Tensor]:
    req, ctr = state.requests, state.counters
    done = ((req.outstanding == 0) & (req.spawned > 0) & (req.response < 0)
            & (req.arrival >= 0))
    resp = torch.where(done, req.finish - req.arrival, req.response)
    n_done = _sum_i32(done)
    viol = done & (resp * 1000.0 > dyn.slo_ms[:, None])
    if faults:
        # a failed completion is an SLO violation however fast it failed
        failed_done = done & (req.failed > 0)
        viol = viol | failed_done
    counters = ctr._replace(
        completed=ctr.completed + n_done,
        # (in the order of the reference's compiled reduction: under chaos
        # the responses summed in one tick are inexact enough to show it)
        resp_sum=ctr.resp_sum + tree_sum(torch.where(done, resp, 0.0),
                                         dim=1),
        slo_violations=ctr.slo_violations + _sum_i32(viol),
    )
    state = state._replace(requests=req._replace(response=resp),
                           counters=counters)
    if faults:
        # a request whose failed flag is set completes as a failed
        # completion, counted once, at its one done tick
        state = state._replace(fstats=state.fstats._replace(
            failed_requests=state.fstats.failed_requests
            + _sum_i32(failed_done)))
    return state, n_done
