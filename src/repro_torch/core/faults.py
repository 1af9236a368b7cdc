"""Fault injection and resilience: the Disruption tick phase of chaos mode
(``faults="chaos"``, DESIGN.md §7/§7.1), as the reference's
``repro.core.faults``.

The phase runs between Generation and Transit and, in one pass of masked
tensor operations over the batch:

* samples the fault schedule: host crashes and recoveries (MTBF/MTTR),
  fail-slow episodes, NIC brownouts with a severity held per episode,
  zone-correlated crash and slow draws, zone-pair partitions;
* moves instances (killed, restarted, a draining pod on a dead host
  freed) and fails doomed in-flight work: work on dead instances,
  attempts past their timeout, transfers from a dead host, and new calls
  on an open breaker (fail-fast);
* respawns the retries within their budget through the spawn path
  (``pool.assign_free_slots``/``scatter_pool``; in fabric mode they are
  re-addressed and carry a new payload), and fails the rest for good,
  marking their requests failed;
* advances the per-edge circuit breakers and the per-replica outlier
  ejection (with the last-replica guard).

Every rate is a ``DynParams`` value, so a sweep varies chaos without a new
capture.  Per-tick probabilities are ``1 - exp(-dt·rate)`` with XLA's own
``exp`` (``random.exp``).  Scatters flatten the batch and reductions run
per point (``core/pool.py``); nothing here synchronises with the device.
"""
from __future__ import annotations

import torch

from .. import random as rnd
from ..analysis import streams
from ..obs import slo as slomod
from . import network as netmod
from .app import AppStatic
from .batch import solo_as_batch
from .pool import (add_drop, assign_free_slots, scatter_pool, segment_rank,
                   segment_sum, take)
from .scheduler import _spawn_length
from .types import (CL_EXEC, CL_FREE, CL_TRANSIT, CL_WAITING, DynParams,
                    INST_DOWN, INST_DRAIN, INST_FREE, INST_ON, SimCaps,
                    SimParams, SimState)

i32, f32 = torch.int32, torch.float32

# The per-tick probabilities of the schedule: (DynParams field, kind), a
# rate per second or a mean time (MTBF/MTTR; inf disables the transition).
_RATES = (("zone_fault_rate", "rate"), ("zone_slow_rate", "rate"),
          ("host_mtbf_s", "mean"), ("host_mttr_s", "mean"),
          ("host_slow_mtbf_s", "mean"), ("host_slow_mttr_s", "mean"),
          ("nic_degrade_rate", "rate"), ("nic_mttr_s", "mean"),
          ("zone_partition_rate", "rate"), ("zone_partition_mttr_s", "mean"),
          ("inst_kill_rate", "rate"), ("inst_mttr_s", "mean"))


# The phase's stages in order, as the reference's profiler cuts them: a
# probe passed to ``disruption`` is called with ``"Disruption/<stage>"``
# as each stage after the first begins, and with ``"Disruption/ejection"``
# before the outlier ejection that ends the phase (``obs/profile.py``).
DISRUPTION_STAGES = ("schedule", "doom", "respawn", "breaker")


def tick_probabilities(dyn: DynParams) -> dict:
    """Each schedule rate's per-tick event probability, ``[B, 1]`` per
    point: ``1 - exp(-dt·rate)``, or ``1 - exp(-dt / max(mean, 1e-9))``
    for a mean time, all through one ``random.exp``."""
    neg_dt = -dyn.dt
    args = [neg_dt * getattr(dyn, f) if kind == "rate"
            else rnd.div32(neg_dt, torch.clamp_min(getattr(dyn, f), 1e-9))
            for f, kind in _RATES]
    p = 1.0 - rnd.exp(torch.stack(args, dim=1))
    return {f: p[:, j:j + 1] for j, (f, _) in enumerate(_RATES)}


def edge_payload_tables(app: AppStatic):
    """Per-edge payload mean and std aligned with the cloudlet ``edge`` id:
    the call edges (``[S·d_max]``, row-major), then the client→entry edges
    (``[A]``); ``[B, E]`` for a batched app."""
    lead = app.payload_mean.shape[:-2]
    flat = lambda t: t.reshape(lead + (-1,))
    return (torch.cat([flat(app.payload_mean), app.api_payload_mean], -1),
            torch.cat([flat(app.payload_std), app.api_payload_std], -1))


def check_tables(state: SimState, app: AppStatic) -> None:
    """The guards of the per-edge and per-host tables (shapes only, no
    device work): the edge tables must cover every edge id the app emits,
    and the host→zone table every host."""
    E = state.fault.edge_err_ema.shape[-1]
    H = state.fault.host_up.shape[-1]
    if app.n_edges > E:
        raise ValueError(
            f"fault edge tables undersized: app emits edge ids up to "
            f"{app.n_edges - 1} but FaultState holds {E} edges — pass "
            f"app=app (or n_edges/n_apis) to zeros_state")
    if app.n_hosts != H:
        raise ValueError(
            f"host_zone table must cover every host: app maps "
            f"{app.n_hosts} hosts but the cluster has {H} — pass n_hosts "
            f"(or host_zone) to build_app")


@solo_as_batch("state")
def disruption(state: SimState, app: AppStatic, caps: SimCaps,
               params: SimParams, dyn: DynParams, rng, rng_len,
               rng_net=None, probe=None) -> SimState:
    """One Disruption tick (see the module docstring); ``rng`` is the
    tick's ``faults`` stream, ``rng_len`` its ``retry_len`` stream and
    ``rng_net`` (fabric mode) its ``retry_net`` stream.  ``probe``, when
    given, marks the stages (``DISRUPTION_STAGES``)."""
    mark = probe or (lambda name: None)
    check_tables(state, app)
    cl, inst, req = state.cloudlets, state.instances, state.requests
    fs, fst = state.fault, state.fstats
    B, C = cl.ints.shape[:2]
    H = fs.host_up.shape[1]
    I = inst.status.shape[1]
    E = fs.edge_err_ema.shape[1]
    R = req.api.shape[1]
    V = state.vms.mips.shape[1]
    S = state.sched.svc_replicas.shape[1]
    dev = cl.ints.device
    t = state.time[:, None]
    dt = dyn.dt[:, None]
    p = tick_probabilities(dyn)

    k_host, k_inst, k_nic = streams.split(
        rng, 3, names=("host", "inst", "nic"))
    # the gray-failure streams fold off the tick key, as the reference's
    k_slow, k_sev, k_zone, k_zslow, k_part = streams.split(
        streams.fold_in(rng, 1, name="gray"), 5,
        names=("slow", "sev", "zone", "zslow", "part"))
    # the schedule's eight draws, hashed in one pass (each its own bits)
    u_zone, u_zslow, u_h, u_sl, u_n, u_sev, u_p, u_i = rnd.uniform_many(
        [(k_zone, (H,)), (k_zslow, (H,)), (k_host, (H,)), (k_slow, (H,)),
         (k_nic, (H,)), (k_sev, (H,)), (k_part, (H, H)), (k_inst, (I,))],
        device=dev)

    # --- zone draws: one per zone slot, masked to the zones in use -------
    hz = app.host_zone                                         # [B, H]
    zones = torch.arange(H, dtype=i32, device=dev)
    zone_used = (hz[:, :, None] == zones).any(dim=1)           # [B, H]
    zone_down = zone_used & (u_zone < p["zone_fault_rate"])
    zone_slow = zone_used & (u_zslow < p["zone_slow_rate"])

    # --- host crash / recovery ------------------------------------------
    up = fs.host_up > 0
    crash = up & ((u_h < p["host_mtbf_s"]) | take(zone_down, hz))
    recover = ~up & (u_h < p["host_mttr_s"])
    up_new = (up & ~crash) | recover

    # --- fail-slow episodes (a crashing host restarts healthy) ------------
    slow = fs.host_slow > 0
    slow_start = ~slow & up_new & ((u_sl < p["host_slow_mtbf_s"])
                                   | take(zone_slow, hz))
    slow_end = slow & (u_sl < p["host_slow_mttr_s"])
    slow_new = ((slow & ~slow_end) | slow_start) & up_new

    # --- NIC brownouts, the severity drawn once per episode ----------------
    ok = fs.nic_ok > 0
    degrade = ok & (u_n < p["nic_degrade_rate"])
    fix = ~ok & (u_n < p["nic_mttr_s"])
    ok_new = (ok & ~degrade) | fix
    sev = torch.clamp(rnd.fma32(
        (2.0 * u_sev - 1.0).expand(B, H),
        dyn.nic_degrade_spread[:, None], dyn.nic_degrade_factor[:, None]),
        0.0, 1.0)
    nic_factor = torch.where(degrade, sev,
                             torch.where(fix, 1.0, fs.nic_factor))

    # --- zone-pair partitions: the strict upper triangle, mirrored --------
    cut = fs.zone_cut > 0
    upper = torch.triu(torch.ones((H, H), dtype=torch.bool, device=dev), 1)
    pair_used = upper & zone_used[:, :, None] & zone_used[:, None, :]
    p_open = pair_used & ~cut & (u_p < p["zone_partition_rate"][:, :, None])
    p_heal = cut & upper & (u_p < p["zone_partition_mttr_s"][:, :, None])
    cut_upper = (cut & upper & ~p_heal) | p_open
    zone_cut_new = (cut_upper | cut_upper.transpose(1, 2)).to(i32)

    # --- instance transitions and VM release -----------------------------
    mark("Disruption/doom")
    host_down = (inst.host >= 0) & ~take(up_new,
                                         torch.clamp_min(inst.host, 0))
    on = inst.status == INST_ON
    killed = on & (u_i < p["inst_kill_rate"])
    goes_down = on & (host_down | killed)
    # a draining pod on a crashed node is gone: free the slot and its share
    drain_dies = (inst.status == INST_DRAIN) & host_down
    restarts = ((inst.status == INST_DOWN) & ~host_down
                & (u_i < p["inst_mttr_s"]))
    status_new = torch.where(goes_down, INST_DOWN, inst.status)
    status_new = torch.where(drain_dies, INST_FREE, status_new)
    status_new = torch.where(restarts, INST_ON, status_new)
    dead_now = goes_down | drain_dies

    rel_m = segment_sum(torch.where(drain_dies, inst.mips, 0.0), inst.vm, V)
    rel_r = segment_sum(torch.where(drain_dies, inst.ram, 0.0), inst.vm, V)
    vms = state.vms._replace(mips_used=state.vms.mips_used - rel_m,
                             ram_used=state.vms.ram_used - rel_r)

    # --- doomed in-flight work -------------------------------------------
    status, c_inst, edge = cl.status, cl.inst, cl.col("edge")
    arrival = cl.arrival
    active = status != CL_FREE
    ci = torch.clamp_min(c_inst, 0)
    inst_dead = (c_inst >= 0) & (take(dead_now, ci)
                                 | (take(status_new, ci) == INST_DOWN))
    e_safe = torch.clamp_min(edge, 0)
    e_tmo = take(app.edge_timeout, e_safe)
    tmo = torch.where(e_tmo >= 0, e_tmo, dyn.retry_timeout_s[:, None])
    doomed = inst_dead | ((t - arrival) > tmo)
    if "src_host" in cl.layout:
        # fabric mode: a transfer whose source host died loses its payload
        src = cl.src_host
        doomed = doomed | ((status == CL_TRANSIT) & (src >= 0)
                           & ~take(up_new, torch.clamp_min(src, 0)))
    organic = active & doomed

    # breaker masks; an open breaker fails calls spawned since the last
    # pass fast, it never cancels established work
    open_m = fs.edge_open_until > t
    half_m = (fs.edge_open_until > 0) & ~open_m
    cl_open = (edge >= 0) & take(open_m, e_safe)
    fresh = arrival >= t - dt
    failfast = active & ~organic & cl_open & fresh & (status != CL_EXEC)

    failed = organic | failfast
    e_retry = take(app.edge_retry, e_safe)
    budget = torch.where(e_retry >= 0, e_retry, dyn.retry_budget[:, None])
    can_retry = organic & (cl.col("attempt") < budget) & ~cl_open
    # the per-tick retry admission budget (static); failures past it fail
    # for good
    K_cap = caps.k_retry if caps.k_retry > 0 else min(C, max(256, C // 8))
    K_cap = min(K_cap, C)
    retry_rank = torch.cumsum(can_retry, 1, dtype=i32) - 1
    can_retry = can_retry & (retry_rank < K_cap)
    permanent = failed & ~can_retry

    # n_exec: failures on live instances decrement, dead ones reset to 0
    exec_failed = failed & (status == CL_EXEC)
    dec = segment_sum(exec_failed.to(i32),
                      torch.where(exec_failed, c_inst, -1), I)
    n_exec_new = torch.where((status_new == INST_DOWN) | drain_dies, 0,
                             inst.n_exec - dec)
    instances = inst._replace(
        status=status_new,
        service=torch.where(drain_dies, -1, inst.service),
        vm=torch.where(drain_dies, -1, inst.vm),
        host=torch.where(drain_dies, -1, inst.host),
        mips=torch.where(drain_dies, 0.0, inst.mips),
        ram=torch.where(drain_dies, 0.0, inst.ram),
        n_exec=n_exec_new,
        util_ema=torch.where(goes_down | drain_dies, 0.0,
                             torch.where(restarts, 0.5, inst.util_ema)),
    )

    # --- permanent failures reach the owning request: outstanding drops,
    # the failed flag is set and finish is raised to the failure time ------
    hits = add_drop(torch.zeros((B, R), dtype=i32, device=dev), cl.req, 1,
                    permanent & (cl.req >= 0))
    hit = hits > 0
    requests = req._replace(
        outstanding=req.outstanding - hits,
        failed=torch.where(hit, 1, req.failed).to(torch.uint8),
        finish=torch.where(hit, torch.maximum(req.finish, t), req.finish))

    cl2 = cl.with_cols(status=torch.where(failed, CL_FREE, status),
                       inst=torch.where(failed, -1, c_inst))
    state = state._replace(cloudlets=cl2, instances=instances, vms=vms,
                           requests=requests)

    # --- respawn the retries (each one's own slot was just freed and the
    # wave is capped at K_cap, so no retry is dropped) ---------------------
    mark("Disruption/respawn")
    asg = assign_free_slots(cl2.status == CL_FREE, can_retry, k_static=K_cap)
    svc_new = take(cl.service, asg.src)
    req_new = take(cl.req, asg.src)
    edge_new = take(edge, asg.src)
    att_new = take(cl.col("attempt"), asg.src) + 1
    dep_new = take(cl.depth, asg.src)
    sin_new = take(cl.col("src_inst"), asg.src)
    length = _spawn_length(app, svc_new, rng_len, dev)

    rr = state.rr
    if rng_net is None:                  # uniform mode
        status_sp, inst_sp, src_host_sp, bytes_sp = CL_WAITING, -1, -1, 0.0
    else:                                # fabric mode: re-address + payload
        k_lb, k_pay = streams.split(rng_net, names=("lb", "payload"))
        tgt, rr = netmod.pick_replicas(svc_new, asg.live, state, caps,
                                       params, k_lb)
        pay_mean, pay_std = edge_payload_tables(app)
        eg = torch.clamp_min(edge_new, 0)
        payload = netmod.sample_payload(take(pay_mean, eg),
                                        take(pay_std, eg), k_pay)
        # the source host is re-derived from the caller (it may have
        # migrated)
        host = instances.host
        sh = torch.where(sin_new >= 0,
                         take(host, torch.clamp_min(sin_new, 0)), -1)
        dh = torch.where(tgt >= 0, take(host, torch.clamp_min(tgt, 0)), -1)
        loop = (tgt >= 0) & (sh >= 0) & (sh == dh)
        in_transit = (tgt >= 0) & ~loop
        status_sp = torch.where(in_transit, CL_TRANSIT, CL_WAITING)
        inst_sp = tgt
        src_host_sp = torch.where(in_transit, sh, -1)
        bytes_sp = torch.where(in_transit, payload, 0.0)

    cloudlets = scatter_pool(
        cl2, asg, status=status_sp, req=req_new, service=svc_new,
        inst=inst_sp, wait_ticks=0, depth=dep_new, src_host=src_host_sp,
        attempt=att_new, edge=edge_new, src_inst=sin_new, length=length,
        rem=length, arrival=t, start=-1.0, rem_bytes=bytes_sp)
    requests = requests._replace(
        spawned=add_drop(requests.spawned, req_new, 1, asg.live))

    # --- per-edge circuit breakers (fail-fast failures stay out of the
    # EMA: they are the breaker's own doing) --------------------------------
    mark("Disruption/breaker")
    alpha = dyn.cb_alpha[:, None]
    org_e = segment_sum(organic.to(i32), torch.where(organic, edge, -1), E)
    succ_e = fs.edge_succ
    n_e = org_e + succ_e
    err = org_e.to(f32) / torch.clamp_min(n_e.to(f32), 1.0)
    traffic = n_e > 0
    ema = torch.where(traffic,
                      rnd.fma32(alpha, err - fs.edge_err_ema,
                                fs.edge_err_ema),
                      fs.edge_err_ema)
    closed_m = fs.edge_open_until <= 0
    trip = closed_m & traffic & (ema > dyn.cb_err_thresh[:, None])
    reopen = half_m & (org_e > 0)
    close = half_m & (org_e == 0) & (succ_e > 0)
    open_until = torch.where(trip | reopen, t + dyn.cb_cooldown_s[:, None],
                             torch.where(close, 0.0, fs.edge_open_until))
    ema = torch.where(close, 0.0, ema)

    # --- per-replica outlier ejection ------------------------------------
    mark("Disruption/ejection")
    org_i = segment_sum(organic.to(i32), torch.where(organic, c_inst, -1), I)
    succ_i = fs.inst_succ
    n_i = org_i + succ_i
    traffic_i = n_i > 0
    err_i = org_i.to(f32) / torch.clamp_min(n_i.to(f32), 1.0)
    iema = torch.where(traffic_i,
                       rnd.fma32(alpha, err_i - fs.inst_err_ema,
                                 fs.inst_err_ema),
                       fs.inst_err_ema)
    mean_lat = fs.inst_lat_sum / torch.clamp_min(succ_i.to(f32), 1.0)
    lema = torch.where(succ_i > 0,
                       rnd.fma32(alpha, mean_lat - fs.inst_lat_ema,
                                 fs.inst_lat_ema),
                       fs.inst_lat_ema)
    # latency outlier: EMA above eject_lat_factor × its service's mean
    # over the ON replicas with signal (at least 2)
    on_i = instances.status == INST_ON
    isvc = instances.service
    isvc_safe = torch.clamp_min(isvc, 0)
    sig = on_i & (lema > 0) & (isvc >= 0)
    sig_svc = torch.where(sig, isvc, -1)
    lat_sum_s = segment_sum(torch.where(sig, lema, 0.0), sig_svc, S)
    lat_cnt_s = segment_sum(sig.to(i32), sig_svc, S)
    svc_lat = lat_sum_s / torch.clamp_min(lat_cnt_s.to(f32), 1.0)
    # alert-driven tightening: while a burn alert fires on a replica's
    # service, its ejection thresholds are multiplied by
    # slo_eject_tighten (1 multiplies exactly).  The alert state read here
    # is one tick old (Disruption runs before Alerting).
    lat_factor = dyn.eject_lat_factor[:, None]
    err_thresh = dyn.eject_err_thresh[:, None]
    eff_lat_factor = lat_factor
    if params.telemetry == "stream" and params.alerting == "burn":
        firing_s = slomod.firing_mask(state.alerts)
        tighten = torch.where(take(firing_s, isvc_safe) & (isvc >= 0),
                              dyn.slo_eject_tighten[:, None], 1.0)
        err_thresh = err_thresh * tighten
        eff_lat_factor = lat_factor * tighten
    lat_trip = ((lat_factor > 0) & (take(lat_cnt_s, isvc_safe) >= 2)
                & (lema > eff_lat_factor * take(svc_lat, isvc_safe)))
    ej_open = fs.inst_eject_until > t
    ej_half = (fs.inst_eject_until > 0) & ~ej_open
    ej_closed = fs.inst_eject_until <= 0
    want = ej_closed & on_i & traffic_i & ((iema > err_thresh) | lat_trip)
    # last-replica guard: eject at most admissible − 1 replicas a service
    n_adm = segment_sum((on_i & ~ej_open).to(i32),
                        torch.where(isvc >= 0, isvc, -1), S)
    eject_rank = segment_rank(isvc_safe, want, S)
    trip_i = want & (eject_rank < torch.clamp_min(
        take(n_adm, isvc_safe) - 1, 0))
    probe_fail = ej_half & (org_i > 0)
    probe_ok = ej_half & (org_i == 0) & (succ_i > 0)
    eject_until = torch.where(trip_i | probe_fail,
                              t + dyn.eject_cooldown_s[:, None],
                              torch.where(probe_ok, 0.0,
                                          fs.inst_eject_until))
    # a re-admitted, dead or restarted replica starts clean
    gone = dead_now | restarts
    eject_until = torch.where(gone, 0.0, eject_until)
    iema = torch.where(probe_ok | gone, 0.0, iema)
    lema = torch.where(probe_ok | gone, 0.0, lema)

    fault = fs._replace(
        host_up=up_new.to(i32), nic_ok=ok_new.to(i32),
        edge_open_until=open_until, edge_err_ema=ema,
        edge_succ=torch.zeros_like(succ_e), host_slow=slow_new.to(i32),
        nic_factor=nic_factor, zone_cut=zone_cut_new,
        inst_err_ema=iema, inst_lat_ema=lema, inst_eject_until=eject_until,
        inst_succ=torch.zeros_like(succ_i),
        inst_lat_sum=torch.zeros_like(fs.inst_lat_sum))

    def count(m):
        return torch.sum(m.reshape(B, -1), dim=1, dtype=i32)

    counters = state.counters._replace(
        spawned=state.counters.spawned + asg.n_assigned)
    fstats = fst._replace(
        host_crashes=fst.host_crashes + count(crash),
        host_recoveries=fst.host_recoveries + count(recover),
        inst_kills=fst.inst_kills + count(killed),
        failed_attempts=fst.failed_attempts + count(failed),
        retries=fst.retries + asg.n_assigned,
        failfast=fst.failfast + count(failfast),
        breaker_trips=fst.breaker_trips + count(trip),
        down_time_s=rnd.fma32(dyn.dt, count(~up_new).to(f32),
                              fst.down_time_s),
        ejections=fst.ejections + count(trip_i),
        readmissions=fst.readmissions + count(probe_ok),
        zone_faults=fst.zone_faults + count(zone_down) + count(zone_slow),
        partitions=fst.partitions + count(p_open),
        slow_episodes=fst.slow_episodes + count(slow_start),
        slow_time_s=rnd.fma32(dyn.dt, count(slow_new).to(f32),
                              fst.slow_time_s))
    return state._replace(rr=rr, cloudlets=cloudlets, requests=requests,
                          counters=counters, fault=fault, fstats=fstats)
