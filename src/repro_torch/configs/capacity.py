"""Paper Table 2 — the simulation-capacity cases (§6.1), for the port.

The sizing is the reference's (``benchmarks/bench_capacity.py``
``build_case``/``CASES``), copied so the port stands alone.  The default
mode, the fabric variant (``network=True``, tagged ``<case>+net``) and the
chaos variants (``faults=True``, ``<case>+faults``: host crashes and
retries; ``chaos2=True``, ``<case>+chaos2``: every gray-failure stream
too, over 4 failure domains) and the observability variants
(``telemetry=True``, ``<case>+obs``: streamed metric rows and sampled
spans; ``slo=True``, ``<case>+slo``: burn-rate alerting too) are built
here.

Case structure (paper's counts; topology interpretation in brackets):
  1: 1 service × 10³ instances, 10⁵/10⁶ requests → 1 cloudlet per request
  2: 5×10³/5×10⁴ parallel services (fan-out at generation), 10³ requests
     → 5×10⁶/5×10⁷ cloudlets
  3: 10²/10³ services × 3 replicas, 10⁴ requests
  4: 5×10³ services × 3 replicas, 10³/10⁴ requests
"""
from __future__ import annotations

import numpy as np

from ..core import InstanceTemplate, SimCaps, SimParams, Simulation
from ..core.graph import build_graph

# tag → (n_requests, n_services, replicas, cloudlets_per_request, fanout)
CASES = {
    "case1a": (10 ** 5, 1, 1000, 1, 1),
    "case1b": (10 ** 6, 1, 1000, 1, 1),
    "case2a": (10 ** 3, 5 * 10 ** 3, 1, 5 * 10 ** 3, 5 * 10 ** 3),
    "case2b": (10 ** 3, 5 * 10 ** 4, 1, 5 * 10 ** 4, 5 * 10 ** 4),
    "case3a": (10 ** 4, 10 ** 2, 3, 10 ** 2, 10 ** 2),
    "case3b": (10 ** 4, 10 ** 3, 3, 10 ** 3, 10 ** 3),
    "case4a": (10 ** 3, 5 * 10 ** 3, 3, 5 * 10 ** 3, 5 * 10 ** 3),
    "case4b": (10 ** 4, 5 * 10 ** 3, 3, 5 * 10 ** 3, 5 * 10 ** 3),
}


def flat_services(n: int, mi: float):
    """n independent services, one API entering all of them (fan-out
    happens at request generation)."""
    names = [f"s{i}" for i in range(n)]
    return build_graph(names, {}, [("api", names[0], 1.0)],
                       {nm: mi for nm in names}, d_max=1)


def build_case(n_requests: int, n_services: int, replicas: int,
               fanout: int = 1, device="cuda", network: bool = False,
               faults: bool = False, chaos2: bool = False,
               telemetry: bool = False, slo: bool = False):
    """A capacity Simulation sized to the Table 2 object counts; returns
    (sim, meta) where meta records the sizing decisions.  ``network=True``
    runs the fabric's Transit phase on ample 10,000 Mbit/s host NICs (the
    phase runs, the workload does not starve), as the reference's
    ``case1b+net`` record does.  ``faults=True`` turns the Disruption
    phase on with rare host crashes (MTBF twice the run) and retries;
    ``chaos2=True`` adds mild gray chaos, every stream of it sampled each
    tick, with the hosts in 4 zones (the reference's ``fault_kw``).
    ``telemetry=True`` streams 16-tick windows and samples 1 request in
    100 into a 4,096-span ring with a 64-span per-tick budget;
    ``slo=True`` adds burn-rate alerting on a 5 % budget (the reference's
    ``tel_kw``)."""
    mi = 50.0
    graph = flat_services(n_services, mi)
    api_entries = ([[f"s{i}" for i in range(n_services)]]
                   if fanout > 1 else None)
    n_inst = n_services * replicas
    n_vms = max(n_inst // 64, 4)
    dt = 0.5
    fanout = max(fanout, 1)
    avg_wait_ticks = 4.0 / dt

    # Admission sizing: k_fire (requests admitted per tick) so the active
    # pool holds ~2 ticks of arrivals with 2× head-room, and enough ticks
    # to admit everything + drain.
    target_ticks = 500
    k_fire = max(int(np.ceil(n_requests / target_ticks)), 1)
    if 5 * k_fire * fanout > 2 * (1 << 18):
        k_fire = max(2 * (1 << 18) // (5 * fanout), 1)
    pool = int(min(max(4 * k_fire * fanout, 1 << 12), 1 << 18))
    nc = int(min(max(k_fire * avg_wait_ticks, 64), 1 << 16))
    fire_rate = min(k_fire, nc / avg_wait_ticks)       # requests per tick
    n_ticks = int(n_requests / fire_rate * 1.25) + 60
    duration = n_ticks * dt

    caps = SimCaps(n_clients=nc, max_requests=n_requests + nc + 8,
                   max_cloudlets=pool, max_instances=n_inst, n_vms=n_vms,
                   d_max=1, max_replicas=replicas, k_fire=k_fire)
    fault_kw = dict(
        faults="chaos", host_mtbf_s=duration * 2.0, host_mttr_s=2 * dt,
        inst_kill_rate=0.0, retry_timeout_s=20 * duration, retry_budget=2,
    ) if (faults or chaos2) else {}
    if chaos2:
        # mild gray chaos: every stream samples each tick without
        # collapsing throughput (rates sized to a handful of episodes)
        fault_kw.update(
            host_slow_mtbf_s=duration, host_slow_mttr_s=4 * dt,
            host_slow_factor=0.5, nic_degrade_spread=0.2,
            zone_slow_rate=1.0 / duration,
            zone_partition_rate=1.0 / duration,
            zone_partition_mttr_s=4 * dt,
            eject_err_thresh=0.8, eject_cooldown_s=4 * dt)
    tel_kw = dict(telemetry="stream", tel_window_ticks=16, tel_windows=8,
                  tel_span_k=100, tel_span_cap=4096,
                  tel_span_tick_cap=64) if (telemetry or slo) else {}
    if slo:
        tel_kw.update(alerting="burn", slo_budget=0.05, slo_short_wins=2,
                      slo_long_wins=4, slo_for_ticks=2, slo_event_cap=256)
    params = SimParams(dt=dt, n_ticks=n_ticks, n_clients=nc,
                       spawn_rate=nc / 5.0, wait_lo=2.0, wait_hi=6.0,
                       num_limit=n_requests, seed=0,
                       network="fabric" if network else "uniform",
                       nic_egress_mbps=10_000.0, nic_ingress_mbps=10_000.0,
                       **fault_kw, **tel_kw)
    # Instance speed: each tick's per-instance batch drains in ~0.4 ticks.
    a_i = fire_rate * fanout / n_inst        # cloudlet arrivals/inst/tick
    mips = max(a_i, 0.4) * mi / (0.4 * dt)
    tmpl = InstanceTemplate(mips=mips, limit_mips=2 * mips, ram=1.0,
                            limit_ram=2.0, bw=100.0, replicas=replicas)
    vm_mips = np.full(n_vms, 2.0 * mips * n_inst / n_vms + 1e4, np.float32)
    vm_ram = np.full(n_vms, 1e9, np.float32)
    host_zone = np.arange(n_vms, dtype=np.int32) % 4 if chaos2 else None
    sim = Simulation(graph, caps=caps, params=params, default_template=tmpl,
                     vm_mips=vm_mips, vm_ram=vm_ram,
                     api_entries=api_entries, host_zone=host_zone,
                     device=device)
    meta = dict(n_requests=n_requests, n_services=n_services,
                replicas=replicas, n_instances=n_inst, n_ticks=n_ticks,
                pool=pool, k_fire=k_fire, n_clients=nc)
    return sim, meta


# variant tag → build_case's mode flags (the reference's record suffixes)
VARIANTS = {
    "": {}, "net": dict(network=True), "faults": dict(faults=True),
    "chaos2": dict(chaos2=True), "net+chaos2": dict(network=True,
                                                    chaos2=True),
    "obs": dict(telemetry=True), "slo": dict(slo=True),
}


def build_tagged(tag: str, scale: float = 1.0, device="cuda"):
    """The Table 2 case ``tag`` (``"case1b"``, or with a variant suffix:
    ``"+net"``, ``"+faults"``, ``"+chaos2"``, ``"+net+chaos2"``, ``"+obs"``,
    ``"+slo"``) with its
    request count scaled by ``scale`` (at least 100 requests), as the
    reference's perf records."""
    case, _, variant = tag.partition("+")
    if variant not in VARIANTS:
        raise ValueError(f"unknown capacity variant {tag!r} (the port "
                         "builds <case> with the suffixes "
                         f"{sorted(v for v in VARIANTS if v)})")
    n_requests, n_services, replicas, _, fanout = CASES[case]
    n_requests = max(int(n_requests * scale), 100)
    return build_case(n_requests, n_services, replicas, fanout, device,
                      **VARIANTS[variant])
