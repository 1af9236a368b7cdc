"""QoS metrics extraction — the paper's Exporter/Reporter (§3.1, Fig 4).

Produces request-based metrics (response-time stats, QPS, SLO violation
rate), instance-based metrics (utilization, milicores) and service-based
metrics (per-node delays, the input of the critical-path analysis).
Host-side: the final state is copied off the device once, then read with
numpy as the reference does.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

import torch

from .engine import SimResult, Simulation
from .types import INST_ON, SimParams


@dataclasses.dataclass
class QoSReport:
    # request-based
    generated_requests: int
    completed_requests: int
    dropped_requests: int
    avg_response_ms: float
    p50_response_ms: float
    p95_response_ms: float
    p99_response_ms: float
    max_response_ms: float
    slo_violation_rate: float
    qps_mean: float
    qps_peak: float
    # cloudlet-based
    cloudlets_spawned: int
    cloudlets_finished: int
    cloudlets_dropped: int
    # instance-based
    active_instances: int
    avg_milicores: float          # paper Fig 11 metric
    avg_utilization: float
    # scaling activity
    scale_out: int
    scale_in: int
    scale_up: int
    scale_down: int
    migrations: int
    # engine
    wall_time_s: float
    compile_time_s: float
    # network fabric (zeros in network="uniform" mode, DESIGN.md §6)
    net_transits: int = 0             # completed transfers
    net_bytes_mb: float = 0.0         # total MB moved on the fabric
    avg_transit_ms: float = 0.0
    transit_p50_ms: float = 0.0       # percentiles from the histogram:
    transit_p95_ms: float = 0.0       # bucket upper edge, CAPPED at the
    transit_p99_ms: float = 0.0       # histogram range (buckets × bin)
    avg_egress_util: float = 0.0      # time-mean NIC utilization over hosts
    avg_ingress_util: float = 0.0
    # availability QoS (all inert in faults="none" mode, DESIGN.md §7)
    availability: float = 1.0         # 1 − failed / completed requests
    error_rate: float = 0.0           # failed attempts / spawned cloudlets
    failed_requests: int = 0
    retries: int = 0                  # retry attempts respawned
    retry_amplification: float = 1.0  # spawned / first-attempt spawns
    failfast_failures: int = 0        # attempts rejected by open breakers
    breaker_trips: int = 0
    host_crashes: int = 0
    observed_mttr_s: float = 0.0      # host down-time / recoveries
    # gray failure / blast radius (DESIGN.md §7.1)
    ejections: int = 0                # replica outlier ejections
    readmissions: int = 0             # ejected replicas re-admitted clean
    zone_faults: int = 0              # zone-correlated crash/slow draws
    partitions: int = 0               # zone-pair partitions opened
    slow_episodes: int = 0            # host fail-slow episodes
    slow_time_s: float = 0.0          # Σ host-slow seconds
    # observability (all-zero unless telemetry="stream", DESIGN.md §9)
    tel_windows: int = 0              # metric windows closed
    tel_spans: int = 0                # spans recorded (sampled requests)
    tel_span_drops: int = 0           # spans dropped at ring capacity
    # SLO alerting (all-zero unless alerting="burn", DESIGN.md §10)
    alert_fires: int = 0              # pending→firing transitions
    alert_resolves: int = 0           # firing→resolved transitions
    alert_firing_time_s: float = 0.0  # Σ (service, rule) seconds firing
    alert_event_drops: int = 0        # transitions dropped at ring capacity

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def transit_percentile_ms(hist: np.ndarray, bin_s: float, p: float) -> float:
    """p-th percentile of the transit-time distribution from its histogram.

    Reported at the bucket's upper edge — conservative *within* the
    histogram range.  Durations beyond ``len(hist) * bin_s`` land in the
    overflow (last) bucket, so a percentile falling there reads as the
    range cap and under-states a heavily saturated tail; widen
    ``SimCaps.net_hist_buckets`` / ``SimParams.net_hist_bin_s`` when the
    cap is hit (``transit_p99_ms == net_hist_buckets * bin * 1000``)."""
    hist = np.asarray(hist, np.int64)
    n = int(hist.sum())
    if n == 0:
        return 0.0
    cdf = np.cumsum(hist)
    b = int(np.searchsorted(cdf, np.ceil(p / 100.0 * n), side="left"))
    return (b + 1) * bin_s * 1000.0


def host_tree(x):
    """A copy of a state container with every tensor moved to numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[host_tree(v) for v in x])
    return x


def summarize(sim: Simulation, result: SimResult,
              window_s: Optional[float] = None,
              params: Optional[SimParams] = None) -> QoSReport:
    """Fold the final state + per-tick traces into a QoS report.

    ``params`` overrides ``sim.params``.
    """
    st = host_tree(result.state)
    params = params or sim.params
    resp_all = np.asarray(st.requests.response)
    # the failed flag is a chaos-mode column (zero-width under
    # faults="none", where nothing ever fails)
    failed_col = np.asarray(st.requests.failed)
    req_failed = (failed_col > 0) if failed_col.size \
        else np.zeros(resp_all.shape, bool)
    # response-time statistics cover SUCCESSFUL completions only (a failed
    # completion's "response" is its time-to-failure); identical to the
    # pre-faults report in faults="none" mode, where nothing ever fails
    resp = resp_all[(resp_all >= 0) & ~req_failed] * 1000.0      # → ms
    trace = result.trace_np()

    dt = params.dt
    qps_series = trace["completed"] / dt
    # steady-state window: after the client ramp (paper Fig 9 highlights
    # the N_c/v boundary), unless the caller overrides.
    ramp_ticks = int(min(params.n_clients / max(params.spawn_rate, 1e-9) / dt,
                         len(qps_series) - 1))
    steady = qps_series[ramp_ticks:] if len(qps_series) > ramp_ticks + 1 \
        else qps_series

    inst_status = np.asarray(st.instances.status)
    on = inst_status == INST_ON
    usage_sum = np.asarray(st.instances.usage_sum)
    busy = np.asarray(st.instances.busy_ticks)
    sim_time = float(st.time)
    # milicores: time-averaged used MIPS converted via mi_per_milicore.
    avg_used = usage_sum / max(sim_time, 1e-9)
    milicores = avg_used * params.mi_per_milicore * 1000.0
    mips = np.asarray(st.instances.mips)
    util = np.where(mips > 0, avg_used / np.maximum(mips, 1e-9), 0.0)

    def pct(p):
        return float(np.percentile(resp, p)) if len(resp) else 0.0

    # --- network fabric (all-zero in uniform mode) -----------------------
    net = st.net
    transits = int(net.transits)
    # every transfer has a destination NIC, so the ingress sum is the
    # total MB moved (client uploads have no egress side)
    bytes_mb = float(np.asarray(net.bytes_in).sum())
    bin_s = params.net_hist_bin_s
    tp = lambda p: transit_percentile_ms(np.asarray(net.hist), bin_s, p)

    # --- availability / resilience (all-zero in faults="none" mode) ------
    fst = st.fstats
    n_failed_req = int(fst.failed_requests)
    spawned = int(st.counters.spawned)
    retries = int(fst.retries)
    recoveries = int(fst.host_recoveries)

    # --- observability (zero-width buffers under telemetry="none") -------
    tel = st.telemetry
    tel_windows = int(np.asarray(tel.win).reshape(-1)[0]) \
        if tel.win.size else 0
    tel_spans = int(np.asarray(tel.span_n).reshape(-1)[0]) \
        if tel.span_n.size else 0
    tel_span_drops = int(np.asarray(tel.span_drops).reshape(-1)[0]) \
        if tel.span_drops.size else 0

    # --- SLO alerting (zero-width buffers unless alerting="burn") --------
    al = st.alerts
    alert_fires = int(np.asarray(al.fires).sum()) if al.fires.size else 0
    alert_resolves = int(np.asarray(al.resolves).sum()) \
        if al.resolves.size else 0
    alert_firing_time_s = float(np.asarray(al.firing_ticks).sum()
                                * params.dt) if al.firing_ticks.size else 0.0
    alert_event_drops = int(np.asarray(al.ev_drops).reshape(-1)[0]) \
        if al.ev_drops.size else 0

    completed = int(st.counters.completed)
    return QoSReport(
        generated_requests=int(st.requests.count),
        completed_requests=completed,
        dropped_requests=int(st.counters.dropped_requests),
        avg_response_ms=float(resp.mean()) if len(resp) else 0.0,
        p50_response_ms=pct(50), p95_response_ms=pct(95),
        p99_response_ms=pct(99),
        max_response_ms=float(resp.max()) if len(resp) else 0.0,
        slo_violation_rate=float(st.counters.slo_violations)
        / max(completed, 1),
        qps_mean=float(steady.mean()) if len(steady) else 0.0,
        qps_peak=float(qps_series.max()) if len(qps_series) else 0.0,
        cloudlets_spawned=int(st.counters.spawned),
        cloudlets_finished=int(st.counters.finished),
        cloudlets_dropped=int(st.counters.dropped_cloudlets),
        active_instances=int(on.sum()),
        avg_milicores=float(milicores[on].mean()) if on.any() else 0.0,
        avg_utilization=float(util[on].mean()) if on.any() else 0.0,
        scale_out=int(st.counters.scale_out),
        scale_in=int(st.counters.scale_in),
        scale_up=int(st.counters.scale_up),
        scale_down=int(st.counters.scale_down),
        migrations=int(st.counters.migrations),
        wall_time_s=result.wall_time_s,
        compile_time_s=result.compile_time_s,
        net_transits=transits,
        net_bytes_mb=bytes_mb,
        avg_transit_ms=float(net.transit_sum) / max(transits, 1) * 1000.0,
        transit_p50_ms=tp(50), transit_p95_ms=tp(95), transit_p99_ms=tp(99),
        avg_egress_util=float(np.asarray(net.egress_busy).mean())
        / max(sim_time, 1e-9),
        avg_ingress_util=float(np.asarray(net.ingress_busy).mean())
        / max(sim_time, 1e-9),
        availability=1.0 - n_failed_req / max(completed, 1),
        error_rate=int(fst.failed_attempts) / max(spawned, 1),
        failed_requests=n_failed_req,
        retries=retries,
        retry_amplification=spawned / max(spawned - retries, 1),
        failfast_failures=int(fst.failfast),
        breaker_trips=int(fst.breaker_trips),
        host_crashes=int(fst.host_crashes),
        observed_mttr_s=float(fst.down_time_s) / max(recoveries, 1),
        ejections=int(fst.ejections),
        readmissions=int(fst.readmissions),
        zone_faults=int(fst.zone_faults),
        partitions=int(fst.partitions),
        slow_episodes=int(fst.slow_episodes),
        slow_time_s=float(fst.slow_time_s),
        tel_windows=tel_windows,
        tel_spans=tel_spans,
        tel_span_drops=tel_span_drops,
        alert_fires=alert_fires,
        alert_resolves=alert_resolves,
        alert_firing_time_s=alert_firing_time_s,
        alert_event_drops=alert_event_drops,
    )


def node_delays(result: SimResult) -> np.ndarray:
    """Mean sojourn (wait + exec) per service — the per-node ``delay(n)``
    of paper Eq 5, measured from the simulation."""
    st = host_tree(result.state.svc_stats)
    fin = np.asarray(st.finished).astype(np.float64)
    return np.asarray(st.delay_sum) / np.maximum(fin, 1.0)


def report_text(rep: QoSReport) -> str:
    """Human-readable Reporter output (paper: 'displayed in system logs')."""
    lines = ["=== CloudNativeSim QoS report ==="]
    for f in dataclasses.fields(rep):
        lines.append(f"  {f.name:22s} {getattr(rep, f.name)}")
    return "\n".join(lines)
