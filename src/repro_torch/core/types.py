"""Core data structures of the PyTorch port of the CloudNativeSim engine.

The reference's fixed-shape tensor pools, as PyTorch tensors: requests are
append-only, cloudlets live in a stacked active-set buffer (one ``[C, NI]``
int32 block and one ``[C, NF]`` float32 block) whose column set is the
mode-keyed :class:`PoolLayout`.  State containers are ``NamedTuple``s with
the reference's field names, so a state carries across leaf for leaf
(``core.convert``).

Conventions: int32 / float32 everywhere (the reference runs with x64 off);
``-1`` is the null id; pools have fixed capacity.  The PRNG key
(``SimState.rng``) is the one leaf that always lives on the CPU — see
``repro_torch.random``.  Both network modes (``"uniform"`` and
``"fabric"``) and both fault modes (``"none"`` and ``"chaos"``) are
ported, and so are the observability modes (``telemetry="stream"``,
``alerting="burn"``, ``hs_mode="slo_burn"``); with them off the telemetry
and alert tables exist with zero width, as do the chaos tables with
``faults="none"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import random as rnd
from ..analysis import streams

# Cloudlet status codes (paper §4.2: waiting / execution / finished queues).
CL_FREE = 0       # slot unused (or folded into the "finished" aggregate)
CL_WAITING = 1    # in the waiting queue
CL_EXEC = 2       # in the execution queue
CL_TRANSIT = 3    # RPC payload in flight on the network fabric

# Instance status codes.
INST_FREE = 0     # slot unused
INST_ON = 1       # active, receiving cloudlets
INST_DRAIN = 2    # scale-in requested: no new cloudlets, frees when empty
INST_DOWN = 3     # crashed (chaos mode only)


@dataclasses.dataclass(frozen=True)
class SimCaps:
    """Static pool capacities (fixed tensor shapes)."""

    n_clients: int = 128          # Nc upper bound (client pool size)
    max_requests: int = 4096      # append-only request pool
    max_cloudlets: int = 8192     # ACTIVE cloudlet buffer (waiting+exec)
    max_instances: int = 64       # instance pool (incl. head-room for HS)
    n_vms: int = 8
    d_max: int = 4                # max out-degree of any service node
    max_replicas: int = 8         # per-service replica cap (HS)
    k_fire: int = 0               # max requests admitted per tick (0 = Nc);
                                  # over-budget clients retry next tick
    net_hist_buckets: int = 64    # transit-time histogram resolution (§6)
    k_retry: int = 0              # max retry respawns per Disruption tick
                                  # (0 = auto: min(C, max(256, C/8)));
                                  # over-budget failures fail permanently —
                                  # a per-tick retry admission budget (§7)

    def validate(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            lo = 0 if f.name in ("k_fire", "k_retry") else 1
            if not isinstance(v, int) or v < lo:
                raise ValueError(
                    f"SimCaps.{f.name} must be an int ≥ {lo}, got {v!r}")


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Scalar parameters of a simulation run.  Every field of the
    reference is kept so configurations carry over; the knobs whose
    phases are not ported yet raise in :func:`core.engine.make_tick`."""

    # --- time -----------------------------------------------------------
    dt: float = 0.1               # seconds per tick
    n_ticks: int = 1000

    # --- request generator (paper Alg 1) --------------------------------
    n_clients: int = 100          # N_c, final number of clients
    spawn_rate: float = 1.0       # v, clients per second
    wait_lo: float = 5.0          # p0 (seconds)
    wait_hi: float = 15.0         # p1 (seconds)
    num_limit: int = 2 ** 31 - 1  # numLimit (max generated requests)

    # --- scheduling (paper §4.2) ----------------------------------------
    lb_policy: int = 0            # policies.LB_* (round-robin default)
    share_policy: int = 0         # policies.SHARE_* (equal time slice)
    max_concurrent: int = 0       # 0 = pure time sharing (unbounded)
    net_latency_s: float = 0.0    # per-RPC-hop network latency (seconds)

    # --- network fabric (DESIGN.md §6) -----------------------------------
    network: str = "uniform"      # "uniform": load-independent net_latency_s
                                  # per hop (the legacy degenerate mode);
                                  # "fabric": payloads transit host NICs with
                                  # max-min fair bandwidth contention
    nic_egress_mbps: float = 1000.0   # per-host NIC egress capacity
    nic_ingress_mbps: float = 1000.0  # per-host NIC ingress capacity
    waterfill_iters: int = 2      # water-filling freeze rounds (static:
                                  # exact max-min for ≤ this many bottleneck
                                  # levels, conservative — never
                                  # oversubscribing — beyond; raise for
                                  # deep multi-bottleneck fabrics)
    net_hist_bin_s: float = 0.01  # transit-time histogram bin width (s)

    # --- scaling (paper §5.3) -------------------------------------------
    scaling_policy: int = 0       # policies.SCALE_* (NS default)
    scale_interval: int = 50      # ticks between scaling events
    hs_util_hi: float = 0.8       # HS scale-out threshold (service avg util)
    hs_util_lo: float = 0.2       # HS scale-in threshold
    vs_util_hi: float = 0.8       # VS scale-up threshold (instance util)
    vs_util_lo: float = 0.2
    vs_up_factor: float = 1.5
    vs_down_factor: float = 0.75
    util_ema: float = 0.2         # EMA coefficient for utilization signal

    # --- migration (paper §5.1) -----------------------------------------
    migration_enabled: bool = False
    mig_vm_util_hi: float = 0.9

    # --- fault injection & resilience (DESIGN.md §7) ---------------------
    faults: str = "none"          # "none": the fault-free engine (exact
                                  # pre-faults program, bit-pinned);
                                  # "chaos": Disruption tick phase — host
                                  # crash/recovery, instance kills, NIC
                                  # degradation, retries, circuit breakers
    host_mtbf_s: float = float("inf")   # mean time between host crashes
    host_mttr_s: float = 30.0           # mean host recovery time
    inst_kill_rate: float = 0.0         # instance kills per second per pod
    inst_mttr_s: float = 15.0           # mean pod restart time (host up)
    nic_degrade_rate: float = 0.0       # NIC degradations per second per host
    nic_mttr_s: float = 30.0            # mean NIC recovery time
    nic_degrade_factor: float = 1.0     # capacity multiplier while degraded
    retry_budget: int = 2         # default retries per RPC (per-edge
                                  # overrides via the registry "retries" key)
    retry_timeout_s: float = float("inf")  # per-attempt timeout (age of the
                                  # attempt before it counts as failed)
    cb_err_thresh: float = 2.0    # breaker trip threshold on the per-edge
                                  # error-rate EMA (> 1 = breaker disabled)
    cb_alpha: float = 0.3         # error-rate EMA coefficient
    cb_cooldown_s: float = 10.0   # open → half-open cooldown
    egress_shaping: bool = False  # clamp per-instance Transit egress by
                                  # Instances.bw (fabric mode, §6)

    # --- gray failure (fail-slow / blast radius, DESIGN.md §7.1) ---------
    host_slow_mtbf_s: float = float("inf")  # mean time between fail-slow
                                  # episodes per host (inf = never)
    host_slow_mttr_s: float = 30.0          # mean fail-slow episode length
    host_slow_factor: float = 0.25          # MIPS multiplier while slow
    nic_degrade_spread: float = 0.0         # NIC brownout severity spread:
                                  # each degradation samples its factor from
                                  # U[factor − spread, factor + spread]∩[0,1]
    zone_fault_rate: float = 0.0  # zone crash draws per second per zone —
                                  # one draw downs EVERY host of the zone
                                  # (hosts recover individually, host_mttr_s)
    zone_slow_rate: float = 0.0   # zone fail-slow draws per second per zone
    zone_partition_rate: float = 0.0   # partial-partition draws per second
                                  # per zone PAIR (cuts their link capacity)
    zone_partition_mttr_s: float = 30.0  # mean partition length
    eject_err_thresh: float = 2.0 # outlier-ejection trip threshold on the
                                  # per-replica error EMA (> 1 = disabled)
    eject_lat_factor: float = 0.0 # latency outlier trip: replica latency
                                  # EMA > factor × its service's mean
                                  # (0 = latency ejection disabled)
    eject_cooldown_s: float = 10.0  # ejected → probe (half-open) cooldown

    # --- usage accounting (paper §5.2 linear model) ----------------------
    idle_mips_frac: float = 0.0   # idle floor: instances consume a small
                                  # fraction of their allocation when ON
    vs_overhead_frac: float = 0.0 # resize churn: vertically-scaled
                                  # instances pay a usage surcharge

    # --- observability (DESIGN.md §9) ------------------------------------
    telemetry: str = "none"       # "none": zero telemetry state, program
                                  # bit-identical to the pre-obs engine;
                                  # "stream": per-window metric rows ring
                                  # out through a double-buffered
                                  # io_callback tap + sampled span tracing
    tel_window_ticks: int = 16    # ticks per metric-row window
    tel_windows: int = 8          # metric ring capacity W (even; one
                                  # io_callback flush per W/2 windows)
    tel_span_k: int = 100         # trace 1 request in k (seeded Bernoulli)
    tel_span_cap: int = 1024      # span ring capacity (overflow drops
                                  # are counted exactly, never overwrite)
    tel_span_tick_cap: int = 0    # per-tick span staging budget (0 = the
                                  # ring capacity; sampled finishers past
                                  # it drop — counted, never silent)
    tel_tag: float = 0.0          # row tag (traced; run_batch auto-tags
                                  # sweep points when left at 0)

    # --- SLO objectives & burn-rate alerting (DESIGN.md §10) -------------
    alerting: str = "none"        # "none": no alert state, program
                                  # bit-identical to the alert-free engine;
                                  # "burn": Alerting tick stage — per-service
                                  # multi-window burn-rate rules + alert
                                  # state machine (requires telemetry="stream")
    hs_mode: str = "util"         # horizontal scale-out gate: "util"
                                  # (threshold on the utilization EMA) or
                                  # "slo_burn" (firing burn alerts + a
                                  # stabilization window); TRACED — sweep
                                  # points select per-point, no recompile
    slo_budget: float = 0.0       # run-wide error-budget fraction (allowed
                                  # share of slow completions per service);
                                  # 0 disables every objective without a
                                  # per-service override (traced)
    slo_fast_burn: float = 14.4   # fast-rule burn threshold (Google SRE
                                  # page rule: 14.4× budget burn; traced)
    slo_slow_burn: float = 6.0    # slow-rule burn threshold (traced)
    slo_short_wins: int = 3       # short lookback, in CLOSED telemetry
                                  # windows (static: sizes the rule masks)
    slo_long_wins: int = 12       # long lookback = SLI ring length (static)
    slo_for_ticks: int = 5        # hysteresis: rule must hold this many
                                  # consecutive ticks before pending→firing
    slo_stabilize_s: float = 30.0 # burn-mode scale-out stabilization window
                                  # per service (traced)
    slo_eject_tighten: float = 1.0  # outlier-ejection threshold multiplier
                                  # applied while a latency alert fires on
                                  # the replica's service (traced; 1 = off)
    slo_event_cap: int = 256      # alert-transition ring capacity (overflow
                                  # drops are counted exactly)

    # --- backend ---------------------------------------------------------
    use_pallas_tick: bool = False # kept for configuration parity; the port
                                  # picks the kernel by device (CUDA runs
                                  # the hand kernels, the CPU their plain
                                  # versions) and never reads this
    pallas_interpret: bool = False  # kept for configuration parity (unused)

    # --- QoS -------------------------------------------------------------
    slo_ms: float = 1000.0        # SLO threshold on response time (ms)
    mi_per_milicore: float = 0.001  # milicores = used_mips / mi_per_milicore

    seed: int = 0


# Horizontal scale-out gates (dyn.hs_mode encodes the index).
HS_MODES = ("util", "slo_burn")

# Burn-rate rules evaluated per service (axis 1 of AlertState.astate) and
# the alert state machine's states; the names are the exported labels.
ALERT_RULES = ("SLOFastBurn", "SLOSlowBurn")
ALERT_STATES = ("inactive", "pending", "firing", "resolved")
ALERT_INACTIVE, ALERT_PENDING, ALERT_FIRING, ALERT_RESOLVED = 0, 1, 2, 3

# The chaos knobs of the Disruption phase (core/faults.py), in the
# reference's DynParams order; all float32 but ``retry_budget``.
_CHAOS_FIELDS = (
    "host_mtbf_s", "host_mttr_s", "inst_kill_rate", "inst_mttr_s",
    "nic_degrade_rate", "nic_mttr_s", "nic_degrade_factor", "retry_budget",
    "retry_timeout_s", "cb_err_thresh", "cb_alpha", "cb_cooldown_s",
    "host_slow_mtbf_s", "host_slow_mttr_s", "host_slow_factor",
    "nic_degrade_spread", "zone_fault_rate", "zone_slow_rate",
    "zone_partition_rate", "zone_partition_mttr_s", "eject_err_thresh",
    "eject_lat_factor", "eject_cooldown_s")

_F32_FIELDS = (
    "dt", "spawn_rate", "wait_lo", "wait_hi", "hs_util_hi", "hs_util_lo",
    "vs_util_hi", "vs_util_lo", "vs_up_factor", "vs_down_factor",
    "util_ema", "mig_vm_util_hi", "slo_ms", "net_latency",
    "idle_mips_frac", "vs_overhead_frac", "nic_egress_mbps",
    "nic_ingress_mbps") + tuple(f for f in _CHAOS_FIELDS
                                if f != "retry_budget") + (
    "slo_budget", "slo_fast_burn", "slo_slow_burn", "slo_stabilize_s",
    "slo_eject_tighten", "tel_tag")
_I32_FIELDS = ("n_clients", "num_limit", "max_concurrent", "scale_interval",
               "retry_budget", "hs_mode")


class DynParams(NamedTuple):
    """The reference's traced scalars: the values a sweep may vary
    without a new capture.  ``from_params`` gives one point's as numpy
    float32/int32 scalars; ``engine.stack_dyn`` stacks points into
    ``[B]`` arrays; inside the tick they are ``[B]`` float32/int32 tensors
    on the device, in buffers a run fills (``engine.TickLoop``), so no
    captured tick bakes a swept value.  The fields and their order are
    the reference's."""

    dt: np.float32
    n_clients: np.int32
    spawn_rate: np.float32
    wait_lo: np.float32
    wait_hi: np.float32
    num_limit: np.int32
    max_concurrent: np.int32
    scale_interval: np.int32
    hs_util_hi: np.float32
    hs_util_lo: np.float32
    vs_util_hi: np.float32
    vs_util_lo: np.float32
    vs_up_factor: np.float32
    vs_down_factor: np.float32
    util_ema: np.float32
    mig_vm_util_hi: np.float32
    slo_ms: np.float32
    net_latency: np.float32
    idle_mips_frac: np.float32
    vs_overhead_frac: np.float32
    nic_egress_mbps: np.float32
    nic_ingress_mbps: np.float32
    host_mtbf_s: np.float32
    host_mttr_s: np.float32
    inst_kill_rate: np.float32
    inst_mttr_s: np.float32
    nic_degrade_rate: np.float32
    nic_mttr_s: np.float32
    nic_degrade_factor: np.float32
    retry_budget: np.int32
    retry_timeout_s: np.float32
    cb_err_thresh: np.float32
    cb_alpha: np.float32
    cb_cooldown_s: np.float32
    host_slow_mtbf_s: np.float32
    host_slow_mttr_s: np.float32
    host_slow_factor: np.float32
    nic_degrade_spread: np.float32
    zone_fault_rate: np.float32
    zone_slow_rate: np.float32
    zone_partition_rate: np.float32
    zone_partition_mttr_s: np.float32
    eject_err_thresh: np.float32
    eject_lat_factor: np.float32
    eject_cooldown_s: np.float32
    hs_mode: np.int32
    slo_budget: np.float32
    slo_fast_burn: np.float32
    slo_slow_burn: np.float32
    slo_stabilize_s: np.float32
    slo_eject_tighten: np.float32
    tel_tag: np.float32

    @staticmethod
    def from_params(p: "SimParams") -> "DynParams":
        src = dataclasses.asdict(p)
        src["net_latency"] = p.net_latency_s
        src["hs_mode"] = HS_MODES.index(p.hs_mode)
        vals = {k: np.float32(src[k]) for k in _F32_FIELDS}
        vals.update({k: np.int32(src[k]) for k in _I32_FIELDS})
        return DynParams(**vals)


class Clients(NamedTuple):
    """Locust-style closed-loop client pool (paper Alg 1)."""

    wait: torch.Tensor        # [Nc] i32 ticks until next request (0 = fire)


class Requests(NamedTuple):
    """Append-only request pool (paper §4.3)."""

    count: torch.Tensor        # scalar i32, number of allocated requests
    api: torch.Tensor          # [R] i32
    arrival: torch.Tensor      # [R] f32 seconds
    outstanding: torch.Tensor  # [R] i32 cloudlets in flight
    spawned: torch.Tensor      # [R] i32 total cloudlets ever spawned
    finish: torch.Tensor       # [R] f32 max cloudlet finish time so far
    response: torch.Tensor     # [R] f32 final response (s), -1 while open
    critical_len: torch.Tensor # [R] i32 nodes on the critical (longest) chain
    failed: torch.Tensor       # [R] u8 1 = a cloudlet failed for good
    #                            (chaos mode; zero-width with faults off)


POOL_COLUMNS = (
    ("status", "i", 0),        # CL_*
    ("req", "i", -1),          # owning request
    ("service", "i", -1),      # service node
    ("inst", "i", -1),         # assigned instance (-1 = unassigned)
    ("wait_ticks", "i", 0),    # ticks spent in the waiting queue
    ("depth", "i", 0),         # hops from the root cloudlet
    ("src_host", "i", -1),     # transfer source host (-1 = client / none)
    ("attempt", "i", 0),       # retry attempt counter (0 = first try, §7)
    ("edge", "i", -1),         # service-graph edge this RPC traverses:
    #                            parent_svc * d_max + slot for call edges,
    #                            S * d_max + api for client→entry edges
    #                            (retry policy / circuit breaker key, §7)
    ("src_inst", "i", -1),     # caller instance (-1 = external client)
    ("length", "f", 0.0),      # total MI (Gaussian, paper §4.1.2)
    ("rem", "f", 0.0),         # remaining MI
    ("arrival", "f", 0.0),     # seconds (of the current attempt)
    ("start", "f", -1.0),      # first-execution time (-1 = not yet)
    ("rem_bytes", "f", 0.0),   # MB still in flight (TRANSIT status, §6)
)
CL_I_FIELDS = tuple(n for n, b, _ in POOL_COLUMNS if b == "i")
CL_F_FIELDS = tuple(n for n, b, _ in POOL_COLUMNS if b == "f")
_COL_BLOCK = {n: b for n, b, _ in POOL_COLUMNS}
_COL_INIT = {n: v for n, _, v in POOL_COLUMNS}

# Tick phase → columns it reads/writes (the registry the layout is keyed
# on).  The first four phases exist in every mode; Transit only under
# network="fabric", Disruption only under faults="chaos", and the
# egress-shaping clamp (a Transit sub-feature) only when opted in.
PHASE_COLUMNS = {
    "Generation": ("status", "req", "service", "inst", "wait_ticks",
                   "depth", "length", "rem", "arrival", "start"),
    "Dispatch":   ("status", "service", "inst", "wait_ticks", "arrival",
                   "start"),
    "Execute":    ("status", "req", "service", "inst", "depth", "rem",
                   "arrival", "start"),
    # Chaos-mode Execute additionally folds per-edge success counts for
    # the breaker EMA off cl.edge — drift simcheck's layout-access
    # checker caught (the column was only declared under Disruption; the
    # resolved layout is unchanged, the *attribution* was wrong).
    "Execute/chaos": ("edge",),
    "Derive":     ("status", "req", "service", "inst", "depth", "length",
                   "rem", "arrival", "start"),
    "Transit":    ("status", "inst", "arrival", "src_host", "rem_bytes"),
    "Transit/egress_shaping": ("src_inst",),
    "Disruption": ("status", "req", "service", "inst", "depth", "attempt",
                   "edge", "src_inst", "length", "rem", "arrival", "start"),
    # Fabric-mode retry respawns re-derive the retried hop's source host
    # (same checker catch as Execute/chaos: the column was riding on
    # Transit's declaration; resolved layouts are unchanged).
    "Disruption/fabric": ("src_host",),
    # Telemetry (telemetry="stream", DESIGN.md §9) reads finished rows
    # into the span ring and samples end-of-tick gauges; it only ever
    # RE-reads columns other phases already pulled into the layout, so
    # every resolved layout is unchanged and telemetry="none" stays
    # bit-identical by construction.
    "Telemetry": ("status", "req", "service", "wait_ticks", "arrival",
                  "start"),
    "Telemetry/chaos": ("edge", "attempt"),
    "Telemetry/fabric": ("src_host", "rem_bytes"),
    # Alerting (alerting="burn", DESIGN.md §10) folds finished-hop sojourn
    # times into the per-service SLI accumulators; like Telemetry it is
    # observation-only — `arrival` rides on Execute's declaration, so no
    # resolved layout grows.
    "Alerting": ("arrival",),
}


@dataclasses.dataclass(frozen=True)
class PoolLayout:
    """Static name → column-index map of the stacked cloudlet pool.

    Resolved once per mode combination (`resolve_layout`) and carried by
    :class:`Cloudlets`; hashable, so it can key caches.
    """

    i_fields: Tuple[str, ...]
    f_fields: Tuple[str, ...]

    def i(self, name: str) -> int:
        """Index of an i32 column in the [C, NI] block."""
        try:
            return self.i_fields.index(name)
        except ValueError:
            raise KeyError(
                f"pool column {name!r} is not part of this mode's layout "
                f"(i32 columns: {self.i_fields})") from None

    def f(self, name: str) -> int:
        """Index of an f32 column in the [C, NF] block."""
        try:
            return self.f_fields.index(name)
        except ValueError:
            raise KeyError(
                f"pool column {name!r} is not part of this mode's layout "
                f"(f32 columns: {self.f_fields})") from None

    def __contains__(self, name: str) -> bool:
        return name in self.i_fields or name in self.f_fields

    @property
    def columns(self) -> Tuple[str, ...]:
        return self.i_fields + self.f_fields

    def init_ints(self) -> np.ndarray:
        return np.array([_COL_INIT[n] for n in self.i_fields], np.int32)

    def init_flts(self) -> np.ndarray:
        return np.array([_COL_INIT[n] for n in self.f_fields], np.float32)


@functools.lru_cache(maxsize=None)
def _layout_for(network: str, faults: str, egress_shaping: bool,
                telemetry: bool = False, alerting: bool = False) -> PoolLayout:
    phases = ["Generation", "Dispatch", "Execute", "Derive"]
    if faults == "chaos":
        phases.append("Disruption")
        phases.append("Execute/chaos")
    if network == "fabric":
        phases.append("Transit")
        if faults == "chaos":
            phases.append("Disruption/fabric")
        if egress_shaping:
            phases.append("Transit/egress_shaping")
    if telemetry:
        # observation-only: the Telemetry declarations are a subset of the
        # union above in every mode, so the resolved layout never grows
        phases.append("Telemetry")
        if faults == "chaos":
            phases.append("Telemetry/chaos")
        if network == "fabric":
            phases.append("Telemetry/fabric")
    if alerting:
        phases.append("Alerting")
    need = set()
    for p in phases:
        cols = set(PHASE_COLUMNS[p])
        if p.startswith("Telemetry") or p == "Alerting":
            extra = cols - need
            if extra:
                raise ValueError(
                    f"PHASE_COLUMNS[{p!r}] declares column(s) "
                    f"{sorted(extra)} that no simulating phase carries in "
                    "this mode — telemetry/alerting is observation-only "
                    "and must not grow the pool layout")
        need |= cols
    return PoolLayout(
        i_fields=tuple(n for n in CL_I_FIELDS if n in need),
        f_fields=tuple(n for n in CL_F_FIELDS if n in need))


def resolve_layout(params: "SimParams") -> PoolLayout:
    """The static pool layout a SimParams' enabled phases require."""
    return _layout_for(params.network, params.faults,
                       params.network == "fabric" and params.egress_shaping,
                       params.telemetry == "stream",
                       params.telemetry == "stream"
                       and params.alerting == "burn")



_COL_DTYPE = {"i": torch.int32, "f": torch.float32}


class Cloudlets:
    """Active-set RpcCloudlet buffer, stored as two stacked column blocks
    so one spawn wave is two scatters.  Named accessors and the column
    writers resolve indices through the mode-keyed :class:`PoolLayout`;
    writers skip registered columns outside the layout, reads of an absent
    column raise ``KeyError``.  Accessors return views of the blocks."""

    __slots__ = ("ints", "flts", "layout")

    def __init__(self, ints: torch.Tensor, flts: torch.Tensor,
                 layout: PoolLayout):
        self.ints = ints        # [(B,) C, len(layout.i_fields)] i32
        self.flts = flts        # [(B,) C, len(layout.f_fields)] f32
        self.layout = layout

    def replace(self, ints=None, flts=None) -> "Cloudlets":
        return Cloudlets(self.ints if ints is None else ints,
                         self.flts if flts is None else flts, self.layout)

    def col(self, name: str) -> torch.Tensor:
        if _COL_BLOCK.get(name) == "i":
            return self.ints[..., self.layout.i(name)]
        if _COL_BLOCK.get(name) == "f":
            return self.flts[..., self.layout.f(name)]
        raise KeyError(f"unknown pool column {name!r}")

    status = property(lambda self: self.col("status"))
    req = property(lambda self: self.col("req"))
    service = property(lambda self: self.col("service"))
    inst = property(lambda self: self.col("inst"))
    wait_ticks = property(lambda self: self.col("wait_ticks"))
    depth = property(lambda self: self.col("depth"))
    length = property(lambda self: self.col("length"))
    rem = property(lambda self: self.col("rem"))
    arrival = property(lambda self: self.col("arrival"))
    start = property(lambda self: self.col("start"))
    src_host = property(lambda self: self.col("src_host"))
    src_inst = property(lambda self: self.col("src_inst"))
    rem_bytes = property(lambda self: self.col("rem_bytes"))

    def with_cols(self, **cols) -> "Cloudlets":
        """Replace whole ``[(B,) C]`` columns by name (new blocks; the old
        ones are left untouched).  Registered columns outside the layout
        are skipped; unregistered names raise."""
        ints, flts = self.ints.clone(), self.flts.clone()
        L = self.layout
        for name, v in cols.items():
            if name not in _COL_BLOCK:
                raise TypeError(f"unknown pool column {name!r}")
            if name not in L:
                continue
            if _COL_BLOCK[name] == "i":
                ints[..., L.i(name)] = v
            else:
                flts[..., L.f(name)] = v
        return Cloudlets(ints, flts, L)


class Instances(NamedTuple):
    """Instance pool (pods/containers; paper §3.3)."""

    status: torch.Tensor      # [I] i32 INST_*
    service: torch.Tensor     # [I] i32 (-1 on free slots)
    vm: torch.Tensor          # [I] i32
    host: torch.Tensor        # [I] i32 physical host (= VM id)
    mips: torch.Tensor        # [I] f32 current CPU allocation (MI/s)
    limit_mips: torch.Tensor  # [I] f32 vertical-scaling cap
    request_mips: torch.Tensor# [I] f32 baseline request
    ram: torch.Tensor         # [I] f32 current RAM allocation (MB)
    limit_ram: torch.Tensor   # [I] f32
    bw: torch.Tensor          # [I] f32 bandwidth (Mbps)
    n_exec: torch.Tensor      # [I] i32 executing cloudlets this tick
    used_mips: torch.Tensor   # [I] f32 consumed this tick
    used_ram: torch.Tensor    # [I] f32 linear cloudlet→RAM model (§5.2)
    used_bw: torch.Tensor     # [I] f32 linear spawn→BW model
    util_ema: torch.Tensor    # [I] f32 smoothed utilization (scaling signal)
    usage_sum: torch.Tensor   # [I] f32 ∫ used_mips dt  (usage history)
    busy_ticks: torch.Tensor  # [I] i32 ticks with n_exec > 0


class VMs(NamedTuple):
    mips: torch.Tensor        # [V] f32 capacity
    mips_used: torch.Tensor   # [V] f32 allocated to instances
    ram: torch.Tensor         # [V] f32
    ram_used: torch.Tensor    # [V] f32


class Hosts(NamedTuple):
    """Per-host hardware description (one host per VM slot)."""

    egress_scale: torch.Tensor    # [H] f32 NIC egress capacity multiplier
    ingress_scale: torch.Tensor   # [H] f32 NIC ingress capacity multiplier
    cpu_scale: torch.Tensor       # [H] f32 execution-rate multiplier


class NetStats(NamedTuple):
    """Network-fabric usage history — all zeros in uniform mode."""

    bytes_out: torch.Tensor
    bytes_in: torch.Tensor
    egress_busy: torch.Tensor
    ingress_busy: torch.Tensor
    transits: torch.Tensor
    transit_sum: torch.Tensor
    hist: torch.Tensor


class FaultState(NamedTuple):
    """Resilience state (the Disruption phase, core/faults.py):
    ``host_up``/``nic_ok`` are [H] in every mode (placement and scaling
    read ``host_up``); every other table is a chaos-only column,
    zero-width with faults off.

    The circuit breaker of an edge is CLOSED while ``edge_open_until <=
    0``, OPEN while ``time < edge_open_until`` (new calls fail fast) and
    HALF-OPEN once the cooldown has passed (probe traffic flows; a
    failure re-opens it, a clean tick closes it).  Outlier ejection
    (``inst_eject_until``) is the same machine per replica: an OPEN
    replica is left out of the dispatch rank table
    (``policies.eject_view``)."""

    host_up: torch.Tensor          # [H] i32 1 = host up
    nic_ok: torch.Tensor           # [H] i32 1 = NIC healthy
    edge_open_until: torch.Tensor  # [E] f32 breaker clock
    edge_err_ema: torch.Tensor     # [E] f32 error-rate EMA per edge
    edge_succ: torch.Tensor        # [E] i32 successes since the last pass
    host_slow: torch.Tensor        # [H] i32 1 = fail-slow episode
    nic_factor: torch.Tensor       # [H] f32 NIC capacity multiplier
    zone_cut: torch.Tensor         # [H, H] i32 zone-pair partition mask
    inst_err_ema: torch.Tensor     # [I] f32 per-replica error-rate EMA
    inst_lat_ema: torch.Tensor     # [I] f32 per-replica sojourn EMA (s)
    inst_eject_until: torch.Tensor # [I] f32 ejection clock
    inst_succ: torch.Tensor        # [I] i32 successes since the last pass
    inst_lat_sum: torch.Tensor     # [I] f32 Σ sojourn of those successes


class FaultStats(NamedTuple):
    """Cumulative resilience history — all zeros with faults off."""

    host_crashes: torch.Tensor
    host_recoveries: torch.Tensor
    inst_kills: torch.Tensor
    failed_attempts: torch.Tensor
    retries: torch.Tensor
    failfast: torch.Tensor
    failed_requests: torch.Tensor
    breaker_trips: torch.Tensor
    down_time_s: torch.Tensor
    ejections: torch.Tensor
    readmissions: torch.Tensor
    zone_faults: torch.Tensor
    partitions: torch.Tensor
    slow_episodes: torch.Tensor
    slow_time_s: torch.Tensor


# One metric row per closed window, in ring-storage order.
TEL_METRIC_COLUMNS = (
    "window",            # window index (monotone, 0-based)
    "time_s",            # sim time at window close
    "tag",               # sweep-point tag (dyn.tel_tag)
    "completed",         # requests completed in the window (sum)
    "generated",         # requests generated in the window (sum)
    "n_waiting",         # gauges sampled at window close ↓
    "n_exec",
    "n_transit",
    "used_mips",
    "active_instances",
    "net_mb_inflight",   # Σ rem_bytes in TRANSIT (fabric mode; else 0)
    "failed_attempts",   # cumulative FaultStats at close (0 faults off)
    "retries",           # cumulative FaultStats at close
    "spans",             # spans recorded so far (cumulative)
    "span_drops",        # spans dropped at ring capacity (cumulative)
)
# Window-summed accumulators (prefix of the row's sum section).
TEL_ACC_COLUMNS = ("completed", "generated")
# One span per sampled finished cloudlet (hop), split by block dtype.
TEL_SPAN_I_COLUMNS = ("req", "service", "inst", "host", "src_host",
                      "edge", "attempt", "wait_ticks")
TEL_SPAN_F_COLUMNS = ("arrival", "start", "finish")


class TelemetryState(NamedTuple):
    """Observability buffers (``telemetry="stream"``; ``repro_torch.obs``),
    zero-width with telemetry off.  The metric ring is flushed in halves:
    while ticks seal rows into one half, the host copies the other,
    just-completed half out.  The span ring is append-until-full: overflow
    never overwrites, it counts every dropped span exactly."""

    ring: torch.Tensor        # [W, K] f32 metric rows (K = TEL_METRIC_…)
    acc: torch.Tensor         # [len(TEL_ACC_COLUMNS)] f32 open-window sums
    win: torch.Tensor         # [1] i32 windows closed so far
    span_i: torch.Tensor      # [SP, NSI] i32 span ints
    span_f: torch.Tensor      # [SP, NSF] f32 span timestamps
    span_n: torch.Tensor      # [1] i32 spans recorded (≤ SP)
    span_drops: torch.Tensor  # [1] i32 spans dropped at capacity
    sample: torch.Tensor      # [R] u8 1 = request is traced (seeded 1-in-k)


def validate_telemetry(params: "SimParams") -> None:
    if params.telemetry not in ("none", "stream"):
        raise ValueError(
            f"SimParams.telemetry must be 'none' or 'stream', "
            f"got {params.telemetry!r}")
    if params.telemetry == "stream":
        if params.tel_windows < 2 or params.tel_windows % 2:
            raise ValueError(
                "SimParams.tel_windows must be an even int ≥ 2 (the ring "
                f"flushes in halves), got {params.tel_windows!r}")
        for f in ("tel_window_ticks", "tel_span_k", "tel_span_cap"):
            v = getattr(params, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"SimParams.{f} must be an int ≥ 1, got {v!r}")
        v = params.tel_span_tick_cap
        if not isinstance(v, int) or v < 0:
            raise ValueError(
                "SimParams.tel_span_tick_cap must be an int ≥ 0 "
                f"(0 = uncapped), got {v!r}")


class AlertState(NamedTuple):
    """Per-service SLO burn-rate alerting state (``alerting="burn"``;
    ``obs/slo.py``), zero-width unless ``telemetry="stream"`` and
    ``alerting="burn"``.  Axes: ``S`` services, ``NR = len(ALERT_RULES)``
    burn rules, ``L`` closed SLI windows (``slo_long_wins``), ``AP``
    event-ring rows (``slo_event_cap``).  The transition ring is
    append-until-full with exact drop counting, as the span ring."""

    sli_win: torch.Tensor      # [L, S, 2] f32 closed windows of (good, bad)
    sli_acc: torch.Tensor      # [S, 2] f32 open-window (good, bad) sums
    win: torch.Tensor          # [1] i32 SLI windows closed so far
    astate: torch.Tensor       # [S, NR] i32 ALERT_INACTIVE..ALERT_RESOLVED
    pending: torch.Tensor      # [S, NR] i32 consecutive ticks condition held
    fires: torch.Tensor        # [S, NR] i32 pending→firing transitions
    resolves: torch.Tensor     # [S, NR] i32 firing→resolved transitions
    firing_ticks: torch.Tensor # [S, NR] i32 ticks spent firing
    hold_until: torch.Tensor   # [S] f32 burn-mode scale-out stabilization
    ev_time: torch.Tensor      # [AP] f32 transition timestamps
    ev_service: torch.Tensor   # [AP] i32
    ev_rule: torch.Tensor      # [AP] i32 index into ALERT_RULES
    ev_state: torch.Tensor     # [AP] i32 new state (index into ALERT_STATES)
    ev_n: torch.Tensor         # [1] i32 transitions recorded (≤ AP)
    ev_drops: torch.Tensor     # [1] i32 transitions dropped at capacity


def validate_alerting(params: "SimParams") -> None:
    if params.alerting not in ("none", "burn"):
        raise ValueError(
            f"SimParams.alerting must be 'none' or 'burn', "
            f"got {params.alerting!r}")
    if params.hs_mode not in HS_MODES:
        raise ValueError(
            f"SimParams.hs_mode must be one of {HS_MODES}, "
            f"got {params.hs_mode!r}")
    if params.alerting == "burn":
        if params.telemetry != "stream":
            raise ValueError(
                "alerting='burn' evaluates rules on the telemetry window "
                "cadence and requires telemetry='stream'")
        for f in ("slo_short_wins", "slo_long_wins", "slo_for_ticks",
                  "slo_event_cap"):
            v = getattr(params, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"SimParams.{f} must be an int ≥ 1, got {v!r}")
        if params.slo_long_wins < params.slo_short_wins:
            raise ValueError(
                "SimParams.slo_long_wins must be ≥ slo_short_wins "
                f"(got {params.slo_long_wins} < {params.slo_short_wins})")
        if not params.slo_eject_tighten > 0:
            raise ValueError(
                "SimParams.slo_eject_tighten must be > 0 (1 disables "
                f"tightening), got {params.slo_eject_tighten!r}")
    elif params.hs_mode == "slo_burn":
        raise ValueError(
            "hs_mode='slo_burn' gates scale-out on firing burn alerts and "
            "requires alerting='burn'")


class SchedState(NamedTuple):
    """Service→replica dispatch tables: ``inst_of_rank[s, r]`` is the
    instance slot of the r-th replica of service ``s`` (-1 beyond
    ``svc_replicas[s]``)."""

    inst_of_rank: torch.Tensor   # [S, R_max] i32
    svc_replicas: torch.Tensor   # [S] i32


class SvcStats(NamedTuple):
    """Per-service usage history and node-delay estimates (§5.2, §4.3.2)."""

    usage_sum: torch.Tensor   # [S] f32 ∫ used_mips dt over replicas
    finished: torch.Tensor    # [S] i32 cloudlets completed
    delay_sum: torch.Tensor   # [S] f32 Σ (finish - arrival) sojourn
    exec_sum: torch.Tensor    # [S] f32 Σ execution time
    wait_sum: torch.Tensor    # [S] f32 Σ waiting time


class Counters(NamedTuple):
    spawned: torch.Tensor         # i32 cloudlets ever created
    finished: torch.Tensor        # i32 cloudlets ever finished
    dropped_cloudlets: torch.Tensor
    dropped_requests: torch.Tensor
    completed: torch.Tensor       # i32 completed requests
    resp_sum: torch.Tensor        # f32 Σ response
    slo_violations: torch.Tensor  # i32
    migrations: torch.Tensor      # i32
    scale_out: torch.Tensor       # i32 HS scale-out events
    scale_in: torch.Tensor        # i32 HS scale-in events
    scale_up: torch.Tensor        # i32 VS scale-up events
    scale_down: torch.Tensor      # i32 VS scale-down events


class SimState(NamedTuple):
    tick: torch.Tensor       # i32
    time: torch.Tensor       # f32 seconds
    rng: torch.Tensor        # PRNG key: int64 [2] on the CPU
    rr: torch.Tensor         # [S] i32 round-robin cursor per service
    clients: Clients
    requests: Requests
    cloudlets: Cloudlets
    instances: Instances
    vms: VMs
    hosts: Hosts
    net: NetStats
    sched: SchedState
    svc_stats: SvcStats
    counters: Counters
    fault: FaultState
    fstats: FaultStats
    telemetry: TelemetryState
    alerts: AlertState


class TickTrace(NamedTuple):
    """Per-tick scalar outputs (QoS time series); stacked over ticks."""

    completed: torch.Tensor
    generated: torch.Tensor
    n_waiting: torch.Tensor
    n_exec: torch.Tensor
    n_transit: torch.Tensor
    used_mips: torch.Tensor
    active_instances: torch.Tensor
    active_clients: torch.Tensor


def edge_table_size(n_services: int, d_max: int, n_apis: int) -> int:
    """Length of every per-service-edge table (``S * d_max`` call edges
    plus one client→entry edge per API)."""
    return n_services * d_max + max(n_apis, 1)


def check_main_path(params: SimParams) -> None:
    """Raise ``ValueError`` for a mode the reference rejects: a network,
    fault, telemetry or alerting mode that does not exist, and the
    telemetry and alerting knobs its validators refuse."""
    if params.network not in ("uniform", "fabric"):
        raise ValueError(
            f"SimParams.network must be 'uniform' or 'fabric', "
            f"got {params.network!r}")
    if params.faults not in ("none", "chaos"):
        raise ValueError(
            f"SimParams.faults must be 'none' or 'chaos', "
            f"got {params.faults!r}")
    validate_telemetry(params)
    validate_alerting(params)


def resolve_device(device) -> torch.device:
    """The simulation's device.  ``"cuda"`` (the default everywhere) with
    no usable GPU raises: the port never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def zeros_state(caps: SimCaps, params: SimParams, rng: torch.Tensor,
                n_services: int = 1, app=None, device="cuda",
                n_edges: int | None = None, n_apis: int = 1) -> SimState:
    """The initial (empty) simulation state on ``device`` — the reference's
    ``zeros_state``, leaf for leaf.  Under ``faults="chaos"`` the edge
    tables are sized from ``app`` (its ``n_edges``), else from
    ``n_edges`` or the caps-derived bound for ``n_apis`` APIs, as the
    reference sizes them; the other chaos tables from the pools."""
    caps.validate()
    check_main_path(params)
    f32, i32 = torch.float32, torch.int32
    Nc, R, C, I, V = (caps.n_clients, caps.max_requests, caps.max_cloudlets,
                      caps.max_instances, caps.n_vms)
    if app is not None:
        n_services = int(app.n_services)
        n_edges = int(app.n_edges)
    S = n_services
    chaos = params.faults == "chaos"
    E = n_edges if n_edges is not None \
        else edge_table_size(n_services, caps.d_max, n_apis)
    if not chaos:
        E = 0
    Hc, Ic = (V, I) if chaos else (0, 0)
    layout = resolve_layout(params)
    dev = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return SimState(
        tick=z((), i32),
        time=z((), f32),
        rng=rng.to("cpu", torch.int64),
        rr=z((S,), i32),
        clients=Clients(wait=z((Nc,), i32)),
        requests=Requests(
            count=z((), i32), api=full((R,), -1, i32),
            arrival=full((R,), -1.0, f32), outstanding=z((R,), i32),
            spawned=z((R,), i32), finish=z((R,), f32),
            response=full((R,), -1.0, f32), critical_len=z((R,), i32),
            failed=z((R if chaos else 0,), torch.uint8)),
        cloudlets=Cloudlets(
            ints=torch.from_numpy(layout.init_ints()).to(dev)
            .repeat(C, 1),
            flts=torch.from_numpy(layout.init_flts()).to(dev)
            .repeat(C, 1),
            layout=layout),
        instances=Instances(
            status=z((I,), i32), service=full((I,), -1, i32),
            vm=full((I,), -1, i32), host=full((I,), -1, i32),
            mips=z((I,), f32), limit_mips=z((I,), f32),
            request_mips=z((I,), f32), ram=z((I,), f32),
            limit_ram=z((I,), f32), bw=z((I,), f32), n_exec=z((I,), i32),
            used_mips=z((I,), f32), used_ram=z((I,), f32),
            used_bw=z((I,), f32), util_ema=z((I,), f32),
            usage_sum=z((I,), f32), busy_ticks=z((I,), i32)),
        vms=VMs(mips=z((V,), f32), mips_used=z((V,), f32),
                ram=z((V,), f32), ram_used=z((V,), f32)),
        hosts=Hosts(egress_scale=full((V,), 1.0, f32),
                    ingress_scale=full((V,), 1.0, f32),
                    cpu_scale=full((V,), 1.0, f32)),
        net=NetStats(bytes_out=z((V,), f32), bytes_in=z((V,), f32),
                     egress_busy=z((V,), f32), ingress_busy=z((V,), f32),
                     transits=z((), i32), transit_sum=z((), f32),
                     hist=z((caps.net_hist_buckets,), i32)),
        sched=SchedState(inst_of_rank=full((S, caps.max_replicas), -1, i32),
                         svc_replicas=z((S,), i32)),
        svc_stats=SvcStats(usage_sum=z((S,), f32), finished=z((S,), i32),
                           delay_sum=z((S,), f32), exec_sum=z((S,), f32),
                           wait_sum=z((S,), f32)),
        counters=Counters(*([z((), i32) for _ in range(5)] + [z((), f32)]
                            + [z((), i32) for _ in range(6)])),
        fault=FaultState(
            host_up=full((V,), 1, i32), nic_ok=full((V,), 1, i32),
            edge_open_until=z((E,), f32), edge_err_ema=z((E,), f32),
            edge_succ=z((E,), i32), host_slow=z((Hc,), i32),
            nic_factor=full((Hc,), 1.0, f32), zone_cut=z((Hc, Hc), i32),
            inst_err_ema=z((Ic,), f32), inst_lat_ema=z((Ic,), f32),
            inst_eject_until=z((Ic,), f32), inst_succ=z((Ic,), i32),
            inst_lat_sum=z((Ic,), f32)),
        fstats=FaultStats(*([z((), i32) for _ in range(8)] + [z((), f32)]
                            + [z((), i32) for _ in range(5)]
                            + [z((), f32)])),
        telemetry=_zeros_telemetry(params, rng, R, dev),
        alerts=_zeros_alerts(params, S, dev),
    )


def _zeros_telemetry(params: SimParams, rng: torch.Tensor, R: int,
                     dev) -> TelemetryState:
    """Initial telemetry state: zero-width under ``telemetry="none"``,
    sized from the tel_* knobs under ``"stream"``.  The 1-in-k span
    sample is drawn once here from a key folded off the root under the
    name ``"tel_sample"``: the fold leaves the root untouched, so every
    simulation stream is the same with telemetry on or off."""
    f32, i32 = torch.float32, torch.int32
    on = params.telemetry == "stream"
    K, NA = len(TEL_METRIC_COLUMNS), len(TEL_ACC_COLUMNS)
    NSI, NSF = len(TEL_SPAN_I_COLUMNS), len(TEL_SPAN_F_COLUMNS)
    W = params.tel_windows if on else 0
    SP = params.tel_span_cap if on else 0
    one = 1 if on else 0
    if on:
        k_sample = streams.fold_in(rng, 0, name="tel_sample")
        # the reference compares against the Python double, which JAX's
        # weak typing rounds to float32
        thresh = float(np.float32(1.0 / params.tel_span_k))
        sample = (rnd.uniform(k_sample, (R,), device=dev)
                  < thresh).to(torch.uint8)
    else:
        sample = torch.zeros((0,), dtype=torch.uint8, device=dev)
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
    return TelemetryState(
        ring=z((W, K), f32), acc=z((NA if on else 0,), f32),
        win=z((one,), i32), span_i=z((SP, NSI), i32),
        span_f=z((SP, NSF), f32), span_n=z((one,), i32),
        span_drops=z((one,), i32), sample=sample)


def _zeros_alerts(params: SimParams, S: int, dev) -> AlertState:
    """Initial alert state: zero-width unless the Alerting stage runs
    (``telemetry="stream"`` and ``alerting="burn"``).  Draws no key."""
    f32, i32 = torch.float32, torch.int32
    on = params.telemetry == "stream" and params.alerting == "burn"
    NR = len(ALERT_RULES)
    Sa = S if on else 0
    L = params.slo_long_wins if on else 0
    AP = params.slo_event_cap if on else 0
    one = 1 if on else 0
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
    return AlertState(
        sli_win=z((L, Sa, 2), f32), sli_acc=z((Sa, 2), f32),
        win=z((one,), i32), astate=z((Sa, NR), i32),
        pending=z((Sa, NR), i32), fires=z((Sa, NR), i32),
        resolves=z((Sa, NR), i32), firing_ticks=z((Sa, NR), i32),
        hold_until=z((Sa,), f32), ev_time=z((AP,), f32),
        ev_service=z((AP,), i32), ev_rule=z((AP,), i32),
        ev_state=z((AP,), i32), ev_n=z((one,), i32),
        ev_drops=z((one,), i32))
