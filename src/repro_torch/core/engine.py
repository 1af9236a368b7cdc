"""Simulation engine: one tick per paper event cycle, looped over time.

``make_tick`` assembles the event phases of paper §3.2 —
Generation → (Disruption, chaos mode) → (Transit, fabric mode) →
Dispatching → Scheduling → Derivative → Response → Scaling & Migration —
into one state transition.
``Simulation`` runs it as ``TickLoop``'s step over fixed buffers: the
step reads its keys from a ``random.KeyTable`` at a device counter, writes
its trace into preallocated buffers at that row and its next state back
into the buffers it read.  On the card the step is captured once as CUDA
graphs (an ordinary tick and a scaling tick, in one memory pool) and
replayed once per tick — the counterpart of the reference's jitted scan;
on the CPU, and on the card when a ``probe`` is passed, the same step runs
eagerly.  The loop never synchronises with the device: the key schedule
and the scaling cadence are pure functions of the tick index, computed
on the host, and every data-dependent choice is a tensor select.

The tick runs over a batch of sweep points (``core.batch``): a solo
``run`` is a batch of one, and ``run_batch`` runs a parameter sweep as
one batched tick a tick, the counterpart of the reference's vmapped
scan, with one capture for every sweep of the same number of points.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .. import random as rnd
from ..analysis import annotate, streams
from ..obs import slo as slomod
from ..obs import telemetry as telmod
from . import batch as batchmod
from . import faults as faultsmod
from . import network as netmod
from . import policies, pool, scheduler
from .app import AppStatic, InstanceTemplate, build_app, validate_app
from .batch import dyn_host
from .generator import client_phase
from .graph import ServiceGraph
from .placement import initial_allocation, migrate
from .scaling import scaling_event
from .types import (CL_EXEC, CL_TRANSIT, CL_WAITING, Cloudlets, DynParams,
                    INST_ON, SimCaps, SimParams, SimState, TickTrace,
                    _F32_FIELDS, check_main_path, resolve_device,
                    zeros_state)

# Stream names of the tick's single wide split; positions are the
# contract (split is not prefix-stable, so the fabric's two extra streams
# and chaos mode's three change every key), names are the audit labels.
# "carry" is the next tick's root key.
KEY_NAMES = ("carry", "gen", "spawn", "lb", "derive")
FABRIC_KEY_NAMES = KEY_NAMES + ("net_gen", "net_derive")
CHAOS_KEY_NAMES = ("faults", "retry_len", "retry_net")


def key_names(params: SimParams) -> tuple:
    """The names of the tick's streams for ``params``' modes."""
    return ((FABRIC_KEY_NAMES if params.network == "fabric" else KEY_NAMES)
            + (CHAOS_KEY_NAMES if params.faults == "chaos" else ()))


def carry_path(params: SimParams) -> tuple:
    """Where the next tick's root key lies below this tick's, as
    ``random.chain`` takes it."""
    names = key_names(params)
    return ((len(names), names.index("carry")),)


# Observers of the capture-cache key of every run (``Simulation._advance``
# calls each with it): the recompile sentinel's hook on the CPU, where
# nothing is captured (``analysis.recompile``).
KEY_WATCHERS: list = []


def make_tick(caps: SimCaps, params: SimParams,
              has_edges: bool = True) -> Callable:
    """Build the tick function ``tick(state, dyn, app, key, scale_due,
    probe)``, over a batch: every leaf of ``state`` (its key apart), of
    ``app`` and of ``dyn`` carries a leading axis of ``B`` sweep points
    (``core.batch``; a solo run is a batch of one).

    ``params`` supplies the knobs that choose program structure.
    ``network="fabric"`` adds the Transit phase (core/network.py) between
    Generation and Dispatch; ``faults="chaos"`` adds the Disruption phase
    (core/faults.py) after Generation, drawing from the tick's last three
    streams.  ``telemetry="stream"`` adds the Telemetry ops (the span
    pass after Execute, the window close after the Trace; obs/telemetry.py)
    and ``alerting="burn"`` the Alerting stage after the span pass
    (obs/slo.py), both before Derive, as the reference orders them; they
    draw no key.
    ``key`` is the tick's root key (the role of ``state.rng``: a host key
    or a ``random.TableKey``), one for every point; the tick draws from
    its streams and leaves ``state.rng`` to the caller, who derives the
    next root (``carry_path``).  ``scale_due`` says whether this tick
    ends a scaling interval: a host bool for all points (the hoisted
    cadence of a sweep that shares one interval), or ``"mask"``, which
    runs the scaling phase and keeps its result only at the points whose
    own interval ends at this tick (``(tick % interval) == interval - 1``
    on the device), every other point's state as it was.  ``probe``, when
    given, is called with each phase name just before the phase runs (the
    Disruption phase's stages as ``"Disruption/<stage>"``) and with
    ``"end"`` after the last one — the hook behind the per-phase
    CUDA-event timings (``obs/profile.py``).
    """
    check_main_path(params)
    scales = bool(params.scaling_policy or params.migration_enabled)
    network = params.network == "fabric"
    chaos = params.faults == "chaos"
    telemetry = params.telemetry == "stream"
    alerting = telemetry and params.alerting == "burn"
    names = key_names(params)

    def tick(state: SimState, dyn: DynParams, app: AppStatic, key,
             scale_due=False,
             probe: Optional[Callable[[str], None]] = None
             ) -> Tuple[SimState, TickTrace]:
        mark = probe or (lambda name: None)
        keys = streams.split(key, len(names), names=names)
        k_gen, k_gen2, k_lb, k_der = keys[1:5]
        k_net_g, k_net_d = (keys[5], keys[6]) if network else (None, None)

        mark("Generation")
        gen = client_phase(state.clients.wait, state.time,
                           state.requests.count, app.api_cdf, dyn, k_gen)
        state, gen_res = scheduler.gen_spawn(
            state, app, caps, gen.fired, gen.api, gen.wait_proposal,
            k_gen2, dyn, params=params, net_rng=k_net_g)

        if chaos:
            mark("Disruption")
            state = faultsmod.disruption(
                state, app, caps, params, dyn, keys[-3], keys[-2],
                keys[-1] if network else None, probe=probe)

        if network:
            mark("Transit")
            state = netmod.transit(state, caps, params, dyn, app)

        mark("Dispatch")
        state = scheduler.dispatch(state, app, caps, params, dyn, k_lb,
                                   network=network)

        mark("Execute")
        state, fin_info = scheduler.execute(state, app, caps, params, dyn)

        # the span pass reads the finished rows before Derive respawns
        # over the freed slots
        if telemetry:
            mark("Telemetry")
            state = telmod.record_spans(state, fin_info, params)
        if alerting:
            mark("Alerting")
            state = slomod.alert_step(state, fin_info, params, dyn, app)

        if has_edges:  # edge-free graphs skip the spawn machinery
            mark("Derive")
            state = scheduler.derive(state, app, caps, fin_info, k_der,
                                     params=params, net_rng=k_net_d)

        mark("Response")
        state, n_done = scheduler.complete(state, dyn, faults=chaos)

        if scales and scale_due:
            mark("Scaling")
            scaled = scaling_event(state, app, caps, params, dyn)
            if params.migration_enabled:
                scaled = migrate(scaled, app, caps, dyn)
            if scale_due == "mask":
                si = dyn.scale_interval
                scaled = _select((state.tick % si) == si - 1, scaled, state)
            state = scaled

        mark("Trace")
        cs = state.cloudlets.status
        count = lambda m: torch.sum(m, dim=1, dtype=torch.int32)
        trace = TickTrace(
            completed=n_done,
            generated=gen_res.n_new_requests,
            n_waiting=count(cs == CL_WAITING),
            n_exec=count(cs == CL_EXEC),
            n_transit=count(cs == CL_TRANSIT),
            used_mips=pool.tree_sum(state.instances.used_mips, dim=1),
            active_instances=count(state.instances.status == INST_ON),
            active_clients=gen.n_active,
        )
        if telemetry:
            mark("Telemetry")
            state = telmod.close_window(state, params, dyn, trace)
        state = state._replace(tick=state.tick + 1,
                               time=state.time + dyn.dt)
        mark("end")
        return state, trace

    return tick


def _select(mask: torch.Tensor, a, b):
    """Per point: ``a``'s leaf where ``mask`` (``[B]``), else ``b``'s;
    leaves ``a`` shares with ``b`` are taken as they are."""
    if a is b:
        return a
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    if isinstance(a, Cloudlets):
        return Cloudlets(_select(mask, a.ints, b.ints),
                         _select(mask, a.flts, b.flts), a.layout)
    return type(a)(*[_select(mask, x, y) for x, y in zip(a, b)])


def _leaves(tree) -> list:
    """The tensors of a state, in field order (the cloudlet pool's two
    blocks in place of the pool)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Cloudlets):
        return [tree.ints, tree.flts]
    return [t for v in tree for t in _leaves(v)]


def _clone(tree):
    """A copy of a state with every tensor in storage of its own."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, Cloudlets):
        return Cloudlets(tree.ints.clone(), tree.flts.clone(), tree.layout)
    return type(tree)(*[_clone(v) for v in tree])


def _write_back(dst, src) -> None:
    """Copy each leaf of ``src`` that is not ``dst``'s own tensor into
    it (a leaf without ``dst``'s batch axis is broadcast over it).  A
    leaf sharing storage with any leaf of ``dst`` is cloned first, so no
    copy overwrites what a later one reads."""
    dsts, srcs = _leaves(dst), _leaves(src)
    held = {t.untyped_storage().data_ptr() for t in dsts if t.numel()}
    pairs = []
    for d, s in zip(dsts, srcs):
        if s is d or d.numel() == 0:
            continue
        if s.untyped_storage().data_ptr() in held:
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


def _upload(host: np.ndarray, dst: torch.Tensor) -> None:
    """Copy a host array into a device buffer without synchronising
    (through pinned memory on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if dst.device.type == "cuda":
        t = t.pin_memory()
    dst.copy_(t, non_blocking=True)


def stack_dyn(dyns) -> DynParams:
    """Stack per-point :class:`DynParams` into the batched tuple
    ``run_batch`` consumes (leading axis = sweep point; ``[B]`` CPU
    tensors)."""
    rows = [dyn_host(d) for d in dyns]
    return DynParams(*[torch.from_numpy(np.concatenate(col))
                       for col in zip(*rows)])


class TickLoop:
    """The tick as a step over fixed buffers.  Each ``step`` reads its
    keys from ``keys`` at the step counter, writes the tick's trace into
    ``[cap, B]`` buffers at that row, writes the next state back into
    ``state`` (the buffers it read) and advances the counter, so every
    tick reads and writes the same addresses: the step can be captured
    once as a CUDA graph and replayed.  The swept values (``dyn``: one
    ``[n_fields, B]`` int32 buffer, float fields viewed as float32) and
    the application (``app``: ``[B, ...]``) are buffers too, so a capture
    bakes no swept value and serves every sweep of ``B`` points.  ``load``
    starts a run: it copies the start state in (a solo state broadcast
    over the batch) and fills the key table with the run's root keys,
    and the swept values and application where given.  ``err`` is the
    checked mode's error word (``analysis.annotate``): each step's checks
    OR into it, ``load`` clears it, and the run reads it after its
    loop."""

    def __init__(self, tick: Callable, dyn: DynParams, app: AppStatic,
                 state: SimState, cap: int):
        dev = state.tick.device
        host = dyn_host(dyn)
        self.tick, self.cap, self.B = tick, cap, len(host.dt)
        B = self.B
        self._dyn = torch.empty((len(host), B), dtype=torch.int32,
                                device=dev)
        self.dyn = DynParams(*[
            row.view(torch.float32) if f in _F32_FIELDS else row
            for f, row in zip(DynParams._fields, self._dyn)])
        lead = app.succ.dim() - 2          # 1 for a batched app
        self.app = AppStatic(*[torch.empty((B,) + tuple(t.shape[lead:]),
                                           dtype=t.dtype, device=dev)
                               for t in app])
        if state.tick.dim() == 0:
            state = batchmod.lift(state, B)
        self.state = _clone(state._replace(rng=_root(state.rng)))
        self.keys = rnd.KeyTable(cap, dev)
        self.err = annotate.new_word(dev)
        self.trace: Optional[TickTrace] = None
        self.set_dyn(host)
        self.set_app(app)

    def set_dyn(self, dyn: DynParams) -> None:
        host = dyn_host(dyn)
        if len(host.dt) != self.B:
            raise ValueError(f"{len(host.dt)} sweep points for a loop of "
                             f"{self.B}")
        rows = np.stack([v.view(np.int32) for v in host])
        _upload(rows, self._dyn)

    def set_app(self, app: AppStatic) -> None:
        for d, s in zip(self.app, app):
            d.copy_(s)

    def load(self, state: SimState, roots: np.ndarray,
             dyn: Optional[DynParams] = None,
             app: Optional[AppStatic] = None) -> None:
        _write_back(self.state, state._replace(rng=_root(state.rng)))
        self.keys.fill(roots)
        self.err.zero_()
        if dyn is not None:
            self.set_dyn(dyn)
        if app is not None:
            self.set_app(app)

    def step(self, scale_due=False,
             probe: Optional[Callable[[str], None]] = None) -> None:
        with annotate.collecting(self.err):
            out, tr = self.tick(self.state, self.dyn, self.app,
                                self.keys.root(), scale_due, probe)
        if self.trace is None:
            self.trace = TickTrace(*[
                torch.empty((self.cap, self.B), dtype=v.dtype,
                            device=v.device) for v in tr])
        row = self.keys.step.view(1)
        for buf, v in zip(self.trace, tr):
            buf.index_copy_(0, row, v.reshape(1, self.B))
        _write_back(self.state, out)
        self.keys.advance()

    def traces(self, n: int) -> TickTrace:
        """The first ``n`` ticks' traces, ``[n, B]``."""
        if self.trace is None or n == 0:
            empty = torch.zeros((0, self.B), device=self.state.tick.device)
            return TickTrace(*[empty] * 8)
        return TickTrace(*[b[:n].clone() for b in self.trace])


def _root(rng: torch.Tensor) -> torch.Tensor:
    """A state's host key: a batched state's keys are all the same."""
    return rng[0] if rng.dim() == 2 else rng


class TickGraphs:
    """``TickLoop``'s step captured as CUDA graphs, one per variant of
    the scaling cadence (``False``: the ordinary tick; ``True``: the
    scaling tick; ``"mask"``: the scaling tick kept per point), in one
    memory pool.

    The capture first runs each variant once on a side stream (loading
    the libraries, setting the kernels' scratch, shared-memory limits and
    cuBLAS state, and adding every key stream to the table), then
    captures it.  Launches made while compiling go to a tally: each
    graph's own are added to ``kernels.counts`` at every replay.
    ``compile_time_s`` is the warm-up and capture time.  ``captures``
    counts the captures made in this process (the recompile sentinel's
    counter, ``analysis.recompile``)."""

    captures = 0

    def __init__(self, loop: TickLoop, variants: tuple, state: SimState,
                 roots: np.ndarray):
        dev = loop.state.tick.device
        TickGraphs.captures += 1
        t0 = _time.perf_counter()
        self.loop = loop
        loop.load(state, roots)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with kernels.tally(), torch.cuda.stream(side):
            for due in variants:
                loop.keys.rewind()
                loop.step(due)
        torch.cuda.current_stream(dev).wait_stream(side)
        pool_ = torch.cuda.graph_pool_handle()
        self.graphs = {}
        for due in variants:
            graph = torch.cuda.CUDAGraph()
            with kernels.tally() as launches:
                with torch.cuda.graph(graph, pool=pool_):
                    loop.step(due)
            self.graphs[due] = (graph, launches)
        torch.cuda.synchronize(dev)
        self.compile_time_s = _time.perf_counter() - t0

    def run(self, state: SimState, roots: np.ndarray, due: list,
            dyn: DynParams, app: AppStatic, flush_at=(), flusher=None
            ) -> Tuple[SimState, TickTrace]:
        """Replay one graph per tick (the variant ``due`` names), and
        flush the metric ring after the ticks ``flush_at`` names (their
        indices in ``due``) through ``flusher`` (``obs.telemetry``)."""
        self.loop.load(state, roots, dyn, app)
        for i, d in enumerate(due):
            graph, launches = self.graphs[d]
            graph.replay()
            kernels.add_counts(launches)
            if i in flush_at:
                flusher.flush(self.loop.state.telemetry)
        return _clone(self.loop.state), self.loop.traces(len(due))


@dataclasses.dataclass
class SimResult:
    """A run's final state and per-tick traces.  ``wall_time_s`` excludes
    ``compile_time_s``: on the card, the warm-up and capture of the tick's
    CUDA graphs (0.0 when the run replayed graphs captured by an earlier
    run); on the CPU, where the tick runs eagerly, 0.0.  A ``run_batch``
    result holds the whole sweep: every state leaf (its key too) and
    every trace with a leading sweep axis (traces ``[B, T]``)."""
    state: SimState
    trace: TickTrace          # each field stacked over ticks: [T] or [B, T]
    wall_time_s: float
    compile_time_s: float

    def trace_np(self) -> dict:
        return {k: v.cpu().numpy() for k, v in self.trace._asdict().items()}


def batch_item(result: SimResult, b: int) -> SimResult:
    """Slice one sweep point out of a :meth:`Simulation.run_batch` result
    (wall/compile times are those of the whole batch)."""
    return SimResult(state=batchmod.item(result.state, b),
                     trace=batchmod.item(result.trace, b),
                     wall_time_s=result.wall_time_s,
                     compile_time_s=result.compile_time_s)


class Simulation:
    """User-facing façade (paper Fig 4 ``Application`` + ``Register``).

    >>> sim = Simulation(graph, caps=SimCaps(...), params=SimParams(...))
    >>> result = sim.run()

    ``device`` defaults to ``"cuda"``; without a GPU that raises unless
    the caller asks for ``device="cpu"``.  On the card, runs replay the
    tick's CUDA graphs, captured at the first run of a structure and kept
    in a cache of the class, ``Simulation._graphs``, as the reference
    keeps its compiled programs: every ``Simulation`` of the same
    structure (caps, the knobs of ``_STATIC_FIELDS``, the device, the
    number of points, the scaling cadence's variants, the state's and the
    application's leaf shapes, checked mode) replays the same graphs, its
    own swept values and application loaded into their buffers; a failed
    capture raises.

    Memory: a cached capture holds its loop's buffers (a state, the
    traces of ``n_ticks`` ticks, the key table) and its graphs' pool on
    the device for as long as it stays in the cache, whether or not a
    ``Simulation`` of its structure is alive; a structure keeps one
    capture (a longer run's replaces a shorter one's).  Call
    :meth:`clear_captures` to free them all.
    """

    # the capture cache, shared by every Simulation (see above)
    _graphs: dict = {}

    def __init__(self, graph: ServiceGraph,
                 caps: SimCaps | None = None,
                 params: SimParams | None = None,
                 templates: dict[str, InstanceTemplate] | None = None,
                 default_template: InstanceTemplate | None = None,
                 vm_mips: np.ndarray | None = None,
                 vm_ram: np.ndarray | None = None,
                 api_entries=None,
                 host_egress_scale: np.ndarray | None = None,
                 host_ingress_scale: np.ndarray | None = None,
                 placement_policy: int | None = None,
                 host_zone: np.ndarray | None = None,
                 host_cpu_scale: np.ndarray | None = None,
                 service_slo_ms: np.ndarray | None = None,
                 service_slo_budget: np.ndarray | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.graph = graph
        self.caps = caps or SimCaps()
        self.params = params or SimParams()
        V = self.caps.n_vms
        self.app = build_app(graph, templates, default_template, api_entries,
                             n_hosts=V, host_zone=host_zone,
                             slo_target_ms=service_slo_ms,
                             slo_budget=service_slo_budget,
                             device=self.device)
        # fail on out-of-range ids now, with the offending entry named
        validate_app(self.app, self.caps)
        ones = np.ones(V)
        self.vm_mips = np.asarray(
            vm_mips if vm_mips is not None else np.full(V, 32_000.0),
            np.float32)
        self.vm_ram = np.asarray(
            vm_ram if vm_ram is not None else np.full(V, 65_536.0),
            np.float32)
        if len(self.vm_mips) != V or len(self.vm_ram) != V:
            raise ValueError("vm_mips/vm_ram must have n_vms entries")
        self.host_egress_scale = np.asarray(
            host_egress_scale if host_egress_scale is not None else ones,
            np.float32)
        self.host_ingress_scale = np.asarray(
            host_ingress_scale if host_ingress_scale is not None else ones,
            np.float32)
        self.host_cpu_scale = np.asarray(
            host_cpu_scale if host_cpu_scale is not None else ones,
            np.float32)
        if len(self.host_egress_scale) != V \
                or len(self.host_ingress_scale) != V \
                or len(self.host_cpu_scale) != V:
            raise ValueError("host NIC/CPU scales must have n_vms entries")
        self.placement_policy = (policies.PLACE_MOST_AVAILABLE
                                 if placement_policy is None
                                 else placement_policy)
        self._has_edges = bool(np.asarray(graph.n_succ).sum() > 0)
        self._tick = make_tick(self.caps, self.params, self._has_edges)
        self._flushes: list = []     # telemetry flushes still in flight

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> SimState:
        dev = self.device
        rng = rnd.PRNGKey(self.params.seed if seed is None else seed)
        state = zeros_state(self.caps, self.params, rng, app=self.app,
                            device=dev)
        host = lambda t: t.detach().cpu().numpy()
        app = self.app
        inst, iof, reps = initial_allocation(
            host(app.tmpl_replicas), host(app.tmpl_mips),
            host(app.tmpl_limit_mips), host(app.tmpl_ram),
            host(app.tmpl_limit_ram), host(app.tmpl_bw),
            self.vm_mips, self.vm_ram, self.caps,
            policy=self.placement_policy)
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        instances = state.instances._replace(
            **{k: t(v) for k, v in inst.items()})
        vm_used_m = np.zeros_like(self.vm_mips)
        vm_used_r = np.zeros_like(self.vm_ram)
        for i in range(self.caps.max_instances):
            v = inst["vm"][i]
            if v >= 0:
                vm_used_m[v] += inst["mips"][i]
                vm_used_r[v] += inst["ram"][i]
        vms = state.vms._replace(
            mips=t(self.vm_mips), ram=t(self.vm_ram),
            mips_used=t(vm_used_m), ram_used=t(vm_used_r))
        sched = state.sched._replace(inst_of_rank=t(iof),
                                     svc_replicas=t(reps))
        hosts = state.hosts._replace(
            egress_scale=t(self.host_egress_scale),
            ingress_scale=t(self.host_ingress_scale),
            cpu_scale=t(self.host_cpu_scale))
        return state._replace(instances=instances, vms=vms, sched=sched,
                              hosts=hosts)

    def scale_due(self, tick: int) -> bool:
        """Whether tick ``tick`` ends a scaling interval."""
        si = int(self.params.scale_interval)
        return tick % si == si - 1

    # Every SimParams knob that selects program structure (anything not
    # carried by the swept DynParams): the capture cache and run_batch's
    # checks both derive from this list, as the reference's do.  seed is
    # absent: it only feeds init_state's key.
    _STATIC_FIELDS = ("lb_policy", "share_policy", "scaling_policy",
                      "migration_enabled", "n_ticks", "use_pallas_tick",
                      "pallas_interpret", "network", "waterfill_iters",
                      "net_hist_bin_s", "faults", "egress_shaping",
                      "telemetry", "tel_window_ticks", "tel_windows",
                      "tel_span_k", "tel_span_cap", "tel_span_tick_cap",
                      "alerting",
                      "slo_short_wins", "slo_long_wins", "slo_for_ticks",
                      "slo_event_cap")

    def _static_key(self) -> tuple:
        p = self.params
        return (self.caps, self._has_edges, p.max_concurrent > 0,
                tuple(getattr(p, f) for f in self._STATIC_FIELDS))

    def _cadence(self, si: np.ndarray, first_tick: int, n: int):
        """(each tick's graph variant, the variants the run needs) for
        ticks ``first_tick`` .. ``first_tick + n - 1`` of points with
        scaling intervals ``si``: the cadence is hoisted to the host when
        every point shares its interval; otherwise a tick where some
        point's interval ends runs the per-point ``"mask"`` variant."""
        if not self._scales:
            return [False] * n, (False,)
        ticks = np.arange(first_tick, first_tick + n)[:, None]
        due = ticks % si == si - 1                            # [n, B]
        if (si == si[0]).all():
            return [bool(d) for d in due[:, 0]], (False, True)
        return ["mask" if d.any() else False for d in due], (False, "mask")

    def _capture_key(self, state: SimState, B: int, variants: tuple,
                     app: Optional[AppStatic] = None) -> tuple:
        """The capture cache's key of a run of ``B`` points from states
        shaped as ``state`` in the cadence ``variants`` (with a sweep's
        stacked ``app``): the structure only, as the reference's compile
        key — the swept values and the application's values live in the
        loop's buffers."""
        app = self.app if app is None else app
        solo = state if state.tick.dim() == 0 else batchmod.item(state, 0)
        lead = app.succ.dim() - 2          # 1 for a batched app
        return (self._static_key(), annotate.checked_mode(),
                str(self.device), B, variants,
                self._shape_key(_leaves(solo)),
                tuple((tuple(t.shape[lead:]), t.dtype) for t in app))

    def _graphs_for(self, key: tuple, state: SimState, variants: tuple,
                    n: int, dyn: DynParams, app: AppStatic
                    ) -> Tuple[TickGraphs, float]:
        """The captured tick of ``key`` (``_capture_key``) holding at
        least ``n`` ticks of keys and traces, and the capture time (0.0
        when cached)."""
        hit = Simulation._graphs.get(key)
        if hit is not None and hit.loop.cap >= n:
            return hit, 0.0
        Simulation._graphs.pop(key, None)    # free a smaller capture first
        del hit
        cap = max(n, int(self.params.n_ticks), 2)
        loop = TickLoop(self._tick, dyn, app, state, cap)
        roots, _ = rnd.chain(_root(state.rng), 1, carry_path(self.params))
        graphs = TickGraphs(loop, variants, state, roots)
        Simulation._graphs[key] = graphs
        return graphs, graphs.compile_time_s

    @classmethod
    def clear_captures(cls) -> None:
        """Drop every cached capture (their device memory goes back to
        PyTorch's allocator)."""
        cls._graphs.clear()

    def captured(self, state: SimState) -> Optional[TickGraphs]:
        """The cached capture of this Simulation's solo runs from states
        shaped as ``state``, or None."""
        dyn = dyn_host(DynParams.from_params(self.params))
        variants = self._cadence(dyn.scale_interval, 0, 1)[1]
        return Simulation._graphs.get(self._capture_key(state, 1, variants))

    @property
    def _scales(self) -> bool:
        return bool(self.params.scaling_policy
                    or self.params.migration_enabled)

    def compile(self, state: SimState, n_ticks: Optional[int] = None
                ) -> float:
        """Capture the tick's CUDA graphs for solo runs from states shaped
        as ``state`` (on the card; a no-op on the CPU) and return the time
        it took, 0.0 if they were captured before."""
        dyn = dyn_host(DynParams.from_params(self.params))
        return self._compile(state, dyn, None, n_ticks)

    def _compile(self, state: SimState, dyn: DynParams,
                 app: Optional[AppStatic], n_ticks: Optional[int]) -> float:
        if self.device.type != "cuda":
            return 0.0
        n = self.params.n_ticks if n_ticks is None else n_ticks
        variants = self._cadence(dyn.scale_interval, 0, 1)[1]
        app = self.app if app is None else app
        key = self._capture_key(state, len(dyn.dt), variants, app)
        return self._graphs_for(key, state, variants, n, dyn, app)[1]

    def _advance(self, state: SimState, dyn: DynParams,
                 app: Optional[AppStatic], n: int, first_tick: int,
                 probe: Optional[Callable[[str], None]]
                 ) -> Tuple[SimState, TickTrace]:
        """``n`` ticks of the batch ``dyn`` (``[B]`` host arrays) from
        ``state`` (solo: broadcast over the batch): the batched final
        state (its key ``[B, 2]``) and traces ``[n, B]``."""
        B = len(dyn.dt)
        app = self.app if app is None else app
        roots, carry = rnd.chain(_root(state.rng), n,
                                 carry_path(self.params))
        due, variants = self._cadence(dyn.scale_interval, first_tick, n)
        flush_at = telmod.flush_after(self.params, first_tick, n)
        flusher = telmod.Flusher(self.params, len(flush_at), B,
                                 self.device) if flush_at else None
        flush_at = frozenset(flush_at)
        self.deliver_rows(wait=False)
        key = self._capture_key(state, B, variants, app)
        for watch in KEY_WATCHERS:
            watch(key)
        if self.device.type == "cuda" and probe is None:
            graphs = self._graphs_for(key, state, variants, n, dyn, app)[0]
            loop = graphs.loop
            out, trace = graphs.run(state, roots, due, dyn, app, flush_at,
                                    flusher)
        else:
            loop = TickLoop(self._tick, dyn, app, state, max(n, 1))
            loop.keys.fill(roots)
            for i, d in enumerate(due):
                loop.step(d, probe)
                if i in flush_at:
                    flusher.flush(loop.state.telemetry)
            out, trace = loop.state, loop.traces(n)
        if key[1]:
            # checked mode: the loop's error word, read once after it
            annotate.throw(loop.err)
        if flusher is not None:
            self._flushes.append(flusher)
            self.deliver_rows(wait=False)
        return out._replace(rng=carry.expand(B, 2)), trace

    def deliver_rows(self, wait: bool = True) -> None:
        """Hand the metric rows flushed by earlier runs to the exporter
        (``obs.export``), in the order they were flushed: those whose
        copy to the host has completed, or with ``wait`` all of them,
        waiting for the copies still in flight.  A run's flushes copy
        asynchronously on the card; ``run`` and ``run_batch`` deliver
        them all before they drain the ring's tail."""
        while self._flushes:
            f = self._flushes[0]
            if wait:
                f.finish()
            else:
                f.poll()
            if f.pending:
                return
            self._flushes.pop(0)

    def _export(self, state: SimState, tags: np.ndarray) -> None:
        """The end of a run with telemetry on: every flushed row, then the
        ring's sealed tail and the alert transitions, to the exporter."""
        if self.params.telemetry != "stream":
            return
        self.deliver_rows()
        telmod.drain_to_exporter(state, self.params)
        slomod.drain_to_exporter(state, self.params, tags=tags)

    def run_state(self, state: SimState, n_ticks: Optional[int] = None,
                  probe: Optional[Callable[[str], None]] = None,
                  first_tick: int = 0) -> Tuple[SimState, TickTrace]:
        """Advance ``state`` by ``n_ticks`` ticks (default ``params.n_ticks``)
        and return the final state and the stacked traces; ``state`` is
        left as it was.  ``first_tick`` is the index of ``state``'s tick
        (the scaling cadence counts from it).  On the card the ticks
        replay CUDA graphs (captured on first use), unless ``probe`` is
        given: then they run eagerly, calling it at each phase.  A solo
        run is a batch of one."""
        n = self.params.n_ticks if n_ticks is None else n_ticks
        dyn = dyn_host(DynParams.from_params(self.params))
        out, trace = self._advance(state, dyn, None, n, first_tick, probe)
        return batchmod.item(out, 0), TickTrace(*[t[:, 0] for t in trace])

    def run(self, seed: Optional[int] = None) -> SimResult:
        """Run ``params.n_ticks`` ticks from a fresh state (on the card,
        capturing the tick's graphs first if this ``Simulation`` has
        none for them, timed apart as ``compile_time_s``)."""
        state = self.init_state(seed)
        compile_s = self.compile(state)
        self._sync()
        t1 = _time.perf_counter()
        out_state, trace = self.run_state(state)
        self._sync()
        t2 = _time.perf_counter()
        self._export(out_state, np.float32([self.params.tel_tag]))
        return SimResult(state=out_state, trace=trace, wall_time_s=t2 - t1,
                         compile_time_s=compile_s)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _check_static_point(self, p: SimParams, b: int) -> None:
        """A sweep point may only vary the DynParams-carried scalars: the
        captured tick keeps ``self.params``' structure, so a mismatch in
        a structural knob would silently run the wrong program."""
        bad = [f for f in self._STATIC_FIELDS
               if getattr(p, f) != getattr(self.params, f)]
        if (p.max_concurrent > 0) != (self.params.max_concurrent > 0):
            bad.append("max_concurrent (capped vs uncapped)")
        if bad:
            raise ValueError(
                f"run_batch sweep point {b} differs from the Simulation's "
                f"params in structural knob(s) {bad}; these select program "
                "structure and cannot be swept — build a separate "
                "Simulation instead")
        if p.seed != self.params.seed:
            raise ValueError(
                f"run_batch sweep point {b} has a different seed; every "
                "point starts from the same initial state — pass seed= to "
                "run_batch (or run separate simulations) instead")

    @staticmethod
    def _shape_key(tree) -> tuple:
        return tuple((tuple(x.shape), x.dtype) for x in tree)

    def _sweep(self, dyn_batch, apps=None
               ) -> Tuple[DynParams, Optional[AppStatic]]:
        """A sweep's ``[B]`` host values and, with ``apps``, the stacked
        ``[B, ...]`` application on the device, checked as the
        reference's ``run_batch`` checks them."""
        if not isinstance(dyn_batch, DynParams):
            points = list(dyn_batch)
            for b, d in enumerate(points):
                if isinstance(d, SimParams):
                    self._check_static_point(d, b)
            dyn_batch = stack_dyn(
                d if isinstance(d, DynParams) else DynParams.from_params(d)
                for d in points)
        dyn = dyn_host(dyn_batch)
        B = len(dyn.dt)
        if self.params.telemetry == "stream" and not dyn.tel_tag.any():
            # the streamed rows tell the points apart by their tag: number
            # them unless the caller tagged them
            dyn = dyn._replace(tel_tag=np.arange(B, dtype=np.float32))
        if apps is None:
            return dyn, None
        apps = list(apps)
        if len(apps) != B:
            raise ValueError(
                f"apps must supply one AppStatic per sweep point: got "
                f"{len(apps)} apps for {B} points")
        ref = self._shape_key(self.app)
        for b, a in enumerate(apps):
            if self._shape_key(a) != ref:
                raise ValueError(
                    f"apps[{b}] has different array shapes than the "
                    "Simulation's app; shape-changing graphs need a "
                    "separate Simulation")
        return dyn, AppStatic(*[torch.stack([t.to(self.device) for t in f])
                                for f in zip(*apps)])

    def run_batch_state(self, state: SimState, dyn_batch,
                        n_ticks: Optional[int] = None,
                        probe: Optional[Callable[[str], None]] = None,
                        first_tick: int = 0, apps=None
                        ) -> Tuple[SimState, TickTrace]:
        """``run_state`` for a sweep: advance ``state`` (a solo state,
        broadcast over the points, or a batched one from an earlier call)
        by ``n_ticks`` ticks of every point of ``dyn_batch`` (as
        :meth:`run_batch` takes it) and return the batched final state
        and traces ``[B, n]``."""
        n = self.params.n_ticks if n_ticks is None else n_ticks
        dyn, app = self._sweep(dyn_batch, apps)
        out, trace = self._advance(state, dyn, app, n, first_tick, probe)
        return out, TickTrace(*[t.t().contiguous() for t in trace])

    def run_batch(self, dyn_batch, seed: Optional[int] = None,
                  apps=None) -> SimResult:
        """Run a whole parameter sweep as one batched tick, replayed once
        per tick (on the card: one capture, kept for every sweep of the
        same number of points).

        ``dyn_batch`` is either a batched :class:`DynParams` (every leaf
        carries a leading sweep axis) or a sequence of per-point
        :class:`DynParams` / :class:`SimParams` which is stacked here.
        Every sweep point starts from the same initial state (same seed),
        so point ``b`` of the result equals ``run()`` with that point's
        dyn values.  Structure-changing knobs (policy selectors, pool
        sizes, ``n_ticks``) are static — sweep those with separate
        Simulations.

        ``apps`` optionally supplies one :class:`AppStatic` per sweep
        point (every leaf must match ``self.app``'s shape — e.g.
        re-parameterized length/payload models for calibration); the whole
        sweep still runs as one batched tick over (dyn, app).
        """
        dyn, app = self._sweep(dyn_batch, apps)
        state = self.init_state(seed)
        compile_s = self._compile(state, dyn, app, None)
        self._sync()
        t1 = _time.perf_counter()
        out, trace = self._advance(state, dyn, app, self.params.n_ticks, 0,
                                   None)
        self._sync()
        t2 = _time.perf_counter()
        self._export(out, dyn.tel_tag)
        return SimResult(state=out,
                         trace=TickTrace(*[t.t().contiguous()
                                           for t in trace]),
                         wall_time_s=t2 - t1, compile_time_s=compile_s)

    def responses(self, result: SimResult) -> np.ndarray:
        r = result.state.requests.response.cpu().numpy()
        return r[r >= 0]
