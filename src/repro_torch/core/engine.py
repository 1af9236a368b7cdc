"""Simulation engine: one tick per paper event cycle, looped over time.

``make_tick`` assembles the event phases of paper §3.2 —
Generation → (Transit, fabric mode) → Dispatching → Scheduling →
Derivative → Response → Scaling & Migration — into one state transition.
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
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .. import random as rnd
from ..analysis import streams
from . import network as netmod
from . import policies, pool, scheduler
from .app import AppStatic, InstanceTemplate, build_app, validate_app
from .generator import client_phase
from .graph import ServiceGraph
from .placement import initial_allocation, migrate
from .scaling import scaling_event
from .types import (CL_EXEC, CL_TRANSIT, CL_WAITING, Cloudlets, DynParams,
                    INST_ON, SimCaps, SimParams, SimState, TickTrace,
                    check_main_path, resolve_device, zeros_state)

# Stream names of the tick's single wide split; positions are the
# contract (split is not prefix-stable, so the fabric's two extra streams
# change every key), names are the audit labels.  "carry" is the next
# tick's root key.
KEY_NAMES = ("carry", "gen", "spawn", "lb", "derive")
FABRIC_KEY_NAMES = KEY_NAMES + ("net_gen", "net_derive")


def carry_path(params: SimParams) -> tuple:
    """Where the next tick's root key lies below this tick's, as
    ``random.chain`` takes it."""
    names = FABRIC_KEY_NAMES if params.network == "fabric" else KEY_NAMES
    return ((len(names), names.index("carry")),)


def make_tick(caps: SimCaps, params: SimParams,
              has_edges: bool = True) -> Callable:
    """Build the tick function ``tick(state, dyn, app, key, scale_due,
    probe)``.

    ``params`` supplies the knobs that choose program structure.
    ``network="fabric"`` adds the Transit phase (core/network.py) between
    Generation and Dispatch.  Modes the port does not have yet
    (``faults``, ``telemetry``, ``alerting`` other than their defaults)
    raise ``NotImplementedError``.
    ``key`` is the tick's root key (the role of ``state.rng``: a host key
    or a ``random.TableKey``); the tick draws from its streams and leaves
    ``state.rng`` to the caller, who derives the next root
    (``carry_path``).  ``scale_due`` (a host bool) says whether this tick
    ends a scaling interval.  ``probe``, when given, is called with each
    phase name just before the phase runs and with ``"end"`` after the
    last one — the hook behind the per-phase CUDA-event timings.
    """
    check_main_path(params)
    scales = bool(params.scaling_policy or params.migration_enabled)
    network = params.network == "fabric"
    key_names = FABRIC_KEY_NAMES if network else KEY_NAMES

    def tick(state: SimState, dyn: DynParams, app: AppStatic, key,
             scale_due: bool = False,
             probe: Optional[Callable[[str], None]] = None
             ) -> Tuple[SimState, TickTrace]:
        mark = probe or (lambda name: None)
        keys = streams.split(key, len(key_names), names=key_names)
        k_gen, k_gen2, k_lb, k_der = keys[1:5]
        k_net_g, k_net_d = (keys[5], keys[6]) if network else (None, None)

        mark("Generation")
        gen = client_phase(state.clients.wait, state.time,
                           state.requests.count, app.api_cdf, dyn, k_gen)
        state, gen_res = scheduler.gen_spawn(
            state, app, caps, gen.fired, gen.api, gen.wait_proposal,
            k_gen2, dyn, params=params, net_rng=k_net_g)

        if network:
            mark("Transit")
            state = netmod.transit(state, caps, params, dyn, app)

        mark("Dispatch")
        state = scheduler.dispatch(state, app, caps, params, dyn, k_lb,
                                   network=network)

        mark("Execute")
        state, fin_info = scheduler.execute(state, app, caps, params, dyn)

        if has_edges:  # edge-free graphs skip the spawn machinery
            mark("Derive")
            state = scheduler.derive(state, app, caps, fin_info, k_der,
                                     params=params, net_rng=k_net_d)

        mark("Response")
        state, n_done = scheduler.complete(state, dyn)

        if scales and scale_due:
            mark("Scaling")
            state = scaling_event(state, app, caps, params, dyn)
            if params.migration_enabled:
                state = migrate(state, app, caps, dyn)

        mark("Trace")
        cs = state.cloudlets.status
        trace = TickTrace(
            completed=n_done,
            generated=gen_res.n_new_requests,
            n_waiting=torch.sum(cs == CL_WAITING, dtype=torch.int32),
            n_exec=torch.sum(cs == CL_EXEC, dtype=torch.int32),
            n_transit=torch.sum(cs == CL_TRANSIT, dtype=torch.int32),
            used_mips=pool.tree_sum(state.instances.used_mips),
            active_instances=torch.sum(state.instances.status == INST_ON,
                                       dtype=torch.int32),
            active_clients=gen.n_active,
        )
        state = state._replace(tick=state.tick + 1,
                               time=state.time + float(dyn.dt))
        mark("end")
        return state, trace

    return tick


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
    it.  A leaf sharing storage with any leaf of ``dst`` is cloned first,
    so no copy overwrites what a later one reads."""
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


class TickLoop:
    """The tick as a step over fixed buffers.  Each ``step`` reads its
    keys from ``keys`` at the step counter, writes the tick's trace into
    ``[cap]`` buffers at that row, writes the next state back into
    ``state`` (the buffers it read) and advances the counter, so every
    tick reads and writes the same addresses: the step can be captured
    once as a CUDA graph and replayed.  ``load`` starts a run: it copies
    the start state in and fills the key table with the run's root
    keys."""

    def __init__(self, tick: Callable, dyn: DynParams, app: AppStatic,
                 state: SimState, cap: int):
        self.tick, self.dyn, self.app, self.cap = tick, dyn, app, cap
        self.state = _clone(state)
        self.keys = rnd.KeyTable(cap, state.tick.device)
        self.trace: Optional[TickTrace] = None

    def load(self, state: SimState, roots: np.ndarray) -> None:
        _write_back(self.state, state)
        self.keys.fill(roots)

    def step(self, scale_due: bool,
             probe: Optional[Callable[[str], None]] = None) -> None:
        out, tr = self.tick(self.state, self.dyn, self.app,
                            self.keys.root(), scale_due, probe)
        if self.trace is None:
            self.trace = TickTrace(*[
                torch.empty((self.cap,), dtype=v.dtype, device=v.device)
                for v in tr])
        row = self.keys.step.view(1)
        for buf, v in zip(self.trace, tr):
            buf.index_copy_(0, row, v.reshape(1))
        _write_back(self.state, out)
        self.keys.advance()

    def traces(self, n: int) -> TickTrace:
        if self.trace is None or n == 0:
            empty = torch.zeros((0,), device=self.state.tick.device)
            return TickTrace(*[empty] * 8)
        return TickTrace(*[b[:n].clone() for b in self.trace])


class TickGraphs:
    """``TickLoop``'s step captured as CUDA graphs: the ordinary tick
    and, where the params scale, the scaling tick, in one memory pool.

    The capture first runs each variant once on a side stream (loading
    the libraries, setting the kernels' scratch, shared-memory limits and
    cuBLAS state, and adding every key stream to the table), then
    captures it.  Launches made while compiling go to a tally: each
    graph's own are added to ``kernels.counts`` at every replay.
    ``compile_time_s`` is the warm-up and capture time."""

    def __init__(self, loop: TickLoop, scales: bool, state: SimState,
                 roots: np.ndarray):
        dev = loop.state.tick.device
        t0 = _time.perf_counter()
        self.loop = loop
        variants = (False, True) if scales else (False,)
        loop.load(state, roots)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with kernels.tally(), torch.cuda.stream(side):
            for due in variants:
                loop.keys.rewind()
                loop.step(due)
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        self.graphs = {}
        for due in variants:
            graph = torch.cuda.CUDAGraph()
            with kernels.tally() as launches:
                with torch.cuda.graph(graph, pool=pool):
                    loop.step(due)
            self.graphs[due] = (graph, launches)
        torch.cuda.synchronize(dev)
        self.compile_time_s = _time.perf_counter() - t0

    def run(self, state: SimState, roots: np.ndarray, due: list
            ) -> Tuple[SimState, TickTrace]:
        """Replay one graph per tick (the scaling one where ``due``)."""
        self.loop.load(state, roots)
        for d in due:
            graph, launches = self.graphs[d]
            graph.replay()
            kernels.add_counts(launches)
        return _clone(self.loop.state), self.loop.traces(len(due))


@dataclasses.dataclass
class SimResult:
    """A run's final state and per-tick traces.  ``wall_time_s`` excludes
    ``compile_time_s``: on the card, the warm-up and capture of the tick's
    CUDA graphs (0.0 when the run replayed graphs captured by an earlier
    run); on the CPU, where the tick runs eagerly, 0.0."""
    state: SimState
    trace: TickTrace          # each field stacked over ticks: [T]
    wall_time_s: float
    compile_time_s: float

    def trace_np(self) -> dict:
        return {k: v.cpu().numpy() for k, v in self.trace._asdict().items()}


class Simulation:
    """User-facing façade (paper Fig 4 ``Application`` + ``Register``).

    >>> sim = Simulation(graph, caps=SimCaps(...), params=SimParams(...))
    >>> result = sim.run()

    ``device`` defaults to ``"cuda"``; without a GPU that raises unless
    the caller asks for ``device="cpu"``.  On the card, runs replay the
    tick's CUDA graphs, captured at the first run and kept per
    ``Simulation`` for what they bake in (caps, params and with them the
    ``DynParams`` values, the state's shapes); a failed capture raises.
    """

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
        self._graphs: dict = {}

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

    def _graphs_for(self, state: SimState, dyn: DynParams, n: int
                    ) -> Tuple[TickGraphs, float]:
        """The captured tick for ``state``'s shapes, holding at least ``n``
        ticks of keys and traces, and the capture time (0.0 when cached)."""
        key = (self.params, self.caps,
               tuple((tuple(t.shape), t.dtype) for t in _leaves(state)))
        hit = self._graphs.get(key)
        if hit is not None and hit.loop.cap >= n:
            return hit, 0.0
        self._graphs.pop(key, None)    # free a smaller capture first
        del hit
        cap = max(n, int(self.params.n_ticks), 2)
        loop = TickLoop(self._tick, dyn, self.app, state, cap)
        roots, _ = rnd.chain(state.rng, 1, carry_path(self.params))
        graphs = TickGraphs(loop, self._scales, state, roots)
        self._graphs[key] = graphs
        return graphs, graphs.compile_time_s

    @property
    def _scales(self) -> bool:
        return bool(self.params.scaling_policy
                    or self.params.migration_enabled)

    def compile(self, state: SimState, n_ticks: Optional[int] = None
                ) -> float:
        """Capture the tick's CUDA graphs for runs from states shaped as
        ``state`` (on the card; a no-op on the CPU) and return the time
        it took, 0.0 if they were captured before."""
        if self.device.type != "cuda":
            return 0.0
        n = self.params.n_ticks if n_ticks is None else n_ticks
        return self._graphs_for(state, DynParams.from_params(self.params),
                                n)[1]

    def run_state(self, state: SimState, n_ticks: Optional[int] = None,
                  probe: Optional[Callable[[str], None]] = None,
                  first_tick: int = 0) -> Tuple[SimState, TickTrace]:
        """Advance ``state`` by ``n_ticks`` ticks (default ``params.n_ticks``)
        and return the final state and the stacked traces; ``state`` is
        left as it was.  ``first_tick`` is the index of ``state``'s tick
        (the scaling cadence counts from it).  On the card the ticks
        replay CUDA graphs (captured on first use), unless ``probe`` is
        given: then they run eagerly, calling it at each phase."""
        dyn = DynParams.from_params(self.params)
        n = self.params.n_ticks if n_ticks is None else n_ticks
        roots, carry = rnd.chain(state.rng, n, carry_path(self.params))
        due = [self._scales and self.scale_due(first_tick + k)
               for k in range(n)]
        if self.device.type == "cuda" and probe is None:
            out, trace = self._graphs_for(state, dyn, n)[0].run(
                state, roots, due)
        else:
            loop = TickLoop(self._tick, dyn, self.app, state, max(n, 1))
            loop.keys.fill(roots)
            for d in due:
                loop.step(d, probe)
            out, trace = loop.state, loop.traces(n)
        return out._replace(rng=carry), trace

    def run(self, seed: Optional[int] = None) -> SimResult:
        """Run ``params.n_ticks`` ticks from a fresh state (on the card,
        capturing the tick's graphs first if this ``Simulation`` has
        none for them, timed apart as ``compile_time_s``)."""
        state = self.init_state(seed)
        compile_s = self.compile(state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = _time.perf_counter()
        out_state, trace = self.run_state(state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = _time.perf_counter()
        return SimResult(state=out_state, trace=trace, wall_time_s=t2 - t1,
                         compile_time_s=compile_s)

    def responses(self, result: SimResult) -> np.ndarray:
        r = result.state.requests.response.cpu().numpy()
        return r[r >= 0]
