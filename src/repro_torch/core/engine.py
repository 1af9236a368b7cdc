"""Simulation engine: one tick per paper event cycle, looped over time.

``make_tick`` assembles the event phases of paper §3.2 —
Generation → (Transit, fabric mode) → Dispatching → Scheduling →
Derivative → Response → Scaling & Migration — into one state transition,
and ``Simulation`` runs it in a Python loop with static shapes,
collecting per-tick QoS traces.  The loop never synchronises with the
device: the scaling cadence is a test on the host-side loop index, and
every data-dependent choice is a tensor select.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import random as rnd
from ..analysis import streams
from . import network as netmod
from . import policies, pool, scheduler
from .app import AppStatic, InstanceTemplate, build_app, validate_app
from .generator import client_phase
from .graph import ServiceGraph
from .placement import initial_allocation, migrate
from .scaling import scaling_event
from .types import (CL_EXEC, CL_TRANSIT, CL_WAITING, DynParams, INST_ON,
                    SimCaps, SimParams, SimState, TickTrace,
                    check_main_path, resolve_device, zeros_state)

# Stream names of the tick's single wide split; positions are the
# contract (split is not prefix-stable, so the fabric's two extra streams
# change every key), names are the audit labels.
KEY_NAMES = ("carry", "gen", "spawn", "lb", "derive")
FABRIC_KEY_NAMES = KEY_NAMES + ("net_gen", "net_derive")


def make_tick(caps: SimCaps, params: SimParams,
              has_edges: bool = True) -> Callable:
    """Build the tick function ``tick(state, dyn, app, scale_due, probe)``.

    ``params`` supplies the knobs that choose program structure.
    ``network="fabric"`` adds the Transit phase (core/network.py) between
    Generation and Dispatch.  Modes the port does not have yet
    (``faults``, ``telemetry``, ``alerting`` other than their defaults)
    raise ``NotImplementedError``.
    ``scale_due`` (a host bool) says whether this tick ends a scaling
    interval.  ``probe``, when given, is called with each phase name just
    before the phase runs and with ``"end"`` after the last one — the
    hook behind the per-phase CUDA-event timings.
    """
    check_main_path(params)
    scales = bool(params.scaling_policy or params.migration_enabled)
    network = params.network == "fabric"
    key_names = FABRIC_KEY_NAMES if network else KEY_NAMES

    def tick(state: SimState, dyn: DynParams, app: AppStatic,
             scale_due: bool = False,
             probe: Optional[Callable[[str], None]] = None
             ) -> Tuple[SimState, TickTrace]:
        mark = probe or (lambda name: None)
        keys = streams.split(state.rng, len(key_names), names=key_names)
        k_carry, k_gen, k_gen2, k_lb, k_der = keys[:5]
        k_net_g, k_net_d = (keys[5], keys[6]) if network else (None, None)
        state = state._replace(rng=k_carry)

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


@dataclasses.dataclass
class SimResult:
    state: SimState
    trace: TickTrace          # each field stacked over ticks: [T]
    wall_time_s: float
    compile_time_s: float     # 0.0: the port runs eagerly

    def trace_np(self) -> dict:
        return {k: v.cpu().numpy() for k, v in self.trace._asdict().items()}


class Simulation:
    """User-facing façade (paper Fig 4 ``Application`` + ``Register``).

    >>> sim = Simulation(graph, caps=SimCaps(...), params=SimParams(...))
    >>> result = sim.run()

    ``device`` defaults to ``"cuda"``; without a GPU that raises unless
    the caller asks for ``device="cpu"``.
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

    def run_state(self, state: SimState, n_ticks: Optional[int] = None,
                  probe: Optional[Callable[[str], None]] = None,
                  first_tick: int = 0) -> Tuple[SimState, TickTrace]:
        """Advance ``state`` by ``n_ticks`` ticks (default ``params.n_ticks``)
        and return the final state and the stacked traces."""
        dyn = DynParams.from_params(self.params)
        n = self.params.n_ticks if n_ticks is None else n_ticks
        traces = []
        for k in range(n):
            state, tr = self._tick(state, dyn, self.app,
                                   self.scale_due(first_tick + k), probe)
            traces.append(tr)
        if traces:
            trace = TickTrace(*[torch.stack(f) for f in zip(*traces)])
        else:
            trace = TickTrace(*[torch.zeros((0,), device=self.device)] * 8)
        return state, trace

    def run(self, seed: Optional[int] = None) -> SimResult:
        """Run ``params.n_ticks`` ticks from a fresh state."""
        state = self.init_state(seed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = _time.perf_counter()
        out_state, trace = self.run_state(state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = _time.perf_counter()
        return SimResult(state=out_state, trace=trace, wall_time_s=t2 - t1,
                         compile_time_s=0.0)

    def responses(self, result: SimResult) -> np.ndarray:
        r = result.state.requests.response.cpu().numpy()
        return r[r >= 0]
