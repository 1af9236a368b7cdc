"""Static application description consumed by the tick.

``AppStatic`` bundles the service graph tables (paper Fig 7), the API entry
mapping, the Gaussian cloudlet-length model (paper §4.1.2) and the
per-service instance templates (paper Fig 3b YAML: requests/limits) as
tensors on the simulation's device, with the reference's field names.  It
is configuration — never mutated.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .generator import api_weight_cdf
from .graph import ServiceGraph
from .types import resolve_device


@dataclasses.dataclass(frozen=True)
class InstanceTemplate:
    """Per-service instance spec (paper Fig 3b)."""

    mips: float = 1000.0          # requests.share → initial CPU (MI/s)
    limit_mips: float = 2000.0    # limits.share   → VS ceiling
    ram: float = 300.0            # requests.ram (MB)
    limit_ram: float = 500.0
    bw: float = 100.0             # rec/trans bandwidth (Mbps)
    replicas: int = 1
    ram_per_cloudlet: float = 1.0   # linear usage model (paper §5.2)
    bytes_per_rpc: float = 0.01     # MB per inter-service call


class AppStatic(NamedTuple):
    succ: torch.Tensor           # [S, d_max] i32
    n_succ: torch.Tensor         # [S] i32
    len_mean: torch.Tensor       # [S] f32 (MI)
    len_std: torch.Tensor        # [S] f32
    api_entry: torch.Tensor      # [A, E_max] i32 (-1 pad)
    api_n_entry: torch.Tensor    # [A] i32
    api_cdf: torch.Tensor        # [A] f32
    tmpl_mips: torch.Tensor      # [S] f32
    tmpl_limit_mips: torch.Tensor
    tmpl_ram: torch.Tensor
    tmpl_limit_ram: torch.Tensor
    tmpl_bw: torch.Tensor
    tmpl_replicas: torch.Tensor  # [S] i32
    ram_per_cl: torch.Tensor     # [S] f32
    bytes_per_rpc: torch.Tensor  # [S] f32
    payload_mean: torch.Tensor   # [S, d_max] f32 per-edge RPC payload (MB)
    payload_std: torch.Tensor    # [S, d_max] f32
    api_payload_mean: torch.Tensor  # [A] f32
    api_payload_std: torch.Tensor   # [A] f32
    edge_retry: torch.Tensor     # [S*d_max + A] i32 per-edge retry budget
    edge_timeout: torch.Tensor   # [S*d_max + A] f32 per-edge timeout (s)
    host_zone: torch.Tensor      # [H] i32 failure-domain id per host
    slo_target_ms: torch.Tensor  # [S] f32 per-service SLO target (-1 = run)
    slo_budget: torch.Tensor     # [S] f32 per-service error budget

    # (the tick's copy carries a leading batch axis: the sizes read the
    # trailing axes)
    @property
    def n_services(self) -> int:
        return self.succ.shape[-2]

    @property
    def n_apis(self) -> int:
        return self.api_cdf.shape[-1]

    @property
    def n_edges(self) -> int:
        return self.edge_retry.shape[-1]

    @property
    def n_hosts(self) -> int:
        return self.host_zone.shape[-1]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def validate_app(app: AppStatic, caps) -> None:
    """Build-time bounds validation (DESIGN.md §8).

    Every id table the tick indexes with is range-checked here, before
    the first tick, with errors that name the offending entry: the port's
    gathers then stay in bounds (torch raises on an out-of-range gather
    on the CPU and asserts on the card, where the reference clamps).
    """
    from .types import edge_table_size
    S, A, H = app.n_services, app.n_apis, app.n_hosts
    D = int(app.succ.shape[1]) if app.succ.dim() == 2 else 0
    problems: list[str] = []

    succ = _np(app.succ).reshape(S, -1)
    if succ.size and (succ.min() < -1 or succ.max() >= S):
        problems.append(
            f"succ table ids must lie in [-1, {S - 1}]: got "
            f"[{succ.min()}, {succ.max()}]")
    if D > caps.d_max:
        problems.append(
            f"service out-degree {D} exceeds caps.d_max={caps.d_max}; "
            f"the per-edge retry/breaker tables would be undersized — "
            f"raise SimCaps.d_max to at least {D}")
    if app.n_edges != S * D + max(A, 1):
        problems.append(
            f"edge tables have {app.n_edges} rows but the edge-id space "
            f"is S*d_max+A = {S}*{D}+{max(A, 1)} = {S * D + max(A, 1)}; "
            f"edge ids past the table would read out of bounds")
    if D <= caps.d_max and app.n_edges > edge_table_size(S, caps.d_max, A):
        problems.append(
            f"edge tables ({app.n_edges} rows) exceed the caps-derived "
            f"bound edge_table_size({S}, {caps.d_max}, {A}) = "
            f"{edge_table_size(S, caps.d_max, A)}")

    entry = _np(app.api_entry).reshape(A, -1)
    if entry.size and (entry.min() < -1 or entry.max() >= S):
        problems.append(
            f"api_entry service ids must lie in [-1, {S - 1}]: got "
            f"[{entry.min()}, {entry.max()}]")
    for a in range(A):
        if entry.size and not (entry[a] >= 0).any():
            problems.append(f"API {a} has no entry service")

    reps = _np(app.tmpl_replicas)
    if reps.size and (reps.min() < 1 or reps.max() > caps.max_replicas):
        bad = int(np.argmax((reps < 1) | (reps > caps.max_replicas)))
        problems.append(
            f"service {bad} declares {int(reps[bad])} replicas; replica "
            f"counts must lie in [1, caps.max_replicas={caps.max_replicas}]")
    if reps.size and int(reps.sum()) > caps.max_instances:
        problems.append(
            f"total initial replicas {int(reps.sum())} exceed "
            f"caps.max_instances={caps.max_instances}; raise the cap or "
            f"trim the templates")

    hz = _np(app.host_zone)
    if hz.size and (hz.min() < 0 or hz.max() >= H):
        problems.append(
            f"host_zone ids must lie in [0, {H}): got "
            f"[{hz.min()}, {hz.max()}]")

    # Reject call-graph cycles reachable from an API entry: derivative
    # spawning would loop forever, and acyclicity is what caps chain
    # depth at S-1 hops — the depth column's declared bound
    # (types.POOL_COLUMN_BOUNDS) behind scheduler.derive's depth clamp.
    # Only meaningful once both id tables are in range (checked above).
    ids_ok = ((not succ.size or (succ.min() >= -1 and succ.max() < S))
              and (not entry.size
                   or (entry.min() >= -1 and entry.max() < S)))
    if succ.size and entry.size and ids_ok:
        depth = np.full((S,), -1, np.int64)
        roots = entry[entry >= 0]
        depth[roots] = 0
        cyclic = False
        for _ in range(S + 1):
            changed = False
            for s in range(S):
                if depth[s] < 0:
                    continue
                for c in succ[s]:
                    if c >= 0 and depth[c] < depth[s] + 1:
                        depth[c] = depth[s] + 1
                        changed = True
            if not changed:
                break
        else:
            cyclic = True
        if cyclic:
            problems.append(
                "service call graph has a cycle reachable from an API "
                "entry — derivative spawning would never terminate")

    if problems:
        raise ValueError(
            "application failed build-time bounds validation:\n  - "
            + "\n  - ".join(problems))


def build_app(graph: ServiceGraph,
              templates: dict[str, InstanceTemplate] | None = None,
              default_template: InstanceTemplate | None = None,
              api_entries: Sequence[Sequence[str]] | None = None,
              n_hosts: int = 0,
              host_zone: Sequence[int] | None = None,
              slo_target_ms: Sequence[float] | None = None,
              slo_budget: Sequence[float] | None = None,
              device="cuda") -> AppStatic:
    """Assemble :class:`AppStatic` from a graph + instance templates, on
    ``device``.

    ``api_entries`` optionally overrides the per-API entry services with a
    *list* per API (fan-out at the entry, used by capacity benchmarks);
    default is the single entry service recorded in the graph.

    ``host_zone`` maps each of the cluster's ``n_hosts`` hosts to a
    failure domain for zone-correlated chaos (registry ``zones:`` key);
    default is one zone per host (no correlation).

    ``slo_target_ms`` / ``slo_budget`` declare per-service SLO objectives
    for burn-rate alerting (registry per-service ``slo_ms`` /
    ``slo_budget`` keys); -1 entries fall back to the run-wide traced
    defaults at evaluation time.
    """
    default_template = default_template or InstanceTemplate()
    templates = templates or {}
    S = graph.n_services
    A = graph.n_apis

    if host_zone is None:
        hz = np.arange(n_hosts, dtype=np.int32)
    else:
        hz = np.asarray(host_zone, dtype=np.int32).reshape(-1)
        n_hosts = n_hosts or hz.shape[0]
        if hz.shape[0] != n_hosts:
            raise ValueError(
                f"host_zone must list one zone per host: got {hz.shape[0]} "
                f"entries for {n_hosts} hosts")
        if hz.size and (hz.min() < 0 or hz.max() >= n_hosts):
            raise ValueError(
                f"host_zone ids must lie in [0, {n_hosts}): got "
                f"[{hz.min()}, {hz.max()}]")

    def svc_table(name: str, vals) -> np.ndarray:
        if vals is None:
            return np.full((S,), -1.0, dtype=np.float32)
        arr = np.asarray(vals, dtype=np.float32).reshape(-1)
        if arr.shape[0] != S:
            raise ValueError(
                f"{name} must list one value per service: got "
                f"{arr.shape[0]} entries for {S} services")
        return arr

    slo_t = svc_table("slo_target_ms", slo_target_ms)
    slo_b = svc_table("slo_budget", slo_budget)

    def tarr(field: str, dtype=np.float32) -> np.ndarray:
        return np.array(
            [getattr(templates.get(n, default_template), field)
             for n in graph.names], dtype=dtype)

    if api_entries is None:
        e_max = 1
        entry = graph.api_entry.reshape(A, 1).astype(np.int32)
        n_entry = np.ones((A,), dtype=np.int32)
    else:
        e_max = max(len(e) for e in api_entries)
        entry = np.full((A, e_max), -1, dtype=np.int32)
        n_entry = np.zeros((A,), dtype=np.int32)
        index = {n: i for i, n in enumerate(graph.names)}
        for a, names in enumerate(api_entries):
            ids = [index[n] for n in names]
            entry[a, : len(ids)] = ids
            n_entry[a] = len(ids)

    device = resolve_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=device)

    return AppStatic(
        succ=t(graph.succ, np.int32),
        n_succ=t(graph.n_succ, np.int32),
        len_mean=t(graph.len_mean, np.float32),
        len_std=t(graph.len_std, np.float32),
        api_entry=t(entry),
        api_n_entry=t(n_entry),
        api_cdf=t(api_weight_cdf(graph.api_weight)),
        tmpl_mips=t(tarr("mips")),
        tmpl_limit_mips=t(tarr("limit_mips")),
        tmpl_ram=t(tarr("ram")),
        tmpl_limit_ram=t(tarr("limit_ram")),
        tmpl_bw=t(tarr("bw")),
        tmpl_replicas=t(tarr("replicas", np.int32)),
        ram_per_cl=t(tarr("ram_per_cloudlet")),
        bytes_per_rpc=t(tarr("bytes_per_rpc")),
        payload_mean=t(graph.payload_mean, np.float32),
        payload_std=t(graph.payload_std, np.float32),
        api_payload_mean=t(graph.api_payload_mean, np.float32),
        api_payload_std=t(graph.api_payload_std, np.float32),
        edge_retry=t(np.concatenate(
            [np.asarray(graph.edge_retry, np.int32).reshape(-1),
             np.asarray(graph.api_retry, np.int32)])),
        edge_timeout=t(np.concatenate(
            [np.asarray(graph.edge_timeout, np.float32).reshape(-1),
             np.asarray(graph.api_timeout, np.float32)])),
        host_zone=t(hz),
        slo_target_ms=t(slo_t),
        slo_budget=t(slo_b),
    )
