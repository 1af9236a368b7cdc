"""Response-time analysis via the critical path (paper §4.3.2, Alg 2).

The paper iterates over every path of a service chain and keeps the
max-delay one (Eqs 5–6).  Enumerating paths is exponential in DAG width; we
compute the same quantity with max-plus linear algebra over the adjacency
matrix (kernels/tropical — DESIGN.md §2.3):

    D* = tropical_closure(A),   A[i,j] = delay(j) if i→j else -inf
    responseTime(api) = delay(entry) + max_j D*[entry, j]

which equals  max_{p ∈ P} Σ_{n ∈ p} delay(n)  (Eq 5/6) for every chain.
The critical path itself is recovered by greedy argmax backtracking.
The closures run through the tropical kernel on ``device`` (its plain
version on the CPU); ``device`` defaults to ``"cuda"``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

import torch

from ..kernels.tropical import NEG_INF, tropical_closure
from .types import resolve_device
from .graph import ServiceGraph


def delay_matrix(graph: ServiceGraph, delays: np.ndarray,
                 device="cuda") -> torch.Tensor:
    """A[i, j] = delay(j) on edges of the service DAG, -inf elsewhere."""
    adj = graph.adjacency()
    d = np.asarray(delays, dtype=np.float32)
    a = np.where(adj, d[None, :], np.float32(NEG_INF))
    return torch.as_tensor(a, device=resolve_device(device))


def response_times(graph: ServiceGraph, delays: np.ndarray,
                   device="cuda") -> np.ndarray:
    """Critical-path response time per API (Alg 2 output), in delay units."""
    a = delay_matrix(graph, delays, device)
    d_star = tropical_closure(a, depth=graph.depth).cpu().numpy()
    d = np.asarray(delays, dtype=np.float64)
    out = np.zeros(graph.n_apis, dtype=np.float64)
    for api in range(graph.n_apis):
        entry = int(graph.api_entry[api])
        best = d_star[entry].max()          # includes the 0-length self path
        out[api] = d[entry] + max(best, 0.0)
    return out


def response_times_batched(graph: ServiceGraph, delays_bt: np.ndarray,
                           device="cuda") -> np.ndarray:
    """Batched Alg 2 over [B, S] delay snapshots (e.g. per time window).

    This is the fleet-scale shape the tropical kernel is built for:
    [B, S, S] closures in one call.
    """
    delays_bt = np.asarray(delays_bt, dtype=np.float32)
    B, S = delays_bt.shape
    adj = graph.adjacency()
    a = np.where(adj[None, :, :], delays_bt[:, None, :], np.float32(NEG_INF))
    a = torch.as_tensor(a, device=resolve_device(device))
    d_star = tropical_closure(a, depth=graph.depth).cpu().numpy()
    out = np.zeros((B, graph.n_apis), dtype=np.float64)
    for api in range(graph.n_apis):
        entry = int(graph.api_entry[api])
        best = d_star[:, entry, :].max(axis=-1)
        out[:, api] = delays_bt[:, entry] + np.maximum(best, 0.0)
    return out


def critical_path(graph: ServiceGraph, delays: np.ndarray, api: int
                  ) -> Tuple[float, List[int]]:
    """Alg 2 faithful form: returns (responseTime, CP node list).

    Longest-path DP in topological order with backtracking — host-side,
    used for reporting and for cross-validating the tropical closure.
    """
    S = graph.n_services
    d = np.asarray(delays, dtype=np.float64)
    entry = int(graph.api_entry[api])
    best = np.full(S, -np.inf)
    parent = np.full(S, -1, dtype=np.int64)
    best[entry] = d[entry]
    order = np.argsort(graph.levels, kind="stable")
    for u in order:
        if best[u] == -np.inf:
            continue
        for v in graph.succ[u]:
            if v < 0:
                continue
            cand = best[u] + d[v]
            if cand > best[v]:
                best[v] = cand
                parent[v] = u
    leaf = int(np.argmax(np.where(np.isfinite(best), best, -np.inf)))
    rt = float(best[leaf])
    path = [leaf]
    while parent[path[-1]] >= 0:
        path.append(int(parent[path[-1]]))
    return rt, path[::-1]


def path_delay(path: Sequence[int], delays: np.ndarray) -> float:
    """Eq 5: D_p = Σ_{n ∈ p} delay(n)."""
    d = np.asarray(delays, dtype=np.float64)
    return float(sum(d[n] for n in path))
