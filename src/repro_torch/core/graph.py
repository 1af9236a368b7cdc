"""Service-dependency graph (paper §4.1.1, Figs 6–7).

A :class:`ServiceGraph` is the static description of a cloud-native
application: named services, their call edges (a DAG), the APIs that enter
the graph, and per-service cloudlet statistics.  It is built host-side with
numpy (it is configuration, not state) and exposes the padded successor /
predecessor tables ("bidirectional service hierarchy", paper Fig 7) that the
engine consumes.  A copy of the reference's host-side builder, so the port
stands alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Default per-edge RPC payload (MB) when a graph carries no payload spec —
# small enough that generous NICs reproduce near-uniform behavior.
DEFAULT_PAYLOAD_MB = 0.01


@dataclasses.dataclass
class ServiceGraph:
    """Static DAG of services + API entry points.

    Attributes
    ----------
    names : service names, index = service id.
    succ : [S, d_max] int32 successor table, padded with -1 (forward table
        of paper Fig 7).
    pred : [S, d_max_in] int32 predecessor table (reverse table of Fig 7).
    n_succ / n_pred : [S] int32 degrees.
    api_names : API labels, index = api id.
    api_entry : [A] int32 entry service per API.
    api_weight : [A] float32 selection weight (paper Fig 3a "weight").
    len_mean / len_std : [S] float32 Gaussian cloudlet length in MI
        (paper §4.1.2 — lengths are sampled per cloudlet).
    levels : [S] int32 topological level of each service.
    payload_mean / payload_std : [S, d_max] float32 Gaussian RPC payload
        (MB, request+response lumped) per call edge, aligned with ``succ``
        (network fabric, DESIGN.md §6; -0 rows beyond n_succ are inert).
    api_payload_mean / api_payload_std : [A] float32 client→entry payload.
    edge_retry : [S, d_max] int32 per-call-edge retry budget (-1 = use the
        run-wide ``SimParams.retry_budget`` — resilience, DESIGN.md §7).
    api_retry : [A] int32 client→entry retry budget (-1 = run-wide default).
    edge_timeout : [S, d_max] float32 per-call-edge attempt timeout in
        seconds (-1 = use the run-wide ``SimParams.retry_timeout_s``) —
        timeout budgets match the per-edge retry budgets, DESIGN.md §7.
    api_timeout : [A] float32 client→entry timeout (-1 = run-wide default).
    """

    names: List[str]
    succ: np.ndarray
    pred: np.ndarray
    n_succ: np.ndarray
    n_pred: np.ndarray
    api_names: List[str]
    api_entry: np.ndarray
    api_weight: np.ndarray
    len_mean: np.ndarray
    len_std: np.ndarray
    levels: np.ndarray
    payload_mean: np.ndarray = None
    payload_std: np.ndarray = None
    api_payload_mean: np.ndarray = None
    api_payload_std: np.ndarray = None
    edge_retry: np.ndarray = None
    api_retry: np.ndarray = None
    edge_timeout: np.ndarray = None
    api_timeout: np.ndarray = None

    def __post_init__(self):
        """Fill default payload/retry tables for graphs built before the
        network fabric / resilience subsystems existed (payloads default to
        DEFAULT_PAYLOAD_MB, retry budgets to -1 = run-wide default)."""
        S, D = self.succ.shape if self.succ.size else (len(self.names), 1)
        A = len(self.api_names)
        if self.payload_mean is None:
            self.payload_mean = np.full((S, D), DEFAULT_PAYLOAD_MB,
                                        np.float32)
        if self.payload_std is None:
            self.payload_std = 0.1 * np.asarray(self.payload_mean,
                                                np.float32)
        if self.api_payload_mean is None:
            self.api_payload_mean = np.full((A,), DEFAULT_PAYLOAD_MB,
                                            np.float32)
        if self.api_payload_std is None:
            self.api_payload_std = 0.1 * np.asarray(self.api_payload_mean,
                                                    np.float32)
        if self.edge_retry is None:
            self.edge_retry = np.full((S, D), -1, np.int32)
        if self.api_retry is None:
            self.api_retry = np.full((A,), -1, np.int32)
        if self.edge_timeout is None:
            self.edge_timeout = np.full((S, D), -1.0, np.float32)
        if self.api_timeout is None:
            self.api_timeout = np.full((A,), -1.0, np.float32)

    # ------------------------------------------------------------------
    @property
    def n_services(self) -> int:
        return len(self.names)

    @property
    def n_apis(self) -> int:
        return len(self.api_names)

    @property
    def d_max(self) -> int:
        return int(self.succ.shape[1])

    @property
    def depth(self) -> int:
        return int(self.levels.max()) + 1 if self.n_services else 0

    def service_id(self, name: str) -> int:
        return self.names.index(name)

    # ------------------------------------------------------------------
    def adjacency(self) -> np.ndarray:
        """Dense [S, S] bool adjacency matrix (i calls j)."""
        S = self.n_services
        adj = np.zeros((S, S), dtype=bool)
        for i in range(S):
            for j in self.succ[i]:
                if j >= 0:
                    adj[i, int(j)] = True
        return adj

    def chains_from(self, root: int, limit: int = 4096) -> List[List[int]]:
        """Enumerate root→leaf chains (paper §4.1.1 "service chains").

        Used by analysis/tests only; the engine never enumerates paths —
        it uses the tropical longest-path formulation (critical_path.py).
        """
        chains: List[List[int]] = []

        def dfs(node: int, path: List[int]):
            if len(chains) >= limit:
                return
            succs = [int(s) for s in self.succ[node] if s >= 0]
            if not succs:
                chains.append(path)
                return
            for s in succs:
                dfs(s, path + [s])

        dfs(root, [root])
        return chains

    def validate(self) -> None:
        """Reject cyclic graphs (paper: service calls are acyclic)."""
        S = self.n_services
        indeg = self.n_pred.copy()
        queue = [i for i in range(S) if indeg[i] == 0]
        seen = 0
        while queue:
            u = queue.pop()
            seen += 1
            for v in self.succ[u]:
                if v >= 0:
                    indeg[int(v)] -= 1
                    if indeg[int(v)] == 0:
                        queue.append(int(v))
        if seen != S:
            raise ValueError("service graph contains a cycle — not a DAG")


def build_graph(
    services: Sequence[str],
    calls: Dict[str, Sequence[str]],
    apis: Sequence[Tuple[str, str, float]],
    len_mean: Dict[str, float],
    len_std: Dict[str, float] | None = None,
    d_max: int | None = None,
    payloads: Dict[Tuple[str, str], float] | None = None,
    payload_stds: Dict[Tuple[str, str], float] | None = None,
    api_payloads: Dict[str, float] | None = None,
    default_payload_mb: float = DEFAULT_PAYLOAD_MB,
    retries: Dict[Tuple[str, str], int] | None = None,
    api_retries: Dict[str, int] | None = None,
    timeouts: Dict[Tuple[str, str], float] | None = None,
    api_timeouts: Dict[str, float] | None = None,
) -> ServiceGraph:
    """Construct a :class:`ServiceGraph`.

    Parameters
    ----------
    services : ordered service names.
    calls : service name → called service names (DAG edges).
    apis : (api_name, entry_service, weight) triples.
    len_mean / len_std : per-service Gaussian cloudlet length (MI).
    d_max : pad successor tables to this out-degree (default: observed max).
    payloads / payload_stds : (caller, callee) → RPC payload mean/std in MB
        (network fabric; unlisted edges get ``default_payload_mb`` /
        10% of the mean).
    api_payloads : api name → client→entry payload mean in MB.
    retries / api_retries : per-edge retry budgets (resilience, §7);
        unlisted edges fall back to the run-wide ``SimParams.retry_budget``.
    timeouts / api_timeouts : per-edge attempt timeouts in seconds (§7);
        unlisted edges fall back to the run-wide
        ``SimParams.retry_timeout_s``, so timeout budgets can match the
        per-edge retry budgets.
    """
    names = list(services)
    index = {n: i for i, n in enumerate(names)}
    S = len(names)
    succ_lists: List[List[int]] = [[] for _ in range(S)]
    pred_lists: List[List[int]] = [[] for _ in range(S)]
    for src, dsts in calls.items():
        for dst in dsts:
            if src not in index or dst not in index:
                raise KeyError(f"unknown service in edge {src}->{dst}")
            succ_lists[index[src]].append(index[dst])
            pred_lists[index[dst]].append(index[src])

    obs_out = max([len(l) for l in succ_lists], default=1) or 1
    obs_in = max([len(l) for l in pred_lists], default=1) or 1
    d_out = max(d_max or 0, obs_out)
    d_in = max(d_max or 0, obs_in)

    succ = np.full((S, d_out), -1, dtype=np.int32)
    pred = np.full((S, d_in), -1, dtype=np.int32)
    for i, l in enumerate(succ_lists):
        succ[i, : len(l)] = l
    for i, l in enumerate(pred_lists):
        pred[i, : len(l)] = l

    n_succ = np.array([len(l) for l in succ_lists], dtype=np.int32)
    n_pred = np.array([len(l) for l in pred_lists], dtype=np.int32)

    api_names = [a[0] for a in apis]
    api_entry = np.array([index[a[1]] for a in apis], dtype=np.int32)
    api_weight = np.array([a[2] for a in apis], dtype=np.float32)
    if api_weight.sum() <= 0:
        raise ValueError("API weights must sum to a positive value")

    mean = np.array([len_mean[n] for n in names], dtype=np.float32)
    if len_std is None:
        std = 0.1 * mean
    else:
        std = np.array([len_std.get(n, 0.1 * len_mean[n]) for n in names],
                       dtype=np.float32)

    def edge_slot(src: str, dst: str, what: str) -> Tuple[int, int]:
        """Resolve a (caller, callee) name pair to its successor-table
        (row, slot) — shared by every per-edge table (payloads, retries)."""
        if src not in index or dst not in index:
            raise KeyError(f"unknown service in {what} edge {src}->{dst}")
        try:
            d = succ_lists[index[src]].index(index[dst])
        except ValueError:
            raise KeyError(
                f"{what} declared for non-edge {src}->{dst}: add {dst!r} "
                f"to {src!r}'s calls first") from None
        return index[src], d

    # Per-edge payload tables, aligned with the padded succ table.
    payloads = payloads or {}
    payload_stds = payload_stds or {}
    payload_mean = np.full((S, d_out), default_payload_mb, np.float32)
    payload_std = 0.1 * payload_mean
    for (src, dst), mb in payloads.items():
        s, d = edge_slot(src, dst, "payload")
        payload_mean[s, d] = mb
        payload_std[s, d] = payload_stds.get((src, dst), 0.1 * mb)
    api_payloads = api_payloads or {}
    api_payload_mean = np.array(
        [float(api_payloads.get(a[0], default_payload_mb)) for a in apis],
        np.float32)
    api_payload_std = 0.1 * api_payload_mean

    # Per-edge retry budgets, aligned with the padded succ table (§7).
    edge_retry = np.full((S, d_out), -1, np.int32)
    for (src, dst), n in (retries or {}).items():
        s, d = edge_slot(src, dst, "retry budget")
        edge_retry[s, d] = int(n)
    api_retry = np.array(
        [int((api_retries or {}).get(a[0], -1)) for a in apis], np.int32)

    # Per-edge attempt timeouts, same resolver/layout as the retry table.
    edge_timeout = np.full((S, d_out), -1.0, np.float32)
    for (src, dst), sec in (timeouts or {}).items():
        s, d = edge_slot(src, dst, "timeout")
        edge_timeout[s, d] = float(sec)
    api_timeout = np.array(
        [float((api_timeouts or {}).get(a[0], -1.0)) for a in apis],
        np.float32)

    # Topological levels (longest distance from any root).
    levels = np.zeros(S, dtype=np.int32)
    indeg = n_pred.copy()
    queue = [i for i in range(S) if indeg[i] == 0]
    order = []
    while queue:
        u = queue.pop()
        order.append(u)
        for v in succ[u]:
            if v >= 0:
                levels[v] = max(levels[v], levels[u] + 1)
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(int(v))
    graph = ServiceGraph(
        names=names, succ=succ, pred=pred, n_succ=n_succ, n_pred=n_pred,
        api_names=api_names, api_entry=api_entry, api_weight=api_weight,
        len_mean=mean, len_std=std, levels=levels,
        payload_mean=payload_mean, payload_std=payload_std,
        api_payload_mean=api_payload_mean, api_payload_std=api_payload_std,
        edge_retry=edge_retry, api_retry=api_retry,
        edge_timeout=edge_timeout, api_timeout=api_timeout,
    )
    graph.validate()
    return graph


def linear_chain(n: int, mi: float = 1000.0,
                 name: str = "svc") -> ServiceGraph:
    """n-service pipeline svc0 → svc1 → … (test/benchmark helper)."""
    names = [f"{name}{i}" for i in range(n)]
    calls = {names[i]: [names[i + 1]] for i in range(n - 1)}
    return build_graph(names, calls, [("GET /chain", names[0], 1.0)],
                       {nm: mi for nm in names})


def star(n_leaves: int, mi: float = 1000.0) -> ServiceGraph:
    """Fan-out: gateway → n_leaves parallel services (capacity tests)."""
    names = ["gateway"] + [f"leaf{i}" for i in range(n_leaves)]
    calls = {"gateway": names[1:]}
    return build_graph(names, calls, [("GET /fanout", "gateway", 1.0)],
                       {nm: mi for nm in names}, d_max=n_leaves)


def diamond(mi: float = 1000.0) -> ServiceGraph:
    """Paper Fig 6: A → {B, C} → D."""
    return build_graph(
        ["A", "B", "C", "D"],
        {"A": ["B", "C"], "B": ["D"], "C": ["D"]},
        [("GET /demo", "A", 1.0)],
        {"A": mi, "B": mi, "C": 2 * mi, "D": mi},
    )
