"""Host-side trace reconstruction for the sampled request set (§9).

Each finished cloudlet of a sampled request left one span in the span
ring: (req, service, inst, host, src_host, edge, attempt, wait_ticks)
ints and (arrival, start, finish) f32 timestamps.  This module rebuilds
the per-request span *tree* (parentage is encoded in the edge id:
``edge = parent_service * d_max + slot`` for call edges,
``edge = S * d_max + api`` for the client→entry root) and cross-checks
the end-to-end latency three ways:

1. **Timestamp identity** — ``f32(max span finish) - f32(root arrival)``
   recomputes exactly the engine's ``response = finish - arrival``
   (finish is the scatter-max of span finishes), so for a successful
   request with all spans recorded the reconstruction is *bitwise*
   equal.
2. **Tropical closure over the span DAG** — per-span sojourn delays
   (f64 diffs of f32 timestamps: exact) closed with the same max-plus
   squaring as ``kernels/tropical`` / ``core/critical_path.py`` (Alg 2),
   mirrored here in NumPy float64 because sojourn diffs need more
   mantissa than the f32 device kernel carries.  Derive hands each
   child ``arrival = parent finish`` bitwise, so every root→leaf path
   telescopes and the closure reproduces the response exactly for
   retry-free traces (a retry re-arrives at its respawn time, which
   breaks the telescoping — those traces are flagged, not asserted).
3. **Graph-level Alg 2** — when each service ran exactly once, the
   per-service sojourns feed ``critical_path.response_times`` directly
   (one ``tropical_closure`` launch on the card; f32: approximate
   consistency, not bitwise).

The spans are read from a state on any device; the graph-level closure
runs on the state's device unless ``device`` says otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.critical_path import response_times
from ..core.graph import ServiceGraph
from ..core.types import TEL_SPAN_F_COLUMNS, TEL_SPAN_I_COLUMNS, SimState

NEG_INF = -np.inf


@dataclasses.dataclass
class Span:
    """One hop of a sampled request (a finished cloudlet)."""

    req: int
    service: int
    inst: int
    host: int
    src_host: int
    edge: int
    attempt: int
    wait_ticks: int
    arrival: np.float32
    start: np.float32
    finish: np.float32
    parent: Optional["Span"] = None
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def sojourn(self) -> float:
        """Queue-wait + exec + transit, exact in float64."""
        return float(np.float64(self.finish) - np.float64(self.arrival))

    @property
    def exec_s(self) -> float:
        if self.start < 0:
            return 0.0
        return float(np.float64(self.finish) - np.float64(self.start))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def spans_np(state: SimState) -> Dict[str, np.ndarray]:
    """Recorded spans as named columns, trimmed to ``span_n``."""
    tel = state.telemetry
    n = int(_np(tel.span_n)[0]) if tel.span_n.numel() else 0
    si = _np(tel.span_i)[:n]
    sf = _np(tel.span_f)[:n]
    out = {c: si[:, j] for j, c in enumerate(TEL_SPAN_I_COLUMNS)}
    out.update({c: sf[:, j] for j, c in enumerate(TEL_SPAN_F_COLUMNS)})
    return out


def spans_of(state: SimState, req: Optional[int] = None) -> List[Span]:
    """Materialize :class:`Span` objects (optionally one request's)."""
    cols = spans_np(state)
    n = len(cols["req"])
    out = []
    for i in range(n):
        if req is not None and int(cols["req"][i]) != req:
            continue
        out.append(Span(
            req=int(cols["req"][i]), service=int(cols["service"][i]),
            inst=int(cols["inst"][i]), host=int(cols["host"][i]),
            src_host=int(cols["src_host"][i]), edge=int(cols["edge"][i]),
            attempt=int(cols["attempt"][i]),
            wait_ticks=int(cols["wait_ticks"][i]),
            arrival=np.float32(cols["arrival"][i]),
            start=np.float32(cols["start"][i]),
            finish=np.float32(cols["finish"][i])))
    return out


def sampled_requests(state: SimState) -> np.ndarray:
    """Request ids with at least one recorded span."""
    return np.unique(spans_np(state)["req"])


def trace_tree(spans: List[Span], n_services: int, d_max: int
               ) -> List[Span]:
    """Link spans into call trees; returns the roots.

    Parentage: a call edge ``e < S*d_max`` was spawned by service
    ``e // d_max``; ``e >= S*d_max`` is the client→entry root edge.
    The ``edge`` column is chaos-mode only — when absent (−1) every
    other span is a parent candidate.  Within the candidates the parent
    is the span whose ``finish`` equals the child's ``arrival`` bitwise
    (Derive hands successors ``arrival = parent tfin`` exactly;
    ``finish > arrival`` strictly, so timestamp links cannot cycle) —
    falling back to the sole candidate when timestamps are ambiguous.
    """
    roots = []
    by_service: Dict[int, List[Span]] = {}
    for s in spans:
        by_service.setdefault(s.service, []).append(s)
    for s in spans:
        if s.edge >= n_services * d_max:
            roots.append(s)              # client→entry edge
            continue
        if s.edge >= 0:
            cands = by_service.get(s.edge // d_max, [])
        else:                            # no edge column: match any span
            cands = [p for p in spans if p is not s]
        exact = [p for p in cands if p is not s
                 and np.float32(p.finish) == np.float32(s.arrival)]
        parent = exact[0] if exact else (
            cands[0] if s.edge >= 0 and len(cands) == 1 else None)
        if parent is None:
            roots.append(s)
        else:
            s.parent = parent
            parent.children.append(s)
    return roots


def _all_spans(roots: List[Span]) -> List[Span]:
    out, stack = [], list(roots)
    while stack:
        s = stack.pop()
        out.append(s)
        stack.extend(s.children)
    return out


def tree_latency(roots: List[Span]) -> np.float32:
    """Timestamp identity: f32(max finish) − f32(root arrival).

    Bitwise equal to the engine's recorded response for a successful
    request whose spans were all recorded (the engine's finish is the
    scatter-max of exactly these tfin values).
    """
    spans = _all_spans(roots)
    fin = np.float32(max(np.float32(s.finish) for s in spans))
    arr = np.float32(min(np.float32(s.arrival) for s in roots))
    return np.float32(fin - arr)


def np_tropical_closure(a: np.ndarray, depth: int) -> np.ndarray:
    """Max-plus closure by repeated squaring — the float64 host mirror
    of ``kernels/tropical`` (same (I ⊕ A)^(2^⌈log₂ d⌉) recurrence; f64
    because exact sojourn diffs exceed the f32 kernel's mantissa)."""
    n = a.shape[0]
    m = np.maximum(a, np.where(np.eye(n, dtype=bool), 0.0, NEG_INF))
    for _ in range(max(1, int(np.ceil(np.log2(max(depth, 2)))))):
        m = np.max(m[:, :, None] + m[None, :, :], axis=1)
    return m


def tropical_latency(roots: List[Span]) -> np.float32:
    """Alg 2 over the trace's own span DAG: close the parent→child
    delay matrix (``A[i, j] = sojourn(j)``) and take
    ``sojourn(root) + max(D*[root], 0)`` — exactly
    ``critical_path.response_times`` at span granularity."""
    spans = _all_spans(roots)
    n = len(spans)
    idx = {id(s): i for i, s in enumerate(spans)}
    a = np.full((n, n), NEG_INF)
    for s in spans:
        for c in s.children:
            a[idx[id(s)], idx[id(c)]] = c.sojourn
    d_star = np_tropical_closure(a, depth=n)
    best = NEG_INF
    for r in roots:
        i = idx[id(r)]
        best = max(best, r.sojourn + max(float(d_star[i].max()), 0.0))
    return np.float32(best)


def graph_latency(roots: List[Span], graph: ServiceGraph, api: int,
                  device="cuda") -> Optional[np.float32]:
    """Graph-level Alg 2 (``critical_path.response_times`` on ``device``)
    fed with per-service sojourns — only defined when every service in
    the trace ran exactly once (f32: consistency check, not bitwise)."""
    spans = _all_spans(roots)
    per_svc: Dict[int, List[Span]] = {}
    for s in spans:
        per_svc.setdefault(s.service, []).append(s)
    if any(len(v) != 1 for v in per_svc.values()):
        return None
    delays = np.zeros(graph.n_services, np.float64)
    for svc, (s,) in per_svc.items():
        delays[svc] = s.sojourn
    rt = response_times(graph, delays, device=device)
    return np.float32(rt[api])


@dataclasses.dataclass
class TraceCheck:
    """One sampled request's reconstruction vs the engine's record."""

    req: int
    api: int
    n_spans: int
    retry_free: bool       # all attempts 0 → telescoping sums are exact
    failed: bool           # request completed as failed (chaos mode)
    response: np.float32   # engine-recorded response time
    tree: np.float32       # timestamp identity (bitwise when complete)
    tropical: np.float32   # span-DAG tropical closure (exact retry-free)
    graph: Optional[np.float32]  # graph-level Alg 2 (approximate)

    @property
    def exact(self) -> bool:
        return (not self.failed and self.retry_free
                and self.tree == self.response
                and self.tropical == self.response)


def verify_traces(state: SimState, graph: ServiceGraph, d_max: int,
                  device=None) -> List[TraceCheck]:
    """Reconstruct every completed sampled request and compare its span
    tree's latency against the engine's response (see module doc for
    which comparisons are bitwise); the graph-level closures run on
    ``device`` (default: the state's)."""
    req = state.requests
    if device is None:
        device = req.response.device
    response = _np(req.response)
    api = _np(req.api)
    failed_col = _np(req.failed)
    out = []
    for r in sampled_requests(state):
        r = int(r)
        if response[r] < 0:              # still open at end of run
            continue
        spans = spans_of(state, r)
        roots = trace_tree(spans, graph.n_services, d_max)
        if not roots:
            continue
        out.append(TraceCheck(
            req=r, api=int(api[r]), n_spans=len(spans),
            retry_free=all(s.attempt == 0 for s in spans),
            failed=bool(failed_col[r]) if failed_col.size else False,
            response=np.float32(response[r]),
            tree=tree_latency(roots),
            tropical=tropical_latency(roots),
            graph=graph_latency(roots, graph, int(api[r]), device)))
    return out


def format_trace(roots: List[Span], indent: int = 0) -> str:
    """Render a span tree, one hop per line (example/debug output)."""
    lines = []
    for s in sorted(roots, key=lambda x: float(x.arrival)):
        lines.append(
            f"{'  ' * indent}svc={s.service} inst={s.inst} "
            f"host={s.host} attempt={s.attempt} "
            f"wait={s.wait_ticks}t arr={float(s.arrival):.4f} "
            f"fin={float(s.finish):.4f} sojourn={s.sojourn:.4f}s")
        if s.children:
            lines.append(format_trace(s.children, indent + 1))
    return "\n".join(lines)
