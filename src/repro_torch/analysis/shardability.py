"""Sharding-readiness auditor — which operations of the tick stay
shard-local when the cloudlet axis C and the instance axis I are split
over devices, and which need communication; the counterpart of
``repro.analysis.shardability`` (DESIGN.md §8).

The reference walks the tick's jaxpr; the port has none, so this audit
classifies the aten operations one eager step of ``engine.TickLoop``
dispatches, recorded by :class:`ShardRecorder` (an
``op_lint.OpRecorder`` that keeps each operation's argument and output
shapes, the dims it reduces, gathers or scatters along, and the phase the
engine's ``probe`` announced last).  The analysis is extent-based, as the
reference's: the audit sim has collision-free caps (C=96, I=12/13), so a
dim of extent 96 IS the cloudlet axis.  Each operation is classified:

* ``local`` — no labeled dim, or elementwise or structural along them;
* ``gather`` — reads or writes across a labeled dim in a data-dependent
  or sequential way (an index into it, a scatter-set, a cumsum or sort
  along it, a view or concatenation that merges it away);
* ``all_reduce`` — an associative combine across a labeled dim (a
  reduction over it, a scatter-add/max/min into it or from it into a
  replicated target, a contraction over it).

Three of the port's idioms would be misread op by op, so a call of the
functions of :func:`units` counts as the one primitive the reference's
jaxpr holds for it, named as the reference names it:

* ``pool.tree_sum`` reshapes C into 32-wide windows before it adds them
  (XLA's summation order): one ``reduce_sum``;
* ``pool``'s drop-mode scatters append overflow rows and flatten the
  batch axis: one ``scatter-add`` or ``scatter``; ``pool.take`` and
  ``pool.at`` are one ``gather`` or ``dynamic_slice``;
* a kernel's CUDA launch dispatches no aten operation, so each kernel
  wrapper counts as its plain version's operations, run on CPU copies of
  its arguments (what the reference's jaxpr holds on the CPU), on the
  card as on the CPU: the two reports are equal.

The ops of ``random.py`` (threefry, the float helpers) count as local, as
the reference's RNG and elementwise primitives do.  Keys name the
reference's primitive where there is one (``reduce_sum``,
``scatter-add``, ``gather``, ``cumsum``, ``reshape``, ...), else the aten
operation.  The per-phase report is pinned as the port's committed
baseline (``shard_baseline.json``); simcheck fails when a change adds
cross-shard operations to a phase.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import sys
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from . import op_lint
from .op_lint import Shape

# the engine's phases, as the reference's ``intervals._PHASES``
_PHASES = ("Generation", "Disruption", "Transit", "Dispatch", "Execute",
           "Alerting", "Derive", "Response", "Scaling", "Telemetry", "Trace")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's modules whose operations all count as local
_LOCAL_FILES = (os.path.join(_PKG, "random.py"),
                os.path.join(_PKG, "analysis", "streams.py"))

# aten operations (overload and trailing "_" stripped) by class, and the
# reference's primitive each counts as
_ELEMENTWISE = frozenset("""
add sub rsub mul div remainder fmod pow neg abs sign floor ceil round trunc
exp exp2 expm1 log log1p log2 sqrt rsqrt reciprocal sigmoid tanh sin cos
erf erfinv maximum minimum clamp clamp_min clamp_max where eq ne lt le gt
ge logical_and logical_or logical_not logical_xor bitwise_and bitwise_or
bitwise_xor bitwise_not __lshift__ __rshift__ __and__ __or__ __xor__
_to_copy to clone detach alias isnan isinf isfinite nan_to_num masked_fill
fill zero lerp addcmul addcdiv tril triu scalar_tensor lift_fresh
""".split())
_FACTORY = frozenset("""
full full_like zeros zeros_like ones ones_like empty empty_like new_zeros
new_full new_empty new_ones arange
""".split())
_STRUCTURAL = {
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "expand": "broadcast_in_dim", "unsqueeze": "broadcast_in_dim",
    "squeeze": "squeeze", "select": "squeeze", "slice": "slice",
    "narrow": "slice", "cat": "concatenate", "stack": "concatenate",
    "transpose": "transpose", "permute": "transpose", "t": "transpose",
    "flip": "rev", "constant_pad_nd": "pad", "copy": "copy_p",
    "as_strided": "reshape", "split": "split", "split_with_sizes": "split",
    "unbind": "split", "repeat": "broadcast_in_dim",
}
_REDUCTIONS = {
    "sum": "reduce_sum", "mean": "reduce_sum", "amax": "reduce_max",
    "max": "reduce_max", "amin": "reduce_min", "min": "reduce_min",
    "argmax": "argmax", "argmin": "argmin", "any": "reduce_or",
    "all": "reduce_and", "prod": "reduce_prod", "logsumexp": "reduce_sum",
    "count_nonzero": "reduce_sum", "tree_sum": "reduce_sum",
}
_SEQUENTIAL = {"cumsum": "cumsum", "cumprod": "cumprod", "cummax": "cummax",
               "cummin": "cummin", "sort": "sort", "argsort": "sort",
               "topk": "sort"}
_GATHERS = {"index": "gather", "gather": "gather", "index_select": "gather",
            "take": "gather", "embedding": "gather",
            "dynamic_slice": "dynamic_slice"}
# scatters: (primitive, associative)
_SCATTERS = {"index_put": None, "index_add": ("scatter-add", True),
             "index_copy": ("scatter", False),
             "index_fill": ("scatter", False), "scatter": None,
             "scatter_add": ("scatter-add", True), "scatter_reduce": None,
             "put": None}
_REDUCE_SCATTER = {"sum": "scatter-add", "mean": "scatter-add",
                   "prod": "scatter-mul", "amax": "scatter-max",
                   "amin": "scatter-min", "add": "scatter-add",
                   "multiply": "scatter-mul"}
_MATMULS = frozenset("mm bmm matmul addmm dot einsum linear".split())


@dataclasses.dataclass
class ShardEqn:
    """One cross-shard operation (the reference's name: it recorded jaxpr
    equations; here each is an aten operation or a call of a unit):
    its phase, class, the primitive it counts as, its site and why."""

    phase: str
    cls: str        # "gather" | "all_reduce"
    prim: str
    site: str
    why: str

    def __str__(self):
        return (f"{self.phase:>10s} {self.cls:<10s} {self.prim:<18s} "
                f"{self.site}  ({self.why})")


@dataclasses.dataclass
class ShardReport:
    combo: str
    entries: List[ShardEqn]          # non-local operations only
    n_local: int
    n_total: int

    def phase_table(self) -> Dict[str, Dict[str, int]]:
        """phase -> {'gather': n, 'all_reduce': n} (phases with no
        cross-shard operations map to zeros)."""
        table = {p: {"gather": 0, "all_reduce": 0} for p in _PHASES}
        for e in self.entries:
            table.setdefault(e.phase, {"gather": 0, "all_reduce": 0})
            table[e.phase][e.cls] += 1
        return table

    def to_json(self) -> dict:
        """Baseline shape: per (phase, class, primitive) counts — stable
        across line-number churn, sensitive to new cross-shard ops."""
        counts = Counter((e.phase, e.cls, e.prim) for e in self.entries)
        return {
            "combo": self.combo,
            "n_local": self.n_local,
            "n_total": self.n_total,
            "cross_shard": {f"{p}:{c}:{m}": n
                            for (p, c, m), n in sorted(counts.items())},
        }

    def summary(self) -> str:
        t = self.phase_table()
        hot = sum(v["gather"] + v["all_reduce"] for v in t.values())
        return (f"{self.combo}: {self.n_total} ops, "
                f"{self.n_local} shard-local, {hot} cross-shard "
                f"({sum(v['gather'] for v in t.values())} gather, "
                f"{sum(v['all_reduce'] for v in t.values())} all-reduce)")


# --------------------------------------------------------------------------
# Recording
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardOp:
    """A recorded operation as the audit reads it: ``kind`` is the aten
    operation (or a unit's counterpart) the classifier reads ``args``
    (schema name -> description) by, ``name`` what the report shows."""

    phase: str
    name: str
    kind: str
    args: Dict[str, object]
    outs: Tuple[Shape, ...]
    site: str
    local: bool = False


def _site(op_site: str) -> str:
    """``"pool.py:111 add_drop"`` as the reference writes a site,
    ``"pool.py:111 (add_drop)"``."""
    where, _, fn = op_site.partition(" ")
    return f"{where} ({fn})" if fn else where


def _caller_site(frame) -> str:
    f = frame.f_back
    return (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
            f"({f.f_code.co_name})")


def _dim(v, nd: int) -> int:
    return v % nd if nd else 0


def _tree_sum(loc):
    x = loc["x"]
    return "tree_sum", {"self": Shape(x.shape), "dim": (loc["dim"],)}


def _scatter_unit(dst, ids, feat=()):
    return {"self": Shape(dst), "dim": 1, "index": Shape(ids),
            "source": Shape(tuple(ids) + tuple(feat))}


def _add_drop(loc):
    dst = loc["dst"]
    return "index_add", _scatter_unit(dst.shape, loc["ids"].shape,
                                      dst.shape[2:])


def _set_drop(loc):
    dst = loc["dst"]
    return "index_copy", _scatter_unit(dst.shape, loc["ids"].shape,
                                       dst.shape[2:])


def _segment_sum(loc):
    data = loc["data"]
    return "index_add", _scatter_unit((data.shape[0], loc["n"]),
                                      loc["ids"].shape)


def _scatter_add(loc):
    out, idx = loc["out"], loc["idx"]
    return "index_add", {"self": Shape(out.shape), "dim": 0,
                         "index": Shape(idx.shape),
                         "source": Shape(loc["vals"].shape)}


def _take(loc):
    return "gather", {"self": Shape(loc["table"].shape), "dim": 1,
                      "index": Shape(loc["idx"].shape)}


def _at(loc):
    return "dynamic_slice", {"self": Shape(loc["x"].shape), "dim": 1}


@dataclasses.dataclass(frozen=True)
class Unit:
    """A function whose call counts as one primitive (``describe`` maps
    its frame's locals to ``(kind, args)``) or, for a kernel wrapper
    (``describe`` None), as its plain version's operations."""

    fn: object
    describe: object = None


_UNITS: Dict[object, Unit] = {}


def units() -> Dict[object, Unit]:
    """The units by code object (built at first use: the core imports the
    analysis package, not the other way round)."""
    if not _UNITS:
        from ..core import pool
        from ..kernels.cloudlet_step import ops as cl_ops
        from ..kernels.link_share import ops as ls_ops
        for fn, desc in ((pool.tree_sum, _tree_sum),
                         (pool.add_drop, _add_drop),
                         (pool.set_drop, _set_drop),
                         (pool.segment_sum, _segment_sum),
                         (pool.scatter_add, _scatter_add),
                         (pool.take, _take), (pool.at, _at),
                         (cl_ops.cloudlet_finish_pool, None),
                         (ls_ops.link_share, None)):
            _UNITS[fn.__code__] = Unit(fn, desc)
    return _UNITS


def _host(x):
    """A CPU copy of a kernel wrapper's argument (tensors, the pool's
    blocks, tuples of them); anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if hasattr(x, "ints") and hasattr(x, "flts") and hasattr(x, "layout"):
        return type(x)(_host(x.ints), _host(x.flts), x.layout)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_host, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(_host, x))
    return x


class ShardRecorder(op_lint.OpRecorder):
    """Records every operation dispatched inside it as a :class:`ShardOp`,
    a unit's call as one (or, a kernel wrapper, as its plain version's
    operations on CPU copies).  :meth:`mark` is the engine's ``probe``:
    each operation takes the phase announced last (``"?"`` before the
    first); after ``"end"`` nothing more is recorded.  ``boundary`` is the
    frame of the kernel replay this recorder serves: frames past it are
    not looked at."""

    def __init__(self, boundary=None, phase: str = "?"):
        super().__init__(detail=True)
        self.recs: List[ShardOp] = []
        self.phase = phase
        self._open = None
        self._boundary = boundary

    def __enter__(self):
        # the dispatch state outside any operation, which a kernel's
        # replay (run from inside one) restores, so its plain version is
        # recorded as a top-level call would be, composite ops decomposed
        self._tls = (torch._C._dispatch_tls_local_include_set(),
                     torch._C._dispatch_tls_local_exclude_set())
        return super().__enter__()

    def mark(self, name: str) -> None:
        self.phase = None if name == "end" else name.split("/", 1)[0]

    def _walk(self):
        """(the outermost open unit's frame and :class:`Unit`, or None;
        whether a frame of :data:`_LOCAL_FILES` is on the stack)."""
        table = units()
        found, local = None, False
        f = sys._getframe(2)
        while f is not None and f is not self._boundary:
            u = table.get(f.f_code)
            if u is not None and not (self._boundary is not None
                                      and u.describe is None):
                found = (f, u)
            local = local or f.f_code.co_filename in _LOCAL_FILES
            f = f.f_back
        return found, local

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.phase is None:
            # past the tick's end: the loop's write-back into its buffers
            # (a copy where the CPU's plain kernel returned new arrays,
            # none where the card's kernel wrote in place), not the tick
            return func(*args, **kwargs)
        found, local = self._walk()
        if found is None:
            out = super().__torch_dispatch__(func, types, args, kwargs)
            op = self.ops[-1]
            self.recs.append(ShardOp(self.phase, op.name, _kind(op.name),
                                     dict(op.args), op.outs, _site(op.site),
                                     local))
            return out
        frame, unit = found
        if frame is not self._open:
            # the unit's first operation: count the unit once
            self._open = frame
            if unit.describe is None:
                self._replay(frame, unit)
            else:
                kind, uargs = unit.describe(frame.f_locals)
                self.recs.append(ShardOp(
                    self.phase, f"pool.{unit.fn.__name__}", kind, uargs, (),
                    _caller_site(frame), local))
        return func(*args, **kwargs)

    def _replay(self, frame, unit) -> None:
        """The kernel wrapper's plain version on CPU copies of the
        arguments it was called with, recorded in this phase."""
        loc = frame.f_locals
        kw = {n: _host(loc[n]) for n in inspect.signature(unit.fn).parameters
              if n in loc}
        child = ShardRecorder(boundary=sys._getframe(), phase=self.phase)
        with torch._C._ForceDispatchKeyGuard(*self._tls), child:
            unit.fn(**kw)
        self.recs.extend(child.recs)


def _arg_shapes(v) -> List[Shape]:
    """The tensor shapes in one described argument (a tensor, or a list
    of tensors and Nones)."""
    if isinstance(v, Shape):
        return [v]
    if isinstance(v, tuple):
        return [s for s in v if isinstance(s, Shape)]
    return []


def _kind(name: str) -> str:
    """``"index_add_.default"`` -> ``"index_add"``."""
    packet = name.split(".")[0]
    if packet.endswith("_") and not packet.endswith("__"):
        packet = packet[:-1]
    return packet


def record(fn, *args, **kwargs) -> List[ShardOp]:
    """The operations of ``fn(*args, **kwargs)`` as the audit reads them
    (no phase: ``"?"``)."""
    rec = ShardRecorder()
    with rec:
        fn(*args, **kwargs)
    return rec.recs


# --------------------------------------------------------------------------
# Classification
# --------------------------------------------------------------------------

class ShardAudit:
    """Classifies recorded operations against an axis spec
    ``{label: (extent, ...)}`` — e.g. ``{"C": (96,), "I": (12, 13)}``
    labels every dim of extent 96 as the cloudlet axis and dims of 12 or
    13 (the [I+1] accumulator rows) as the instance axis."""

    def __init__(self, spec: Dict[str, Tuple[int, ...]]):
        self.ext2label: Dict[int, str] = {}
        for label, extents in spec.items():
            for e in extents:
                if e in self.ext2label:
                    raise ValueError(
                        f"axis extent {e} labeled both "
                        f"{self.ext2label[e]!r} and {label!r} — pick "
                        f"collision-free caps for the audit sim")
                self.ext2label[e] = label
        self.entries: List[ShardEqn] = []
        self.n_local = 0
        self.n_total = 0

    # -- labeling ----------------------------------------------------------

    def _label_counts(self, shape) -> Counter:
        """Counter over axis *labels* (not extents): [I+1] -> [I] slices
        keep the label even though the extent changes."""
        return Counter(self.ext2label[int(d)] for d in shape
                       if int(d) in self.ext2label)

    def _label(self, shape, d) -> Optional[str]:
        return self.ext2label.get(int(shape[d])) if len(shape) else None

    @staticmethod
    def _shapes(op: ShardOp) -> List[Shape]:
        return [s for v in list(op.args.values()) + list(op.outs)
                for s in _arg_shapes(v)]

    # -- walk --------------------------------------------------------------

    def run(self, ops: List[ShardOp]) -> None:
        for op in ops:
            self.n_total += 1
            cls, prim, why = self._classify(op)
            if cls == "local":
                self.n_local += 1
                continue
            self.entries.append(ShardEqn(op.phase, cls, prim, op.site,
                                         why))

    # -- classification ----------------------------------------------------

    def _classify(self, op: ShardOp) -> Tuple[str, str, str]:
        local = ("local", "", "")
        if op.local or not any(self._label_counts(s)
                               for s in self._shapes(op)):
            return local
        k, a = op.kind, op.args
        if k in _ELEMENTWISE or k in _FACTORY:
            return local
        self_shape = a.get("self", a.get("input", Shape()))
        nd = len(self_shape)

        if k in _REDUCTIONS:
            if "other" in a:            # max.other, min.other: binary
                return local
            dims = a.get("dim")
            if dims is None:
                dims = tuple(range(nd))
            elif isinstance(dims, int):
                dims = (dims,)
            for d in dims:
                lbl = self._label(self_shape, _dim(d, nd))
                if lbl:
                    return ("all_reduce", _REDUCTIONS[k],
                            f"reduces the {lbl} axis")
            return local

        if k == "bincount":
            lbl = next(iter(self._label_counts(self_shape)), None)
            if lbl:
                return ("all_reduce", "scatter-add",
                        f"accumulates {lbl}-sharded counts into a "
                        "replicated target")
            return local

        if k in _SEQUENTIAL:
            d = _dim(a.get("dim", -1), nd)
            lbl = self._label(self_shape, d)
            if lbl:
                return ("gather", _SEQUENTIAL[k],
                        f"sequential along the {lbl} axis")
            return local

        if k == "searchsorted":
            seq = a["sorted_sequence"]
            lbl = self._label(seq, len(seq) - 1)
            if lbl:
                return "gather", "searchsorted", f"searches the {lbl} axis"
            return local

        if k in _GATHERS:
            if k == "index":
                dims = [d for d, i in enumerate(a["indices"])
                        if i is not None]
            elif k in ("take", "embedding"):
                shape = a.get("weight", self_shape)
                dims = list(range(len(shape)))
                self_shape, nd = shape, len(shape)
            else:
                dims = [_dim(a["dim"], nd)]
            for d in dims:
                lbl = self._label(self_shape, d)
                if lbl:
                    why = ("dynamic start" if k == "dynamic_slice"
                           else "indexes into")
                    return "gather", _GATHERS[k], f"{why} the {lbl} axis"
            return local

        if k in _SCATTERS:
            prim, assoc = self._scatter_kind(k, a)
            if k in ("index_put",):
                tgt = [d for d, i in enumerate(a["indices"])
                       if i is not None]
            elif k == "put":
                tgt = list(range(nd))
            else:
                tgt = [_dim(a["dim"], nd)]
            for d in tgt:
                lbl = self._label(self_shape, d)
                if lbl:
                    if assoc:
                        return ("all_reduce", prim,
                                f"associative scatter into the {lbl} axis")
                    return "gather", prim, f"scatter-set into the {lbl} axis"
            # sharded dims the operand also carries pass through aligned;
            # only update labels the operand lacks cross shards
            op_lbl = self._label_counts(self_shape)
            for n, v in a.items():
                if n == "self":
                    continue
                for s in _arg_shapes(v):
                    crossing = self._label_counts(s) - op_lbl
                    if crossing:
                        lbl = next(iter(crossing))
                        if assoc:
                            return ("all_reduce", prim,
                                    f"accumulates {lbl}-sharded updates "
                                    "into a replicated target")
                        return ("gather", prim,
                                f"writes {lbl}-sharded updates into a "
                                "replicated target")
            return local

        if k in _MATMULS:
            lhs = a.get("self", a.get("input"))
            if k == "einsum":
                return "gather", "dot_general", "einsum (unclassified)"
            lbl = self._label(lhs, len(lhs) - 1) if lhs else None
            if lbl:
                return "all_reduce", "dot_general", f"contracts the {lbl} axis"
            return local

        if k in _STRUCTURAL:
            # structural ops that keep every labeled AXIS are local — the
            # diff runs over labels, not extents, so [I+1] -> [I] slices
            # pass; flattening a labeled axis away does not
            src = Counter()
            for v in a.values():
                for s in _arg_shapes(v):
                    src |= self._label_counts(s)
            dst = Counter()
            for s in op.outs:
                dst |= self._label_counts(s)
            lost = src - dst
            if lost:
                lbl = next(iter(lost))
                return ("gather", _STRUCTURAL[k],
                        f"{_STRUCTURAL[k]} drops the {lbl} axis")
            return local

        # an unclassified operation touching a sharded dim: surfaced so a
        # new cross-shard dependency can never slip in silently
        return "gather", k, f"unclassified operation {op.name!r}"

    @staticmethod
    def _scatter_kind(k: str, a: dict) -> Tuple[str, bool]:
        fixed = _SCATTERS[k]
        if fixed is not None:
            return fixed
        if k in ("index_put", "put"):
            acc = bool(a.get("accumulate", False))
            return ("scatter-add", True) if acc else ("scatter", False)
        reduce = a.get("reduce")
        if reduce is None:
            return "scatter", False
        return _REDUCE_SCATTER.get(reduce, "scatter-add"), True


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def _audit_sim(network: str, faults: str, device="cuda"):
    """The audit sim: the golden combos' diamond app with collision-free
    caps — C=96 and I=12/13 match no other extent of the tick, so
    extent-based labeling is unambiguous (the reference's)."""
    from ..core import SimCaps, SimParams, Simulation, diamond

    caps = SimCaps(n_clients=7, max_requests=40, max_cloudlets=96,
                   max_instances=12, n_vms=3, d_max=2, max_replicas=4)
    params = SimParams(dt=0.05, n_ticks=4, n_clients=6, spawn_rate=10.0,
                       wait_lo=0.1, wait_hi=0.3, seed=7,
                       scaling_policy=1, network=network, faults=faults)
    return Simulation(diamond(mi=200.0), caps=caps, params=params,
                      device=device)


def default_spec(caps) -> Dict[str, Tuple[int, ...]]:
    """The sharding proposal: cloudlet axis C, instance axis I (with the
    [I+1]-row finish/ejection accumulators)."""
    return {"C": (caps.max_cloudlets,),
            "I": (caps.max_instances, caps.max_instances + 1)}


def record_tick(sim) -> List[ShardOp]:
    """The operations of one eager step of ``sim``'s tick (its scaling
    variant, so the Scaling phase runs, as the reference's ``lax.cond``
    traces it), after one warm step that draws every key stream and builds
    every constant."""
    from .layout_check import eager_loop
    loop = eager_loop(sim, cap=2)
    loop.step(True)
    rec = ShardRecorder()
    with rec:
        loop.step(True, probe=rec.mark)
    return rec.recs


def audit_combo(network: str, faults: str, *, sim=None,
                spec: Optional[Dict[str, Tuple[int, ...]]] = None,
                device="cuda") -> ShardReport:
    sim = sim or _audit_sim(network, faults, device)
    audit = ShardAudit(spec or default_spec(sim.caps))
    audit.run(record_tick(sim))
    return ShardReport(f"{network}+{faults}", audit.entries,
                       audit.n_local, audit.n_total)


def audit_ops(ops: List[ShardOp], spec: Dict[str, Tuple[int, ...]],
              combo: str = "adhoc") -> ShardReport:
    """Library entry for tests: audit recorded operations (:func:`record`)
    against a spec."""
    audit = ShardAudit(spec)
    audit.run(ops)
    return ShardReport(combo, audit.entries, audit.n_local, audit.n_total)


def compare_to_baseline(reports: List[ShardReport],
                        baseline: dict) -> List[str]:
    """Regression gate: a (phase, class, primitive) count may shrink
    (improvement — re-pin the baseline) but any increase or new key is a
    violation."""
    problems: List[str] = []
    base_combos = baseline.get("combos", {})
    for rep in reports:
        cur = rep.to_json()["cross_shard"]
        base = base_combos.get(rep.combo, {}).get("cross_shard")
        if base is None:
            problems.append(
                f"[{rep.combo}] no committed shardability baseline — "
                f"re-pin analysis/shard_baseline.json")
            continue
        for key, n in cur.items():
            b = base.get(key, 0)
            if n > b:
                problems.append(
                    f"[{rep.combo}] cross-shard ops at {key} grew "
                    f"{b} → {n}: a new cross-shard dependency entered "
                    f"this phase (re-pin only if intended)")
    return problems


def baseline_json(reports: List[ShardReport]) -> dict:
    return {"combos": {r.combo: r.to_json() for r in reports}}


def write_report(reports: List[ShardReport], path: str) -> None:
    doc = baseline_json(reports)
    for rep in reports:
        doc["combos"][rep.combo]["phase_table"] = rep.phase_table()
        doc["combos"][rep.combo]["entries"] = [
            dataclasses.asdict(e) for e in rep.entries]
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
