"""Op lint — every aten operation one eager step of the tick dispatches,
held to the hot loop's rules; the counterpart of
``repro.analysis.jaxpr_lint``, renamed because the port has no jaxpr to
walk.

On the card the tick is ``engine.TickLoop``'s step, captured once as CUDA
graphs and replayed; what the step dispatches eagerly is what the graphs
replay.  :class:`OpRecorder` (a ``TorchDispatchMode``) records each
operation with the port's call site that issued it, and :func:`lint_loop`
applies the rules:

* ``f64`` — a float64 or complex128 tensor made or consumed inside the
  step, outside the sites that own a widening.  The port widens to float64
  on purpose to get the reference's bits: ``random.fma32``'s round-to-odd
  sum, the plain float64 Horner steps of ``random._fma32_poly`` and the
  correctly rounded square root of ``erf_inv`` (``random._sqrt32``).  The
  module that owns such a site declares it with :func:`declare_wide`
  (the counterpart of ``jaxpr_lint.declare_callback``); a float64 value
  that reaches an undeclared frame still fails.  int64 is not flagged,
  unlike the reference's rule: it is the port's threefry word (uint32
  arithmetic in int64) and torch's index type, so every key draw and
  every gather and scatter holds it by design.
* ``sync`` — an operation that reads a device value on the host
  (``_local_scalar_dense`` behind ``.item()`` and ``bool()``,
  ``nonzero``, ``masked_select``, ``unique*``, ``repeat_interleave``
  without ``output_size``, ``is_nonzero``, ``equal``, boolean-mask
  indexing).  It holds on the CPU too, where nothing waits; on the card
  :func:`sync_sites` cross-checks it with ``torch.cuda.set_sync_debug_mode``.
* ``transfer`` — a copy between devices inside the step, or a tensor made
  from host data (``lift_fresh``: ``torch.tensor`` of Python values).
* ``writeback`` — the counterpart of ``donation``: every loop buffer (the
  state's leaves, the traces, the swept values, the application, the key
  table and counter, the error word) keeps its address across two steps,
  and no two state leaves share storage, so a captured graph keeps
  writing where the next replay reads.

Findings are ``"rule: detail"`` strings, so ``waivers.toml`` applies by
rule id.  :func:`lint_combo` covers the reference's six lint combos.
This module imports no ``repro_torch.core`` at import time
(``random`` imports it to declare its sites).
"""
from __future__ import annotations

import collections
import dataclasses
import os
import sys
import traceback
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

WIDE_DTYPES = (torch.float64, torch.complex128)

# operations that read a device value on the host
SYNC_OPS = frozenset((
    "_local_scalar_dense", "is_nonzero", "nonzero", "masked_select",
    "unique", "_unique", "_unique2", "unique_dim", "unique_consecutive",
    "equal"))
# indexing operations that read a boolean mask's true count on the host
MASK_INDEX_OPS = frozenset(("index", "index_put", "index_put_",
                            "_index_put_impl_"))
# operations that copy between devices when their operands differ
COPY_OPS = frozenset(("_to_copy", "copy_", "copy", "_copy_from",
                      "_copy_from_and_resize"))
HOST_DATA_OPS = frozenset(("lift_fresh", "lift_fresh_copy"))
VIEW_OPS = frozenset((
    "view", "select", "slice", "expand", "reshape", "unsqueeze", "t",
    "transpose", "alias", "_unsafe_view", "squeeze", "permute", "as_strided",
    "detach", "lift_fresh"))

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))
# analysis modules whose frames are part of the tick (the rest run it)
_TICK_ANALYSIS = ("annotate.py", "streams.py")

# Code objects of the functions allowed to widen to float64 (populated by
# the modules that own them).
_DECLARED_WIDE: Dict[object, str] = {}


def declare_wide(*fns: Callable) -> None:
    """Allow float64 inside ``fns`` (and what they call)."""
    for fn in fns:
        _DECLARED_WIDE[fn.__code__] = f"{fn.__module__}.{fn.__qualname__}"


class Shape(tuple):
    """A tensor argument's shape in :attr:`Op.args` (a plain tuple there
    is a list of numbers, such as reduced dims)."""


def describe(x):
    """An operation argument as :attr:`Op.args` keeps it: a tensor as its
    :class:`Shape`, a list as a tuple of its items' descriptions, a number,
    bool, string or None as itself, anything else (a dtype, a device) as
    its string."""
    if isinstance(x, torch.Tensor):
        return Shape(x.shape)
    if isinstance(x, (list, tuple)):
        return tuple(describe(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return str(x)


def describe_args(func, args, kwargs) -> Tuple[Tuple[str, object], ...]:
    """``(name, description)`` of each argument of an aten call, named by
    the operation's schema (``dim``, ``index``, ``indices``, ...)."""
    names = [a.name for a in func._schema.arguments]
    out = [(n, describe(v)) for n, v in zip(names, args)]
    return tuple(out + [(n, describe(v)) for n, v in kwargs.items()])


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched operation: its aten name (``"add.Tensor"``), the
    port's frame that issued it (``"scheduler.py:142 dispatch"``), the
    grouping ``tick_ops_by_site`` counts by, and what the rules need.  A
    recorder made with ``detail=True`` also keeps its arguments
    (:func:`describe_args`) and its outputs' shapes, which the
    shardability audit classifies by."""

    name: str
    site: str
    group: str
    wide: Tuple[str, ...]
    declared: bool
    sync: bool
    transfer: Optional[str]
    checked: bool
    args: Tuple[Tuple[str, object], ...] = ()
    outs: Tuple[Shape, ...] = ()

    @property
    def packet(self) -> str:
        return self.name.split(".")[0]

    @property
    def view(self) -> bool:
        return self.packet in VIEW_OPS


def _frames() -> Tuple[list, bool]:
    """The port's frames on the stack, innermost first (the analysis
    modules that run the step apart), and whether any frame is a declared
    widening site."""
    out, declared = [], False
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG) and (not fn.startswith(_HERE)
                                    or fn.endswith(_TICK_ANALYSIS)):
            out.append(f)
        declared = declared or f.f_code in _DECLARED_WIDE
        f = f.f_back
    return out, declared


def _tensors(*trees) -> list:
    """The tensors in operation arguments (nested lists, tuples, dicts)."""
    out, stack = [], list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _transfer(packet: str, ins: list, outs: list) -> Optional[str]:
    if packet in HOST_DATA_OPS:
        return "a tensor made from host data"
    out_dev = {t.device for t in outs}
    if packet in COPY_OPS:
        src = {t.device for t in ins}
        if len(src | out_dev) > 1:
            return ("a copy " + " -> ".join(sorted(map(str, src | out_dev))))
        return None
    host = [t for t in ins if t.device.type == "cpu" and t.dim() > 0]
    if host and any(d.type != "cpu" for d in out_dev):
        return "a host tensor operand of a device operation"
    return None


def _sync(packet: str, args, kwargs) -> bool:
    if packet in SYNC_OPS:
        return True
    if packet == "repeat_interleave":
        return kwargs.get("output_size") is None and any(
            isinstance(a, torch.Tensor) for a in args[:2])
    if packet in MASK_INDEX_OPS and len(args) > 1:
        idx = args[1] if isinstance(args[1], (list, tuple)) else ()
        return any(isinstance(t, torch.Tensor)
                   and t.dtype in (torch.bool, torch.uint8) for t in idx)
    return False


class OpRecorder(TorchDispatchMode):
    """Records every operation dispatched inside it as an :class:`Op`."""

    def __init__(self, detail: bool = False):
        super().__init__()
        self.ops: List[Op] = []
        self.detail = detail

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__
        packet = name.split(".")[0]
        frames, declared = _frames()
        inner = frames[0] if frames else None
        site = (f"{os.path.basename(inner.f_code.co_filename)}:"
                f"{inner.f_lineno} {inner.f_code.co_name}"
                if inner else "<outside the port>")
        own = [f for f in frames if not f.f_code.co_filename.endswith(
            ("random.py", "engine.py"))]
        group = (f"{os.path.basename(own[0].f_code.co_filename)}:"
                 f"{own[0].f_code.co_name}" if own else "engine.py")
        if any(f.f_code.co_filename.endswith("random.py") for f in frames):
            group += " (random.py)"
        ins, outs = _tensors(args, kwargs), _tensors(out)
        wide = tuple(sorted({str(t.dtype).replace("torch.", "")
                             for t in ins + outs if t.dtype in WIDE_DTYPES}))
        checked = any(f.f_code.co_filename.endswith("annotate.py")
                      for f in frames)
        self.ops.append(Op(
            name, site, group, wide, declared, _sync(packet, args, kwargs),
            _transfer(packet, ins, outs), checked,
            describe_args(func, args, kwargs) if self.detail else (),
            tuple(Shape(t.shape) for t in outs) if self.detail else ()))
        return out


def rule_findings(ops: Iterable[Op]) -> List[str]:
    """The ``f64``, ``sync`` and ``transfer`` findings of recorded
    operations, one per rule, operation and site (with its count)."""
    found: collections.Counter = collections.Counter()
    for op in ops:
        if op.wide and not op.declared:
            found[f"f64: {op.name} at {op.site} makes or consumes "
                  f"{'/'.join(op.wide)} outside the declared widening "
                  "sites"] += 1
        if op.sync:
            found[f"sync: {op.name} at {op.site} reads a device value on "
                  "the host"] += 1
        if op.transfer:
            found[f"transfer: {op.name} at {op.site}: {op.transfer} "
                  "inside the tick"] += 1
    return [text if n == 1 else f"{text} ({n} times)"
            for text, n in found.items()]


def _named(tree, prefix: str) -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for each leaf of a state-like tree (the pool's
    two blocks in place of the pool)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if hasattr(tree, "ints") and hasattr(tree, "flts"):
        return [(prefix + ".ints", tree.ints), (prefix + ".flts", tree.flts)]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _named(getattr(tree, f), f"{prefix}.{f}")]
    return []


def loop_buffers(loop) -> List[Tuple[str, torch.Tensor]]:
    """Every buffer a captured step reads or writes across replays."""
    bufs = (_named(loop.state, "state") + _named(loop.app, "app")
            + [("dyn", loop._dyn), ("keys.table", loop.keys.table),
               ("keys.step", loop.keys.step), ("err", loop.err)])
    if loop.trace is not None:
        bufs += _named(loop.trace, "trace")
    return bufs


def check_storage(loop) -> List[str]:
    """``writeback`` findings of one loop's state: leaves sharing
    storage."""
    seen: Dict[int, str] = {}
    problems = []
    for path, t in _named(loop.state, "state"):
        if t.numel() == 0:
            continue
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            problems.append(
                f"writeback: state leaves {seen[ptr]} and {path} share "
                "storage — a write-back into one overwrites the other")
        else:
            seen[ptr] = path
    return problems


def lint_loop(loop, variants=(False,)) -> Tuple[List[str], List[Op]]:
    """Lint ``loop`` (an ``engine.TickLoop`` with room for
    ``2·len(variants) + 1`` steps in its key table): one warm step of
    each variant (every key stream drawn, every constant built), then one
    recorded step of each, then one more of the first; every buffer's
    address is compared before and after each.  On the card the recorded
    steps also run under ``torch.cuda.set_sync_debug_mode``.  Returns the
    findings and the recorded operations."""
    for due in variants:
        loop.step(due)
    before = {p: t.data_ptr() for p, t in loop_buffers(loop)}
    problems = check_storage(loop)
    rec = OpRecorder()
    moved: List[str] = []

    def note_moved():
        moved.extend(p for p, t in loop_buffers(loop)
                     if before[p] != t.data_ptr() and p not in moved)

    def recorded():
        for due in variants:
            with rec:
                loop.step(due)
            note_moved()
        loop.step(variants[0])
        note_moved()

    if loop.state.tick.device.type == "cuda":
        n, sites = sync_sites(recorded)
        if n:
            problems.append(
                f"sync: {n} synchronising CUDA call(s) in "
                f"{len(variants)} step(s) under set_sync_debug_mode, at "
                f"{dict(sites)}")
    else:
        recorded()
    problems = rule_findings(rec.ops) + problems
    for path in moved:
        problems.append(
            f"writeback: loop buffer {path} moved to a new address in a "
            "step — a fresh leaf escaped the write-back, so a replayed "
            "graph would keep writing the old buffer")
    return problems, rec.ops


def lint_sim(sim) -> Tuple[List[str], List[Op]]:
    """:func:`lint_loop` of ``sim``'s solo tick from its initial state,
    each scaling variant of the step its run replays."""
    from .layout_check import eager_loop
    variants = (False, True) if sim._scales else (False,)
    return lint_loop(eager_loop(sim, cap=2 * len(variants) + 1), variants)


def lint_combo(network: str, faults: str, telemetry: str = "none",
               device="cuda") -> List[str]:
    """The lint of one of the reference's lint combos on the tiny sim
    (``telemetry``: ``"none"``, ``"stream"`` or ``"alert"``)."""
    from .layout_check import _tiny_sim
    tel = {"none": False, "stream": True, "alert": "alert"}[telemetry]
    return lint_sim(_tiny_sim(network, faults, False, tel, device))[0]


def tick_ops_by_site(sim) -> collections.Counter:
    """The tensor operations one eager tick of ``sim`` dispatches (views
    apart), on ``sim``'s device, by the port's function that issued them:
    each becomes one device operation of the replayed tick on the card,
    except the kernels' plain versions (``ref.py``), which the card runs
    as one launch each.  "(random.py)" marks the operations issued inside
    ``random.py`` (the draws, ``fma32``, ``div32``) on that function's
    behalf."""
    from .layout_check import eager_loop
    loop = eager_loop(sim, cap=3)
    loop.step(False)
    loop.step(False)
    rec = OpRecorder()
    with rec:
        loop.step(False)
    return collections.Counter(op.group for op in rec.ops if not op.view)


def sync_sites(fn) -> Tuple[int, Dict[str, int]]:
    """Run ``fn()`` under CUDA sync debug mode "warn": the number of
    synchronising CUDA calls it made, and the port's call sites that made
    them."""
    sites = []

    def show(message, category, filename, lineno, file=None, line=None):
        text = str(message)
        # count the per-call warnings, not the mode's one-time notice
        if "synchroniz" in text and "prototype" not in text:
            stack = [f"{f.filename.rsplit('src/', 1)[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "repro_torch" in f.filename]
            sites.append(" < ".join(reversed(stack[-3:])))

    saved = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = saved
    counts: Dict[str, int] = {}
    for site in sites:
        counts[site] = counts.get(site, 0) + 1
    return len(sites), counts
