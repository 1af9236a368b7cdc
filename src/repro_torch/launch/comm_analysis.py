"""Per-device cost accounting of one eager DTensor run: collectives, FLOPs,
bytes accessed and the peak of live intermediates (the counterpart of the
reference's ``hlo_analysis``, which parses XLA's partitioned HLO; an eager
run has no HLO, so the counts come from the ops as they run).

``record`` is a ``TorchDispatchMode`` put around the cell's run (under the
cell's ``FakeTensorMode``: nothing is allocated).  It sees each DTensor
op with global shapes; under it a second mode sees what DTensor runs on
each device's local shard: the op itself at local shapes and the
``_c10d_functional`` collectives of any redistribution.  Only ops that
read a local shard (or a tensor computed from one) are counted, so the
shape inference DTensor runs on global stand-ins is not.  Ops outside
DTensor (the optimizer's update on local shards, ``full_tensor``'s
gathers) are per-device work and counted as they are.

* collectives: ``all_gather_into_tensor`` → all-gather,
  ``reduce_scatter_tensor`` → reduce-scatter, ``all_reduce`` →
  all-reduce, ``all_to_all_single`` → all-to-all (their ``_coalesced``
  forms too); bytes are the result's bytes per device, the reference's
  convention; ``wait_tensor`` is not counted, as the reference skips
  ``-done``.  ``summary()`` is the dict ``parse_collectives`` returns.
* ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) at the local shapes; elementwise ops count 0.
* ``bytes_accessed``: each counted op's local inputs plus outputs (views
  move nothing and count 0).
* ``peak_bytes``: the most bytes of local intermediates alive at once
  (tensors the counted ops made, freed when the run drops them: saved
  activations included).

These are eager, unfused counts: every intermediate is written and read
back, and no op is fused, rematerialised or scheduled as XLA's compiled
program would be, so they are not comparable with the reference's XLA
``cost_analysis`` and ``memory_analysis``.
"""
from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_META_OPS = ("prim.", "aten.sym_", "aten.is_", "aten.detach")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor_type(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class record(TorchDispatchMode):
    """Counts of one run: ``with record() as rec: fn(*args)``, then
    ``rec.summary()``, ``rec.flops``, ``rec.bytes_accessed``,
    ``rec.peak_bytes``."""

    def __init__(self):
        super().__init__()
        self.coll = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak_bytes = 0
        self._tracked = weakref.WeakValueDictionary()
        self.last_op = None           # the DTensor op dispatched last

    # -------------------------------------------------------- accounting
    def _is_tracked(self, t) -> bool:
        return self._tracked.get(id(t)) is t

    def _track(self, t: torch.Tensor):
        self._tracked[id(t)] = t

    def _alloc(self, t: torch.Tensor):
        n = _nbytes(t)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int):
        self.live -= n

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry
        name = str(func)
        if name.startswith(_META_OPS):
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in outs:
            self._track(t)
        if name.startswith("_c10d_functional."):
            op = name.split(".")[1]
            if op == "wait_tensor":
                return
            kind = _FUNCTIONAL.get(op)
            if kind is not None:
                self.coll[kind]["count"] += 1
                self.coll[kind]["bytes"] += sum(_nbytes(t) for t in outs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **(kwargs or {}), out_val=out))
        if func.is_view:
            return
        self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        seen = {id(t) for t in ins}          # in place: nothing new
        for t in outs:
            if t._base is None and id(t) not in seen:
                self._alloc(t)

    def summary(self) -> dict:
        """{collective: {"count", "bytes"}} and ``total_bytes``, as the
        reference's ``parse_collectives`` returns it."""
        out = {k: dict(v) for k, v in self.coll.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.coll.values())
        return out

    # -------------------------------------------------------- dispatch
    def _track_shards(self, args, kwargs):
        for t in _tensors((args, kwargs)):
            loc = getattr(t, "_local_tensor", None)
            if loc is not None:
                self._track(loc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_type(types):
            self.last_op = str(func)
            # DTensor's planning makes small index tensors of its own
            # (``_StridedShard`` offsets) and reads them back: real ones,
            # outside the fake mode; the local shards stay fake tensors,
            # which dispatch to their own mode
            with unset_fake_temporarily(), _Local(self):
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out


class _Local(TorchDispatchMode):
    """The ops DTensor runs on local shards, counted into ``rec``."""

    def __init__(self, rec: record):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = self.rec
        if _is_dtensor_type(types):
            # DTensor's own dispatch runs next, its local ops under this
            # mode
            rec._track_shards(args, kwargs)
            return NotImplemented
        out = func(*args, **kwargs)
        if str(func).startswith("_c10d_functional.") or any(
                rec._is_tracked(t) for t in _tensors((args, kwargs))):
            rec._count(func, args, kwargs, out)
        return out
