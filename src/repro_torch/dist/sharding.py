"""Logical-axis → mesh-axis resolution (the sharding rulebook), as the
reference's ``repro.dist.sharding`` rules it, over DTensor.

Every parameter and activation dimension carries a *logical* name
("heads", "batch", ...); the tables below map each name to the mesh axes
it may be sharded over, in preference order.  ``resolve`` applies two
guards per tensor:

  * divisibility: a dim is only sharded if the product of the chosen mesh
    axis sizes divides it (trailing candidate axes are dropped until it
    does); otherwise the dim replicates,
  * uniqueness: a mesh axis is consumed by the first dim that claims it.

Rules name axes that may not exist on the current mesh ("pod" on a
single-pod run); missing axes are skipped, so the same rulebook serves the
256- and 512-device layouts unchanged.

A spec (``PartitionSpec``) is a tuple with one entry per tensor dim:
``None`` (replicated), an axis name, or a tuple of axis names (the dim
split over several mesh axes, major to minor).  ``resolve`` accepts a
``torch.distributed.device_mesh.DeviceMesh`` or an :class:`AbstractMesh`
(axis names and sizes, no devices, no process group: the counterpart of
``jax.sharding.AbstractMesh``).  ``placements`` turns a spec into DTensor
placements, one per mesh dim: ``Shard(d)`` where the spec puts that mesh
axis on tensor dim ``d``, else ``Replicate()``.  DTensor splits a dim
sharded over several mesh dims in mesh-dim order, which is the spec's
major-to-minor order only when the entry lists its axes in the mesh's
order; ``placements`` raises where it does not.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Tuple

import torch

from ..tree import tree_map

PartitionSpec = tuple

# Tensor-parallel parameter dims go to "model"; everything else replicates.
PARAM_RULES: dict = {
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "embed": (),
    "layers": (),
    "state": (),
    "conv": (),
    "frames": (),
    "periods": (),
}

# Activations: batch dims spread over the data-parallel axes (both of them
# on multi-pod meshes); sequence stays local during training.
ACT_RULES: dict = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "frames": (),
    "state": (),
    "conv": (),
    "layers": (),
}


class AbstractMesh:
    """A mesh of axis names and sizes with no devices behind it: what
    ``resolve``, ``shard_shape`` and ``placements`` read of a
    ``DeviceMesh`` (``shape``, ``mesh_dim_names``)."""

    def __init__(self, shape, axis_names):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axis_names)
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} against axes "
                             f"{self.mesh_dim_names}")

    def __repr__(self):
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or ``AbstractMesh`` (the
    reference reads ``mesh.shape[name]``; a ``DeviceMesh``'s shape is a
    tuple in mesh-dim order)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no axis names")
    return dict(zip(names, tuple(mesh.shape)))


def resolve(mesh, shape, axes, rules) -> PartitionSpec:
    """The spec of one tensor given its logical axes and the rules."""
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        cand = [a for a in rules.get(name, ()) or ()
                if a in sizes and a not in used] \
            if name is not None else []
        size = math.prod(sizes[a] for a in cand) if cand else 1
        while cand and dim % size != 0:          # divisibility guard
            size //= sizes[cand[-1]]
            cand.pop()
        if not cand:
            out.append(None)
            continue
        used.update(cand)
        out.append(cand[0] if len(cand) == 1 else tuple(cand))
    return tuple(out)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(mesh, shape, spec: PartitionSpec) -> tuple:
    """Each device's local shape of a tensor of ``shape`` laid out by
    ``spec`` (the guards make every split even)."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        n = math.prod(sizes[a] for a in _entry_axes(entry))
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways ({spec})")
        out.append(dim // n)
    return tuple(out) + tuple(shape[len(spec):])


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim whose axis the spec puts on tensor dim ``d``, ``Replicate()``
    on the others.  A mesh axis the spec names must exist, and a dim's
    axes must be listed in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    where = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not on "
                                 f"the mesh {tuple(names)}")
            if a in where:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            where[a] = d
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {entry} lists its axes out of the mesh's order "
                f"{tuple(names)}: DTensor would split the dim in another "
                "order")
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: what the reference's ``NamedSharding`` holds (a
    leaf of the port's trees, not a container)."""

    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple:
        return shard_shape(self.mesh, shape, self.spec)


def tree_shardings(mesh, abstract_tree, logical_tree, rules):
    """``NamedSharding`` per leaf of ``abstract_tree`` (tensors, meta or
    not).  ``logical_tree`` mirrors the abstract tree down to its leaves,
    where it holds the per-dim logical-name tuples (the tuples are not
    walked: the abstract tree's structure drives the walk)."""
    return tree_map(
        lambda a, axes: NamedSharding(mesh, resolve(mesh, a.shape, axes,
                                                    rules)),
        abstract_tree, logical_tree)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor.  None exists until
    ``torch.distributed.tensor`` is imported (a second and a half), so a
    plain run never imports it for this check."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def constrain(t, axes, rules=None):
    """``t`` laid out by its logical ``axes`` (``ACT_RULES`` unless
    ``rules`` is given) on its own mesh when it is a DTensor; a plain
    tensor unchanged.  The port's ``with_sharding_constraint``: eager
    DTensor picks each op's layout from its inputs alone, where XLA's
    partitioner plans the whole program, so a layout that a later op
    cannot take is pinned back to the logical one."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    spec = resolve(mesh, t.shape, axes, ACT_RULES if rules is None
                   else rules)
    return t.redistribute(mesh, placements(mesh, spec))


def replicate_like(t, ref):
    """``t``, a plain tensor, as a DTensor replicated on ``ref``'s mesh
    where ``ref`` is a DTensor (an op that writes into ``t`` in place then
    has a DTensor to write into); else ``t`` unchanged."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def on_shards(fn, ts, shape, dims=(0, 1), placed=None):
    """``fn`` of the local shards of the DTensors ``ts``, as a DTensor of
    global ``shape``; else None (a plain tensor among ``ts``, or a layout
    this cannot keep).  Every tensor is pinned first to ``ts[0]``'s
    placements, or to ``placed[i]`` where given (one tuple of placements
    per tensor: tensors of other ranks name their own dims), which may
    shard only ``dims`` of ``ts[0]``, evenly, and no partial sum; the
    output takes ``ts[0]``'s.  Eager DTensor runs an einsum as a batched
    product over the flattened batch dims, which torch 2.11 refuses where
    two of them are sharded ("flatten multiple dimensions"); XLA's
    partitioner runs a product batched over sharded dims on each shard,
    and so does this, with no communication (pinning a replicated tensor
    to a shard is a local slice)."""
    if not all(is_dtensor(t) for t in ts):
        return None
    from torch.distributed.tensor import DTensor
    mesh, pl = ts[0].device_mesh, tuple(ts[0].placements)
    placed = placed or (pl,) * len(ts)
    for p in pl:
        if p.is_partial() or (p.is_shard() and p.dim not in dims):
            return None
    for t, tpl in zip(ts, placed):
        if t.device_mesh != mesh:
            return None
        ways: dict = {}
        for p, n in zip(tpl, mesh.shape):
            if p.is_shard():
                ways[p.dim] = ways.get(p.dim, 1) * n
        if any(t.shape[d] % w for d, w in ways.items()):
            return None
    local = [(t if tuple(t.placements) == tuple(tpl)
              else t.redistribute(mesh, tpl)).to_local()
             for t, tpl in zip(ts, placed)]
    out = fn(*local).contiguous()
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=tuple(shape), stride=stride)


def _fit_reshape(t, new: tuple):
    """A DTensor reshaped to ``new``, the dims the view changes replicated
    first where DTensor cannot split them as they are laid out."""
    from torch.distributed.tensor import Replicate
    try:
        return t.reshape(new)
    except RuntimeError as e:
        # "unevenly sharded" (torch 2.13), "split the sharded dimension"
        # (2.11): a view DTensor will not make without a redistribution
        if "shard" not in str(e).lower():
            raise
    old = tuple(t.shape)
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi = 0
    while hi < min(len(old), len(new)) - lo and \
            old[len(old) - 1 - hi] == new[len(new) - 1 - hi]:
        hi += 1
    changed = range(lo, len(old) - hi)
    pl = tuple(Replicate() if p.is_shard() and p.dim in changed else p
               for p in t.placements)
    return t.redistribute(t.device_mesh, pl).reshape(new)


def reshape(t, *shape):
    """``t.reshape(*shape)``, for a DTensor too.  DTensor refuses a view
    that would split a sharded dim unevenly (``[B, T, n_kv·D]`` sharded
    16 ways on its last dim into ``[B, T, 8, D]``), where XLA's
    partitioner reshards on its own; here the dims that the view changes
    replicate first (the dims it keeps, before and after them, keep their
    placements), which is what DTensor asks its caller to do.  The
    backward reshapes the gradient back by the same rule (the gradient of
    a merge is a split, of whatever layout the gradient arrives in).  A
    plain tensor is reshaped as is."""
    if not is_dtensor(t):
        return t.reshape(*shape)
    if not (torch.is_grad_enabled() and t.requires_grad):
        return _fit_reshape(t, shape)
    return _Reshape.apply(t, shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, new):
        ctx.old = tuple(t.shape)
        return _fit_reshape(t, new)

    @staticmethod
    def backward(ctx, g):
        return _fit_reshape(g, ctx.old), None


# --------------------------------------------------------------- op rules
#
# Eager DTensor refuses an op it has no sharding strategy for, where XLA's
# partitioner plans every op.  The port's model code reaches two such ops
# and keeps them (their plain-tensor bits are the reference's): the MoE
# dispatch's expert counts, a ``scatter_add_`` of ones, the backward of
# the MoE combine's row gather, an ``index_add``, and the Mamba conv's
# ``F.pad`` (``constant_pad_nd``, whose torch 2.11 rule fails on a sharded
# input).  ``register_rules`` gives DTensor a strategy for each; plain
# tensors never reach them.

_REGISTERED = []


def _scatter_add_rules(self, dim, index, src):
    """Placements (output, then self, dim, index, src) under which a
    scatter-add is exact on every mesh dim: all replicated; every operand
    sharded alike on a dim other than ``dim`` where their sizes agree (each
    rank scatters its own rows); ``index`` and ``src`` sharded on ``dim``
    (each rank adds its share of the updates), the output a partial sum
    whose ``self`` enters as a partial sum too, so it is counted once."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    nd = len(self.shape)
    dim = dim % nd if nd else 0
    rules = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
    if len(index.shape) == nd:
        for d in range(nd):
            if d != dim and self.shape[d] == index.shape[d] \
                    == src.shape[d]:
                rules.append(([Shard(d)], [Shard(d), None, Shard(d),
                                           Shard(d)]))
    if tuple(index.shape) == tuple(src.shape):
        rules.append(([Partial()], [Partial(), None, Shard(dim),
                                    Shard(dim)]))
    return rules


def _index_add_rules(self, dim, index, source, alpha=1):
    """``index_add``'s placements (output, then self, dim, index, source,
    alpha), as a scatter-add's: all replicated; self, source and output
    sharded alike off ``dim`` where their sizes agree; ``index`` and
    ``source`` split along the rows they add (``index``'s dim 0,
    ``source``'s ``dim``), the output a partial sum whose ``self`` enters
    as a partial sum too."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    nd = len(self.shape)
    dim = dim % nd if nd else 0
    rules = [([Replicate()], [Replicate(), None, Replicate(), Replicate(),
                              None])]
    for d in range(nd):
        if d != dim and len(source.shape) == nd \
                and self.shape[d] == source.shape[d]:
            rules.append(([Shard(d)], [Shard(d), None, Replicate(),
                                       Shard(d), None]))
    rules.append(([Partial()], [Partial(), None, Shard(0), Shard(dim),
                                None]))
    return rules


def _constant_pad_rules(self, pad, value=0):
    """``F.pad``'s placements: all replicated, or the input and output
    sharded alike on a dim the pad leaves as it is (``pad`` lists the last
    dims' (before, after) widths, the last dim first)."""
    from torch.distributed.tensor import Replicate, Shard
    nd = len(self.shape)
    padded = {nd - 1 - i // 2 for i, w in enumerate(pad) if w}
    return [([Replicate()], [Replicate(), None, None])] + [
        ([Shard(d)], [Shard(d), None, None]) for d in range(nd)
        if d not in padded]


def _has_rule(op) -> bool:
    """Whether the installed DTensor has a working sharding strategy of
    its own for ``op``: torch 2.13 keeps ``constant_pad_nd``'s among its
    single-dim strategies; torch 2.11 has an older one, which fails in
    DTensor's redistribution planner on a sharded input (an IndexError in
    ``generate_greedy_transform_infos``, seen on the card), and no other."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    return op in getattr(prop, "op_single_dim_strategy_funcs", {})


def register_rules() -> None:
    """Give DTensor the port's strategies (once a process): scatter-add
    and ``index_add``, in place or not, always (the built-in scatter-add,
    where there is one, has no partial-sum case; neither release has an
    ``index_add`` one, and torch 2.11's decomposition of it, the backward
    of the MoE combine's row gather, mismatches the rows of its index and
    source), ``constant_pad_nd`` only where the installed torch has no
    working one (``_has_rule``).  ``launch.mesh.make_mesh`` calls it, so
    every DTensor the port makes sees them."""
    if _REGISTERED:
        return
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    register_sharding([aten.scatter_add.default,
                       aten.scatter_add_.default])(_scatter_add_rules)
    register_sharding([aten.index_add.default,
                       aten.index_add_.default])(_index_add_rules)
    if not _has_rule(aten.constant_pad_nd.default):
        register_sharding(aten.constant_pad_nd.default)(_constant_pad_rules)
        _REGISTERED.append("constant_pad_nd")
    _REGISTERED.append("scatter_add")
