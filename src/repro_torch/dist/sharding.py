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
