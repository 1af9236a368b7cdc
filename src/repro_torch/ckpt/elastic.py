"""Elastic rescale: re-lay a checkpointed state onto a different mesh.

After a node failure (or a capacity change) the job restarts on a new
mesh (fewer or more pods).  Checkpoints are host-side full tensors, and
the layouts are derived from the logical-axis rules against whatever
mesh is current, so resharding is one ``distribute_tensor`` per leaf: the
divisibility guards of ``dist.sharding`` re-resolve every rule for the
new axis sizes (batch 256: 32-way on 2 pods, 16-way on 1 pod).
"""
from __future__ import annotations

import torch

from ..dist import sharding as shd
from ..tree import tree_map


def reshard_tree(host_tree, mesh, logical_tree, rules=shd.PARAM_RULES):
    """Place a host-side tree onto ``mesh`` per the logical-axis rules:
    each leaf becomes a DTensor on the mesh's device type at the
    placements ``placements(resolve(...))`` gives it."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, axes):
        spec = shd.resolve(mesh, t.shape, axes, rules)
        return distribute_tensor(t, mesh, shd.placements(mesh, spec))
    return tree_map(place, host_tree, logical_tree)


def to_host(tree):
    """Every leaf gathered whole (``full_tensor()`` of a DTensor) on the
    host."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().to("cpu", copy=True) \
            if isinstance(t, torch.Tensor) else t
    return tree_map(one, tree)


def simulate_failure_and_rescale(state_tree, old_mesh, new_mesh,
                                 logical_tree):
    """Round trip: gather from the (failing) old mesh, re-place on the
    new one.  In production the gather comes from the last checkpoint
    instead of the live mesh; the placement path is the same."""
    del old_mesh         # the leaves carry their mesh
    return reshard_tree(to_host(state_tree), new_mesh, logical_tree)
