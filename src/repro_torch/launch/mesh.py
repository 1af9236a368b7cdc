"""Production meshes over ``torch.distributed.device_mesh``, and the fake
world the dry run plans on.

Functions, not module-level constants: importing this module starts no
process group and touches no device.

  single pod : (16, 16)    axes ("data", "model")          256 devices
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   512 devices

A mesh needs a process group of as many ranks as it has devices.  On
the card that is a real group (NCCL) started by the caller; the dry run
starts a fake one with ``fake_world(n)``: ``n`` ranks in one process,
whose collectives move nothing, the counterpart of the reference's 512
placeholder host devices.
"""
from __future__ import annotations

import contextlib


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """Any mesh over the ranks of the current process group (the elastic
    checks build smaller ones).  DTensor gets the port's op rules first
    (``dist.sharding.register_rules``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..dist.sharding import register_rules
    register_rules()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_world(n: int):
    """A ``"fake"`` process group of ``n`` ranks (this process is rank 0)
    for the body of the ``with``; destroyed on exit, so no group outlives
    the call that made it.  Raises if a group is already running."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), world_size=n,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()
