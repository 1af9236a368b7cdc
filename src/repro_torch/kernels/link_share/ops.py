"""Max-min fair NIC water-filling: the CUDA kernel ``csrc/link_share.cu``
on a CUDA tensor, the plain version of ``ref.py`` on a CPU tensor, an
error on anything else.

The wrapper takes the tick's batch axis: ``[B, C]`` transfers over
per-point port capacities ``[B, H]``, every point's water-fill in one
launch; solo inputs (``src`` ``[C]``) are a batch of one and come back
without the axis.  The plain version runs the solo one point by point.

The reference sends pools over 32,768 lanes to its jnp path and takes
``use_pallas``/``interpret`` knobs that choose the route; here the kernel
takes every size the shared-memory port tables hold, and nothing routes a
CUDA run around it.  A call is one launch with no host sync: one block up
to 16,384 transfers a point (one block a point), a cooperative grid above,
whose occupancy table (kept per device, batch and host count, rewritten
by every launch) lies in device memory, so one stream at a time may use
it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, launched, reject_dtensor
from . import ref

# One block holds the port tables in shared memory (227 KB a block on
# Hopper, less a margin for the kernel's static shared memory), and the
# occupancy counts must stay exact in float32.
_SMEM_BYTES = 232_448 - 1024
_MAX_LANES = 1 << 24
_BLOCK_LANES = 16 * 1024  # one block takes this many, a grid more
_OCCUPANCY: dict = {}     # (device, points, hosts) -> [B, 2, H] int32
_GRID_LANES: dict = {}    # (device, hosts) -> transfers one launch takes


def _lib():
    lib = _build.load("link_share")
    fn = lib.link_share_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        lib.link_share_table_bytes.argtypes = [ctypes.c_int] * 2
        lib.link_share_table_bytes.restype = ctypes.c_int
        lib.link_share_max_lanes.argtypes = [ctypes.c_int]
        lib.link_share_max_lanes.restype = ctypes.c_longlong
    return lib


def _occupancy(lib, dev, B: int, H: int, C: int) -> torch.Tensor:
    if C > _BLOCK_LANES:
        key = (dev, H)
        if key not in _GRID_LANES:
            with torch.cuda.device(dev):
                _GRID_LANES[key] = int(lib.link_share_max_lanes(H))
        if C > _GRID_LANES[key]:
            raise ValueError(f"link_share takes at most {_GRID_LANES[key]}"
                             f" transfers a point at {H} hosts on {dev}, "
                             f"got {C}")
    occ = _OCCUPANCY.get((dev, B, H))
    if occ is None:
        occ = _OCCUPANCY[(dev, B, H)] = torch.empty(
            (B, 2, H), dtype=torch.int32, device=dev)
    return occ


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def link_share(src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor,
               cap_e: torch.Tensor, cap_i: torch.Tensor,
               iters: int = 4) -> torch.Tensor:
    """Max-min fair per-transfer rates (MB/s) over host NIC ports, for
    each point of the batch: ``src``/``dst`` [B, C] int32 hosts (src -1:
    no egress port), ``active`` [B, C] bool, ``cap_e``/``cap_i`` [B, H]
    float32 capacities (MB/s).  Solo inputs ([C], [H]) are a batch of
    one."""
    if src.dim() == 1:
        return link_share(src[None], dst[None], active[None], cap_e[None],
                          cap_i[None], iters)[0]
    dev = src.device
    if dev.type == "cpu":
        return ref.link_share_batched(src, dst, active, cap_e, cap_i, iters)
    if dev.type != "cuda":
        raise ValueError(f"link_share runs on cuda or cpu, not {dev}")
    reject_dtensor("kernels.link_share.ops.link_share", src, dst, active,
                   cap_e, cap_i)
    (B, C), H = src.shape, cap_e.shape[1]
    _check(src, "src", torch.int32, (B, C), dev)
    _check(dst, "dst", torch.int32, (B, C), dev)
    _check(active, "active", torch.bool, (B, C), dev)
    _check(cap_e, "cap_e", torch.float32, (B, H), dev)
    _check(cap_i, "cap_i", torch.float32, (B, H), dev)
    if C >= _MAX_LANES:
        raise ValueError(f"link_share takes fewer than {_MAX_LANES} "
                         f"transfers, got {C}")
    lib = _lib()
    if H < 1 or lib.link_share_table_bytes(H, C) > _SMEM_BYTES:
        raise ValueError(f"link_share holds 1 to "
                         f"{_SMEM_BYTES // lib.link_share_table_bytes(1, C)}"
                         f" hosts in shared memory, got {H}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    occ = _occupancy(lib, dev, B, H, C)
    rate = torch.empty((B, C), dtype=torch.float32, device=dev)
    err = lib.link_share_launch(
        src.data_ptr(), dst.data_ptr(), active.data_ptr(), cap_e.data_ptr(),
        cap_i.data_ptr(), C, H, B, int(iters), rate.data_ptr(),
        occ.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"link_share launch failed: CUDA error {err}")
    launched("link_share")
    return rate
