"""Max-min fair NIC water-filling: the CUDA kernel ``csrc/link_share.cu``
on a CUDA tensor, the plain version of ``ref.py`` on a CPU tensor, an
error on anything else.

The reference sends pools over 32,768 lanes to its jnp path and takes
``use_pallas``/``interpret`` knobs that choose the route; here the kernel
takes every size the shared-memory port tables hold, and nothing routes a
CUDA run around it.  A call is one launch with no host sync: one block up
to 16,384 transfers, a cooperative grid above, whose occupancy table (kept
per device and host count, rewritten by every launch) lies in device
memory, so one stream at a time may use it.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, launched
from . import ref

# One block holds the port tables in shared memory (227 KB a block on
# Hopper, less a margin for the kernel's static shared memory), and the
# occupancy counts must stay exact in float32.
_SMEM_BYTES = 232_448 - 1024
_MAX_LANES = 1 << 24
_BLOCK_LANES = 16 * 1024  # one block takes this many, a grid more
_OCCUPANCY: dict = {}     # (device, hosts) -> [2, H] int32 scratch
_GRID_LANES: dict = {}    # (device, hosts) -> transfers one launch takes


def _lib():
    lib = _build.load("link_share")
    fn = lib.link_share_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        lib.link_share_table_bytes.argtypes = [ctypes.c_int] * 2
        lib.link_share_table_bytes.restype = ctypes.c_int
        lib.link_share_max_lanes.argtypes = [ctypes.c_int]
        lib.link_share_max_lanes.restype = ctypes.c_longlong
    return lib


def _occupancy(lib, dev, H: int, C: int) -> torch.Tensor:
    key = (dev, H)
    if C > _BLOCK_LANES:
        if key not in _GRID_LANES:
            with torch.cuda.device(dev):
                _GRID_LANES[key] = int(lib.link_share_max_lanes(H))
        if C > _GRID_LANES[key]:
            raise ValueError(f"link_share takes at most {_GRID_LANES[key]}"
                             f" transfers at {H} hosts on {dev}, got {C}")
    occ = _OCCUPANCY.get(key)
    if occ is None:
        occ = _OCCUPANCY[key] = torch.empty((2, H), dtype=torch.int32,
                                            device=dev)
    return occ


def _check(t: torch.Tensor, name: str, dtype, n: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def link_share(src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor,
               cap_e: torch.Tensor, cap_i: torch.Tensor,
               iters: int = 4) -> torch.Tensor:
    """Max-min fair per-transfer rates (MB/s) over host NIC ports:
    ``src``/``dst`` [C] int32 hosts (src -1: no egress port), ``active``
    [C] bool, ``cap_e``/``cap_i`` [H] float32 capacities (MB/s)."""
    dev = src.device
    if dev.type == "cpu":
        return ref.link_share(src, dst, active, cap_e, cap_i, iters)
    if dev.type != "cuda":
        raise ValueError(f"link_share runs on cuda or cpu, not {dev}")
    C, H = src.shape[0], cap_e.shape[0]
    _check(src, "src", torch.int32, C, dev)
    _check(dst, "dst", torch.int32, C, dev)
    _check(active, "active", torch.bool, C, dev)
    _check(cap_e, "cap_e", torch.float32, H, dev)
    _check(cap_i, "cap_i", torch.float32, H, dev)
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
    occ = _occupancy(lib, dev, H, C)
    rate = torch.empty((C,), dtype=torch.float32, device=dev)
    err = lib.link_share_launch(
        src.data_ptr(), dst.data_ptr(), active.data_ptr(), cap_e.data_ptr(),
        cap_i.data_ptr(), C, H, int(iters), rate.data_ptr(), occ.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"link_share launch failed: CUDA error {err}")
    launched("link_share")
    return rate
