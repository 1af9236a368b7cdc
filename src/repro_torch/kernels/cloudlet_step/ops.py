"""Wrappers of the fused cloudlet tick: the CUDA kernel
``csrc/cloudlet_finish.cu`` on a CUDA tensor, the plain version of
``ref.py`` on a CPU tensor, an error on anything else.
``cloudlet_finish_pool`` is the engine's entry (the stacked pool's
blocks); ``cloudlet_finish`` and ``cloudlet_step`` are the reference's
unpooled APIs over ``[C]`` columns, one launch each on the card.

The wrapper takes the tick's batch axis: a pool of ``[B, C]`` lanes (one
row per point of a sweep), per-point ``time`` and ``dt`` ``[B]`` and
request arrays ``[B, R]``, in one launch for all points; solo inputs
(``rate`` ``[C]``) are a batch of one and come back without the axis.
The plain version runs the solo plain version point by point.

On CUDA the request arrays ``req_finish``/``req_crit``/``req_out`` are
updated in place where they lie in device memory and returned; the plain
version returns new arrays.  Callers use the returned arrays.

A CUDA call is one launch with no host sync: the five per-lane and
instance outputs are allocated, the kernel's scratch (each lane's terms,
the terms in sorted order, the run table, the row masks) is kept per
device and shape and rewritten by every launch, so one stream at a time
may use it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build, launched, reject_dtensor
from . import ref

_ARGTYPES = (
    [ctypes.c_void_p] + [ctypes.c_int] * 5          # ints, ni, 4 columns
    + [ctypes.c_void_p] + [ctypes.c_int] * 4        # flts, nf, 3 columns
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2    # rate, time, dt; C, B
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]        # request arrays, R
    + [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p])

# (device, points, lanes, instances) -> (terms, sorted terms, run table,
# row masks)
_SCRATCH: dict = {}
_MAX_LANES: dict = {}     # device -> lanes one launch takes


def _lib():
    lib = _build.load("cloudlet_finish")
    fn = lib.cloudlet_finish_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.cloudlet_finish_route.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.cloudlet_finish_route.restype = ctypes.c_int
        lib.cloudlet_finish_max_lanes.restype = ctypes.c_longlong
    return lib


ROUTES = ("one block", "cluster", "cooperative grid")


def route(lib, C: int):
    """(how the tiles of a launch over ``C`` lanes on the current device
    meet, an entry of ``ROUTES``; their number)."""
    tiles = ctypes.c_int(0)
    mode = lib.cloudlet_finish_route(C, ctypes.byref(tiles))
    if mode < 0:
        raise RuntimeError("cloudlet_finish_route failed")
    return ROUTES[mode], tiles.value


def _scratch(lib, dev, B: int, C: int, n_inst: int):
    key = (dev, B, C, n_inst)
    buf = _SCRATCH.get(key)
    if buf is None:
        with torch.cuda.device(dev):
            if dev not in _MAX_LANES:
                _MAX_LANES[dev] = int(lib.cloudlet_finish_max_lanes())
            tiles = route(lib, C)[1]
        if C > _MAX_LANES[dev]:
            raise ValueError(f"cloudlet_finish takes at most "
                             f"{_MAX_LANES[dev]} lanes a point on {dev}, "
                             f"got {C}")
        rows, i32, f32 = n_inst + 1, torch.int32, torch.float32
        buf = (torch.empty((B * C, 8), dtype=f32, device=dev),
               torch.empty((B * C, 8), dtype=f32, device=dev),
               torch.empty((B * tiles, rows), dtype=i32, device=dev),
               torch.empty((B * rows, -(-tiles // 32)), dtype=i32,
                           device=dev))
        _SCRATCH[key] = buf
    return buf


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


def cloudlet_finish_pool(cl, rate, time, dt, req_finish, req_crit, req_out,
                         n_inst: int) -> ref.FinishOut:
    """One-pass execution tick over the stacked cloudlet pool ``cl``
    (``core.types.Cloudlets``, blocks ``[B, C, *]``) for every point of
    the batch: ``rate`` ``[B, C]``, ``time`` ``[B]`` float32 and ``dt``
    ``[B]`` float32 on the pool's device, request arrays ``[B, R]``.
    Solo inputs (blocks ``[C, *]``, ``rate`` ``[C]``, ``time`` 0-d, ``dt``
    a number or a 0-d tensor) are a batch of one."""
    if rate.dim() == 1:
        if not isinstance(dt, torch.Tensor):
            dt = torch.full((), float(np.float32(dt)), dtype=torch.float32,
                            device=rate.device)
        out = cloudlet_finish_pool(
            type(cl)(cl.ints[None], cl.flts[None], cl.layout), rate[None],
            time.reshape(1), dt.reshape(1), req_finish[None], req_crit[None],
            req_out[None], n_inst)
        return ref.FinishOut(*[x[0] for x in out])
    L = cl.layout
    ints, flts = cl.ints, cl.flts
    dev = ints.device
    if dev.type == "cpu":
        return ref.cloudlet_finish_batched(
            ints[..., L.i("status")], flts[..., L.f("rem")],
            ints[..., L.i("inst")], ints[..., L.i("req")],
            flts[..., L.f("arrival")], flts[..., L.f("start")],
            ints[..., L.i("depth")], rate, time, dt, req_finish, req_crit,
            req_out, n_inst=n_inst)
    if dev.type != "cuda":
        raise ValueError(f"cloudlet_finish runs on cuda or cpu, not {dev}")
    reject_dtensor("kernels.cloudlet_step.ops.cloudlet_finish_pool", ints,
                   flts, rate, time, dt, req_finish, req_crit, req_out)
    B, C, NI = ints.shape
    NF = flts.shape[2]
    R = req_finish.shape[1]
    _check(ints, "ints", torch.int32, (B, C, NI), dev)
    _check(flts, "flts", torch.float32, (B, C, NF), dev)
    _check(rate, "rate", torch.float32, (B, C), dev)
    _check(time, "time", torch.float32, (B,), dev)
    _check(dt, "dt", torch.float32, (B,), dev)
    _check(req_finish, "req_finish", torch.float32, (B, R), dev)
    _check(req_crit, "req_crit", torch.int32, (B, R), dev)
    _check(req_out, "req_out", torch.int32, (B, R), dev)
    lib = _lib()
    terms, sterms, table, mask = _scratch(lib, dev, B, C, n_inst)
    new_rem = torch.empty((B, C), dtype=torch.float32, device=dev)
    fin = torch.empty((B, C), dtype=torch.bool, device=dev)
    tfin = torch.empty((B, C), dtype=torch.float32, device=dev)
    consumed = torch.empty((B, C), dtype=torch.float32, device=dev)
    inst_acc = torch.empty((B, n_inst + 1, 5), dtype=torch.float32,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cloudlet_finish_launch(
        ints.data_ptr(), NI, L.i("status"), L.i("inst"), L.i("req"),
        L.i("depth"), flts.data_ptr(), NF, L.f("rem"), L.f("arrival"),
        L.f("start"), rate.data_ptr(), time.data_ptr(), dt.data_ptr(), C, B,
        req_finish.data_ptr(), req_crit.data_ptr(), req_out.data_ptr(), R,
        new_rem.data_ptr(), fin.data_ptr(), tfin.data_ptr(),
        consumed.data_ptr(), terms.data_ptr(), sterms.data_ptr(),
        table.data_ptr(), mask.data_ptr(), inst_acc.data_ptr(), n_inst,
        stream)
    if err != 0:
        raise RuntimeError(f"cloudlet_finish launch failed: CUDA error {err}")
    launched("cloudlet_finish")
    return ref.FinishOut(new_rem=new_rem, fin=fin, tfin=tfin,
                         consumed=consumed, inst_acc=inst_acc,
                         req_finish=req_finish, req_crit=req_crit,
                         req_out=req_out)


class _Columns:
    """Where ``_Block``'s stacked columns lie: the names
    ``cloudlet_finish_pool`` reads through ``layout.i`` / ``layout.f``."""

    INTS = ("status", "inst", "req", "depth")
    FLTS = ("rem", "arrival", "start")

    def i(self, name: str) -> int:
        return self.INTS.index(name)

    def f(self, name: str) -> int:
        return self.FLTS.index(name)


class _Block(NamedTuple):
    """The unpooled columns stacked into a pool's two blocks."""

    ints: torch.Tensor     # [C, 4] int32
    flts: torch.Tensor     # [C, 3] float32
    layout: _Columns


def _scalar(v, dev) -> torch.Tensor:
    """A number as a 0-d float32 tensor on ``dev`` (a tensor as it is)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=dev)


def cloudlet_finish(status, rem, inst, req, arrival, start, depth, rate,
                    time, dt, req_finish, req_crit, req_out,
                    n_inst: int) -> ref.FinishOut:
    """One-pass execution tick and every finish reduction over ``[C]``
    columns (the reference's unpooled ``ops.cloudlet_finish``; contract in
    ``ref.py``).  On a CUDA tensor the columns are stacked into a
    temporary ``[C, 4]`` int32 and ``[C, 3]`` float32 block (one copy of
    the seven columns) and the kernel runs once, updating the request
    arrays in place; on a CPU tensor the plain version runs."""
    dev = rem.device
    if dev.type == "cpu":
        return ref.cloudlet_finish(status, rem, inst, req, arrival, start,
                                   depth, rate, _scalar(time, dev), dt,
                                   req_finish, req_crit, req_out,
                                   n_inst=n_inst)
    if dev.type != "cuda":
        raise ValueError(f"cloudlet_finish runs on cuda or cpu, not {dev}")
    cl = _Block(torch.stack([status, inst, req, depth], dim=1),
                torch.stack([rem, arrival, start], dim=1), _Columns())
    return cloudlet_finish_pool(cl, rate, _scalar(time, dev), dt,
                                req_finish, req_crit, req_out, n_inst)


def cloudlet_step(status, rem, inst, rate, time, dt, n_inst: int):
    """The legacy five-output tick over ``[C]`` columns (the reference's
    ``ops.cloudlet_step``, served on the TPU by ``cloudlet_step_pallas``):
    ``(new_rem, fin, tfin, consumed, used [n_inst])``: :func:`cloudlet_finish`
    with inert request lanes (``ref.inert_lanes``), ``inst_acc[:n_inst,
    0]`` kept, as ``cloudlet_step_pallas`` does; one kernel launch on a
    CUDA tensor, the plain version on a CPU tensor."""
    req, arrival, start, depth, *reqs = ref.inert_lanes(rem, inst)
    out = cloudlet_finish(status, rem, inst, req, arrival, start, depth,
                          rate, time, dt, *reqs, n_inst=n_inst)
    return (out.new_rem, out.fin, out.tfin, out.consumed,
            out.inst_acc[:n_inst, ref.ACC_USED])
