"""Tropical (max-plus) products and closures: the CUDA kernels of
``csrc/tropical.cu`` on a CUDA tensor, the plain versions of ``ref.py`` on
a CPU tensor, an error on anything else.

``tropical_closure`` on the card takes one of two routes, by the rule
``closure_route`` states: S up to ``CLOSURE_MAX_S`` goes to the closure
kernel (the identity and every squaring in one launch), larger S to the
identity in PyTorch and ⌈log₂ depth⌉ launches of the product kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, launched, reject_dtensor
from . import ref
from .ref import squarings

CLOSURE_MAX_S = 128      # two S x S float32 buffers in shared memory
CLOSURE, PRODUCTS = "closure", "products"
_PREPARED: set = set()


def closure_route(n: int) -> str:
    """The kernel route of an [n, n] closure on the card."""
    return CLOSURE if n <= CLOSURE_MAX_S else PRODUCTS


def _lib(device: torch.device):
    lib = _build.load("tropical")
    if lib.tropical_matmul_launch.argtypes is None:
        lib.tropical_matmul_launch.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.tropical_closure_launch.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        for fn in (lib.tropical_matmul_launch, lib.tropical_closure_launch,
                   lib.tropical_prepare, lib.tropical_closure_max_s):
            fn.restype = ctypes.c_int
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _PREPARED:
        # the kernels' shared-memory limits, set before any launch (never
        # under a stream capture)
        with torch.cuda.device(index):
            err = lib.tropical_prepare()
        if err != 0:
            raise RuntimeError(f"tropical kernels: CUDA error {err}")
        _PREPARED.add(index)
    return lib


def _on_card(name: str, *ts: torch.Tensor) -> bool:
    """True for CUDA operands, False for CPU ones; raises on the rest."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"operands on {[str(t.device) for t in ts]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    reject_dtensor(f"kernels.tropical.ops.{name}", *ts)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"{name} takes float32 operands")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous operands")
    return True


def tropical_matmul(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(…, M, K) ⊗ (…, K, N) → (…, M, N), float32."""
    if not _on_card("tropical_matmul", x, a):
        return ref.tropical_matmul(x, a)
    batch = x.shape[:-2]
    M, K = x.shape[-2:]
    K2, N = a.shape[-2:]
    if a.shape[:-2] != batch or K2 != K:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(a.shape)} "
                         "do not chain")
    out = torch.empty(batch + (M, N), dtype=torch.float32, device=x.device)
    B = math.prod(batch)
    if out.numel() == 0:
        return out
    err = _lib(x.device).tropical_matmul_launch(
        x.data_ptr(), a.data_ptr(), out.data_ptr(), B, M, K, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tropical_matmul launch failed: CUDA error {err}")
    launched("tropical_matmul")
    return out


def tropical_closure(a: torch.Tensor, depth: int | None = None
                     ) -> torch.Tensor:
    """All-pairs longest path of a DAG: (I ⊕ A)^(2^⌈log₂ depth⌉)."""
    if not _on_card("tropical_closure", a):
        return ref.tropical_closure(a, depth)
    n = a.shape[-1]
    if a.dim() < 2 or a.shape[-2] != n:
        raise ValueError(f"tropical_closure takes [..., n, n], not "
                         f"{tuple(a.shape)}")
    n_sq = squarings(n, depth)
    if closure_route(n) == PRODUCTS:
        m = torch.maximum(a, ref.tropical_identity(n, a.dtype, a.device))
        for _ in range(n_sq):
            m = tropical_matmul(m, m)
        return m
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    err = _lib(a.device).tropical_closure_launch(
        a.data_ptr(), out.data_ptr(), math.prod(a.shape[:-2]), n, n_sq,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tropical_closure launch failed: CUDA error "
                           f"{err}")
    launched("tropical_closure")
    return out
