"""Tropical (max-plus) products: the CUDA kernel ``csrc/tropical.cu`` on a
CUDA tensor, the plain version of ``ref.py`` on a CPU tensor, an error on
anything else.  ``tropical_closure`` squares around either, as the
reference's ``ops.tropical_closure`` does.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _build, counts
from . import ref


def _lib():
    fn = _build.load("tropical").tropical_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tropical_matmul(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(…, M, K) ⊗ (…, K, N) → (…, M, N), float32."""
    if x.device != a.device:
        raise ValueError(f"operands on {x.device} and {a.device}")
    if x.device.type == "cpu":
        return ref.tropical_matmul(x, a)
    if x.device.type != "cuda":
        raise ValueError(f"tropical_matmul runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("tropical_matmul takes float32 operands")
    batch = x.shape[:-2]
    M, K = x.shape[-2:]
    K2, N = a.shape[-2:]
    if a.shape[:-2] != batch or K2 != K:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(a.shape)} "
                         "do not chain")
    B = max(math.prod(batch), 1)
    xb = x.reshape(B, M, K)
    ab = a.reshape(B, K, N)
    if not (xb.is_contiguous() and ab.is_contiguous()):
        raise ValueError("tropical_matmul needs contiguous operands")
    out = torch.empty((B, M, N), dtype=torch.float32, device=x.device)
    err = _lib()(xb.data_ptr(), ab.data_ptr(), out.data_ptr(), B, M, K, N,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tropical_matmul launch failed: CUDA error {err}")
    counts["tropical_matmul"] += 1
    return out.reshape(batch + (M, N))


def tropical_closure(a: torch.Tensor, depth: int | None = None
                     ) -> torch.Tensor:
    """All-pairs longest path of a DAG: (I ⊕ A)^(2^⌈log₂ depth⌉)."""
    n = a.shape[-1]
    depth = n if depth is None else max(int(depth), 1)
    m = torch.maximum(a, ref.tropical_identity(n, a.dtype, a.device))
    for _ in range(int(np.ceil(np.log2(max(depth, 2))))):
        m = tropical_matmul(m.contiguous(), m.contiguous())
    return m
