"""Plain PyTorch version of max-plus (tropical) semiring linear algebra.

``C[i,j] = max_k X[i,k] + A[k,j]`` — longest-path relaxation over a DAG
adjacency (paper Alg 2: the critical path is the max-delay chain).  Each
term is one float32 add and ``max`` is exact, so any evaluation order
gives the same bits, but for a tie between +0 and -0, whose sign follows
the order and the code path of the max; NaN propagates, as ``torch.amax``
does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = float("-inf")
_CHUNK_ELEMS = 1 << 26   # bound on the broadcast temporary per k-chunk


def tropical_matmul(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(…, M, K) ⊗ (…, K, N) → (…, M, N) in the (max, +) semiring,
    chunked over K so the [M, k, N] broadcast stays bounded."""
    M, K = x.shape[-2:]
    N = a.shape[-1]
    batch = max(math.prod(x.shape[:-2]), 1)
    kc = max(1, min(K, _CHUNK_ELEMS // max(batch * M * N, 1)))
    out = None
    for k0 in range(0, K, kc):
        part = torch.amax(x[..., :, k0:k0 + kc, None]
                          + a[..., None, k0:k0 + kc, :], dim=-2)
        out = part if out is None else torch.maximum(out, part)
    if out is None:
        out = x.new_full(x.shape[:-1] + (N,), NEG_INF)
    return out


def tropical_identity(n: int, dtype=torch.float32, device=None
                      ) -> torch.Tensor:
    """Identity of the (max,+) semiring: 0 on the diagonal, -inf elsewhere."""
    eye = torch.eye(n, dtype=torch.bool, device=device)
    return torch.where(eye, torch.zeros((), dtype=dtype, device=device),
                       torch.full((), NEG_INF, dtype=dtype, device=device))


def squarings(n: int, depth: int | None) -> int:
    """⌈log₂ max(depth, 2)⌉ squarings of a closure (depth defaults to n),
    as the reference's ``ops.tropical_closure`` counts them."""
    depth = n if depth is None else max(int(depth), 1)
    return int(np.ceil(np.log2(max(depth, 2))))


def tropical_closure(a: torch.Tensor, depth: int | None = None
                     ) -> torch.Tensor:
    """All-pairs longest path of a DAG: (I ⊕ A)^(2^⌈log₂ depth⌉), the
    plain squarings over ``tropical_matmul``."""
    n = a.shape[-1]
    m = torch.maximum(a, tropical_identity(n, a.dtype, a.device))
    for _ in range(squarings(n, depth)):
        m = tropical_matmul(m, m)
    return m
