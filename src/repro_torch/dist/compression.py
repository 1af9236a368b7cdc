"""Int8 gradient compression with error feedback (the reference's
``repro.dist.compression``), bit for bit with its jitted CPU program.

Symmetric per-tensor quantisation: scale = absmax / 127, which XLA
computes as ``absmax · float32(1/127)`` (its rewrite of a division by a
constant) in float32 for a float32 or bfloat16 input alike (the
bfloat16 rounding of the quotient is dropped under XLA's default
excess precision); ``round`` is half to even.  Error feedback carries
each step's quantisation residual into the next.
"""
from __future__ import annotations

import numpy as np
import torch

from ..numerics import fma32
from ..tree import tree_map, tree_unzip

_RCP127 = float(np.float32(1.0) / np.float32(127.0))
_TINY = float(np.finfo(np.float32).tiny)


def _quantize(x: torch.Tensor, absmax: torch.Tensor):
    """(q, the scale) of float32 ``x``: q the int8 code as float32 (its
    round trip through int8 turns -0 into 0)."""
    safe = torch.clamp_min(absmax * _RCP127, _TINY)
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q.float(), safe


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantize → dequantize, in x's type."""
    xf = x.float()
    q, safe = _quantize(xf, torch.amax(torch.abs(xf)))
    return (q * safe).to(x.dtype)


def ef_init(grads):
    """Zero error-feedback residual, one per gradient leaf."""
    return tree_map(torch.zeros_like, grads)


def _ef_one(g: torch.Tensor, e: torch.Tensor):
    """(compressed g + e, residual) as the reference's jitted
    ``ef_compress`` computes them: in float32 the residual
    ``s - q·safe`` is one fused multiply-add; in bfloat16 the sum
    ``s = g + e`` stays float32 where it is divided by the scale (excess
    precision) and is rounded to bfloat16 for the absmax and the
    residual."""
    s = g.float() + e.float()
    if g.dtype == torch.float32:
        q, safe = _quantize(s, torch.amax(torch.abs(s)))
        return q * safe, fma32(q, -safe, s)
    if g.dtype != torch.bfloat16:
        raise TypeError(f"ef_compress takes float32 or bfloat16, not "
                        f"{g.dtype}")
    sb = s.to(g.dtype).float()
    q, safe = _quantize(s, torch.amax(torch.abs(sb)))
    c = (q * safe).to(g.dtype)
    return c, (sb - c.float()).to(g.dtype)


def ef_compress(grads, ef):
    """Compress ``grads + ef``; the new residual is what the codec lost."""
    return tree_unzip(tree_map(_ef_one, grads, ef), 2)
