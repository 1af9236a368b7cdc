"""float32 ``pow`` and ``cos`` as the reference's compiled CPU programs
compute them, bit for bit.

XLA's CPU backend lowers a ``pow`` whose exponent is not a compile-time
constant (``u ** zipf_a`` in the synthetic data pipeline, run op by op;
``b1 ** step`` in AdamW's bias correction) and every ``cos`` to calls of
the C library's ``powf`` and ``cosf``.  On x86-64 glibc (2.28 and later)
those are the ARM optimized-routines algorithms in double precision, in
the variant built with fused multiply-adds, which glibc picks on a CPU
that has them.  ``pow32`` and ``cos32`` evaluate the same algorithms with
the same tables and the same fused sites, in float64 tensor operations on
the caller's device, so a CPU and a CUDA tensor give the same bits.  A
double fused multiply-add is emulated (``fma64``): the exact product by
Dekker's split, then Boldo and Melquiond's rounding to odd.

The tables are glibc's ``__powf_log2_data``, ``__exp2f_data`` and
``__sincosf_table`` (read from the library's data and held against it by
the tests over every input the port gives the functions).
"""
from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from .random import fma32 as _fma32_any

_H = float.fromhex
_SPLIT = 134217729.0                     # 2^27 + 1 (Veltkamp)
FLT_MIN = float(np.finfo(np.float32).tiny)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = a * _SPLIT
    h = c - (c - a)
    return h, a - h


def _two_prod(a, b):
    """``a·b = p + e`` exactly (no fused operation needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_odd(x, y):
    """``x + y`` rounded to odd: to nearest, then, when that was inexact
    and landed on an even significand, one step toward the exact sum."""
    s, err = _two_sum(x, y)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(fix, bits + step, bits).view(torch.float64)


def _f64(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.double()
    return torch.full_like(like, float(v), dtype=torch.float64)


def fma64(a, b, c) -> torch.Tensor:
    """float64 ``a·b + c`` rounded once (Boldo and Melquiond, "Emulation
    of FMA and correctly rounded sums", 2008: RN(th + RO(tl + ul)) with
    ``uh + ul = a·b`` and ``th + tl = c + uh`` exact).  Operands are
    float64 tensors or Python floats; finite results away from overflow
    and underflow."""
    like = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a, b, c = torch.broadcast_tensors(_f64(a, like), _f64(b, like),
                                      _f64(c, like))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_odd(tl, ul)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once: ``random.fma32``'s bits.  On a
    CPU tensor by a cheaper path: the float64 product is exact, so the
    float64 sum rounds the exact result once, and rounding that to float32
    is exact unless it landed on a float32 midpoint (its low 29 bits
    ``1 << 28``); those few elements are redone rounded to odd (one host
    check, free on the CPU).  On the card, and on a tensor without data
    (a fake tensor of the dry run), ``random.fma32`` (no host read)."""
    if a.device.type != "cpu" or is_fake(a):
        return _fma32_any(a, b, c)
    w = lambda v: v.double() if isinstance(v, torch.Tensor) \
        else float(np.float32(v))
    p = a.double() * w(b)
    s = p + w(c)
    mid = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000).nonzero(
        as_tuple=True)
    if mid[0].numel():
        p, cc = torch.broadcast_tensors(p, _f64(w(c), s))
        s = s.clone()
        s[mid] = _add_odd(p[mid], cc[mid])
    return s.float()


# ---------------------------------------------------------------- powf
_POW_INVC = tuple(_H(h) for h in (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010bp+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8eap+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aap-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1"))
_POW_LOGC = tuple(_H(h) for h in (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7afp-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2"))
_POW_A = tuple(_H(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
# __exp2f_data: tab[i] = bits(2^(i/32)) - (i << 52) / 32
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)
_EXP2_SHIFT = _H("0x1.8p+47")            # 0x1.8p52 / 32
_EXP2_C = tuple(_H(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_POW_OFLOW = _H("0x1.fffffffd1d571p+6")

_TABLES: dict = {}


def _table(name: str, values, dtype, device) -> torch.Tensor:
    key = (name, torch.device(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.tensor(values, dtype=dtype, device=device)
        if not is_fake(t):      # a fake mode's tensor dies with the mode
            _TABLES[key] = t
    return t


def pow32(x: torch.Tensor, y) -> torch.Tensor:
    """float32 ``x ** y`` as glibc's ``powf`` (FMA build) computes it,
    results below the smallest normal flushed to zero as the reference's
    CPU programs flush them.  Domain: x ≥ 0 finite and normal or 0,
    y > 0 finite (a float32 tensor broadcasting against x, or a Python
    number rounded to float32)."""
    dev = x.device
    invc = _table("pow_invc", _POW_INVC, torch.float64, dev)
    logc = _table("pow_logc", _POW_LOGC, torch.float64, dev)
    tab = _table("exp2_tab", _EXP2_TAB, torch.int64, dev)
    # log2(x) = log1p(z/c - 1)/ln2 + log2(c) + k, x = 2^k z
    ix = x.view(torch.int32).long() & 0xFFFFFFFF
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    z = ((ix - top) & 0xFFFFFFFF).to(torch.int32).view(torch.float32) \
        .double()
    k = torch.where(top >= 2 ** 31, top - 2 ** 32, top) >> 23
    # gathers: indexing by a 0-d tensor would read the index back
    r = fma64(z, torch.take(invc, i), -1.0)
    y0 = torch.take(logc, i) + k.double()
    A = _POW_A
    r2 = r * r
    p1 = fma64(A[0], r, A[1])
    p2 = fma64(A[2], r, A[3])
    r4 = r2 * r2
    q = fma64(A[4], r, y0)
    q = fma64(p2, r2, q)
    logx = fma64(p1, r4, q)
    yd = y.double() if isinstance(y, torch.Tensor) \
        else float(np.float32(y))
    ylogx = logx * yd
    # exp2(ylogx) = 2^(k/32) · 2^r, r in [-1/64, 1/64]
    kd = ylogx + _EXP2_SHIFT
    ki = kd.view(torch.int64)
    r = ylogx - (kd - _EXP2_SHIFT)
    s = (torch.take(tab, ki & 31) + ((ki & 0x1FFFF) << 47)) \
        .view(torch.float64)
    C = _EXP2_C
    zc = fma64(C[0], r, C[1])
    r2 = r * r
    yv = fma64(C[2], r, 1.0)
    yv = fma64(zc, r2, yv)
    out = (yv * s).float()
    out = torch.where(ylogx > _POW_OFLOW, float("inf"), out)
    out = torch.where((ylogx <= -150.0) | (out < FLT_MIN), 0.0, out)
    return torch.where(x == 0, 0.0, out)


# ---------------------------------------------------------------- cosf
_HPI_INV = _H("0x1.45f306dc9c883p+23")   # 2/pi · 2^24
_HPI = _H("0x1.921fb54442d18p+0")
_COS_C = (1.0, _H("-0x1.ffffffd0c621cp-2"), _H("0x1.55553e1068f19p-5"),
          _H("-0x1.6c087e89a359dp-10"), _H("0x1.99343027bf8c3p-16"))
_SIN_S = (_H("-0x1.555545995a603p-3"), _H("0x1.1107605230bc4p-7"),
          _H("-0x1.994eb3774cf24p-13"))


def cos32(y: torch.Tensor) -> torch.Tensor:
    """float32 ``cos(y)`` as glibc's ``cosf`` (FMA build) computes it,
    for |y| < 120 (the fast reduction; the schedule's angles lie in
    [0, pi])."""
    x = y.double()
    top = (y.view(torch.int32) >> 20) & 0x7FF        # abstop12
    small = top < 0x3F4                             # |y| < 0.75
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    n = torch.where(small, 0, n)
    xr = torch.where(small, x, fma64(-n.double(), _HPI, x))
    x2 = xr * xr
    # cosine polynomial (quadrants 0 and 2; table 1 negates it for n & 2)
    neg = torch.where((n & 2) != 0, -1.0, 1.0).double()
    c = [cf * neg for cf in _COS_C]
    x4 = x2 * x2
    c2 = fma64(x2, c[4], c[3])
    c1 = fma64(x2, c[1], c[0])
    cc = fma64(x4, c[2], c1)
    cval = fma64(x4 * x2, c2, cc)
    # sine polynomial (quadrants 1 and 3) on x · sign[n & 3]
    xs = torch.where((n & 3) == 1, -xr, xr)
    x3 = xs * x2
    s1 = fma64(x2, _SIN_S[2], _SIN_S[1])
    ss = fma64(x3, _SIN_S[0], xs)
    sval = fma64(x3 * x2, s1, ss)
    out = torch.where((n & 1) == 0, cval, sval).float()
    return torch.where(top < 0x395, 1.0, out)      # |y| < 2^-12
