"""Mamba-2 block (SSD): the prefill forward through the SSD-chunk kernel
and the O(1) decode state."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..dist.sharding import is_dtensor, on_shards, reshape
from ..kernels.ssd_scan import ssd, ssd_decode_step
from .common import P, residual, rmsnorm


class MambaDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int      # d_inner // headdim
    headdim: int
    d_state: int
    n_groups: int
    d_conv: int       # short-conv width

    @staticmethod
    def make(d_model, headdim=64, d_state=128, n_groups=1, d_conv=4,
             expand=2):
        d_inner = expand * d_model
        return MambaDims(d_model, d_inner, d_inner // headdim, headdim,
                         d_state, n_groups, d_conv)

    @property
    def conv_channels(self):
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba_schema(dims: MambaDims, dtype=torch.bfloat16):
    d, di = dims.d_model, dims.d_inner
    H, N, G = dims.n_heads, dims.d_state, dims.n_groups
    proj_out = 2 * di + 2 * G * N + H          # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": P((d, proj_out), ("embed", "mlp"), dtype=dtype),
        "conv_w": P((dims.d_conv, dims.conv_channels), (None, "mlp"),
                    init="small_normal", dtype=dtype),
        "conv_b": P((dims.conv_channels,), ("mlp",), init="zeros",
                    dtype=dtype),
        "dt_bias": P((H,), (None,), init="zeros", dtype=f32),
        "A_log": P((H,), (None,), init="alog", dtype=f32),
        "D": P((H,), (None,), init="ones", dtype=f32),
        "norm": P((di,), ("mlp",), init="ones", dtype=f32),
        "out_proj": P((di, d), ("mlp", "embed"), dtype=dtype),
    }


def _split_proj(zxbcdt, dims: MambaDims):
    di, H = dims.d_inner, dims.n_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + dims.conv_channels]
    dt = zxbcdt[..., di + dims.conv_channels:]
    assert dt.shape[-1] == H
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over time; xbc [B, T, C], w [K, C]."""
    K, T = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = pad[:, 0:T, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + T, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def _ssd(x, dt, A, Bm, Cm, D, chunk):
    """``ssd``; a DTensor layer runs on each shard of its batch and heads
    (``dist.sharding.on_shards``: the scan is independent per batch row
    and head, B/C shared by a group's heads), which torch 2.11's DTensor
    cannot flatten when both are sharded."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        G = Bm.shape[2]
        heads = [p.is_shard(2) for p in x.placements]
        n = [m for m, h in zip(x.device_mesh.shape, heads) if h]
        if G == 1 or G % math.prod(n) == 0:
            vec = tuple(Shard(0) if h else Replicate() for h in heads)
            bc = tuple(Replicate() if h and G == 1 else p
                       for p, h in zip(x.placements, heads))
            y = on_shards(lambda *t: ssd(*t, chunk=chunk),
                          (x, dt, A, Bm, Cm, D), x.shape, dims=(0, 2),
                          placed=(x.placements, x.placements, vec, bc, bc,
                                  vec))
            if y is not None:
                return y
    return ssd(x, dt, A, Bm, Cm, D, chunk=chunk)


def mamba_apply(p, x, dims: MambaDims, chunk: int = 128):
    """Prefill forward. x [B, T, d] → [B, T, d]."""
    B, T, _ = x.shape
    di, G, N, H, Pd = (dims.d_inner, dims.n_groups, dims.d_state,
                       dims.n_heads, dims.headdim)
    z, xbc, dt = _split_proj(x @ p["in_proj"], dims)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = reshape(xbc[..., :di], B, T, H, Pd)
    Bm = reshape(xbc[..., di:di + G * N], B, T, G, N)
    Cm = reshape(xbc[..., di + G * N:], B, T, G, N)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = _ssd(xs, dtv, A, Bm, Cm, p["D"], chunk)
    y = reshape(y, B, T, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"])
    return residual(y @ p["out_proj"])


class MambaState(NamedTuple):
    """O(1) decode state: SSD state + short-conv tail."""

    h: torch.Tensor         # [B, H, N, P] f32
    conv: torch.Tensor      # [B, d_conv-1, conv_channels]


def mamba_state_zeros(batch: int, dims: MambaDims, device,
                      dtype=torch.bfloat16) -> MambaState:
    return MambaState(
        h=torch.zeros((batch, dims.n_heads, dims.d_state, dims.headdim),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, dims.d_conv - 1, dims.conv_channels),
                         dtype=dtype, device=device))


def mamba_decode(p, x, state: MambaState, dims: MambaDims):
    """One-token decode. x [B, 1, d] → ([B, 1, d], state); the state is
    written in place."""
    B = x.shape[0]
    di, G, N, H, Pd = (dims.d_inner, dims.n_groups, dims.d_state,
                       dims.n_heads, dims.headdim)
    z, xbc, dt = _split_proj(x @ p["in_proj"], dims)
    window = torch.cat([state.conv, xbc], dim=1)             # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            p["conv_w"].float())
    xbc_t = F.silu(conv_out + p["conv_b"].float()).to(x.dtype)
    xs = reshape(xbc_t[:, :di], B, H, Pd)
    Bm = reshape(xbc_t[:, di:di + G * N], B, G, N)
    Cm = reshape(xbc_t[:, di + G * N:], B, G, N)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h_new, y = ssd_decode_step(state.h, xs, dtv, A, Bm, Cm, p["D"])
    y = reshape(y, B, 1, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"])
    state.h.copy_(h_new)
    state.conv.copy_(window[:, 1:])
    return residual(y @ p["out_proj"]), state
