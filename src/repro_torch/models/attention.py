"""GQA attention block: qk-norm, RoPE or M-RoPE, the flash kernel, the KV
cache (bfloat16, or int8 with per-position scales), as the reference's
``repro.models.attention``.

Full-sequence attention (prefill) runs the flash kernel, self-attention
or cross-attention (``kv=``: K/V from a source sequence, Tq ≠ Tk).  The
``attn_impl`` formulations: ``grouped`` (the kernel reads KV head
h // group in place), ``flat`` (K/V repeated to Hq heads, the kernel at
Hkv = Hq) and ``flat_seqshard`` (``flat`` with the reference's
query-sequence constraint: a DTensor query is redistributed to the spec
("data", None, "model", None) on its own mesh, a mesh axis the spec does
not name replicating; a plain tensor is left as it is, as
``with_sharding_constraint`` leaves an array on one device).  Decode
reads the cache through float32 einsums and writes it in place at slot
``pos``.  A DTensor's attention output and projection are laid out by
their logical axes (``dist.sharding.constrain``, ``common.residual``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..dist.sharding import constrain, is_dtensor, placements, reshape
from ..kernels.flash_attention import attention as flash_attention
from .common import P, apply_mrope, apply_rope, residual, rmsnorm


def attn_schema(d: int, n_heads: int, n_kv: int, head_dim: int,
                qk_norm: bool, dtype=torch.bfloat16):
    s = {
        "wq": P((d, n_heads * head_dim), ("embed", "heads"), dtype=dtype),
        "wk": P((d, n_kv * head_dim), ("embed", "kv_heads"), dtype=dtype),
        "wv": P((d, n_kv * head_dim), ("embed", "kv_heads"), dtype=dtype),
        "wo": P((n_heads * head_dim, d), ("heads", "embed"), dtype=dtype),
    }
    if qk_norm:
        s["q_norm"] = P((head_dim,), (None,), init="ones",
                        dtype=torch.float32)
        s["k_norm"] = P((head_dim,), (None,), init="ones",
                        dtype=torch.float32)
    return s


class KVCache(NamedTuple):
    k: torch.Tensor      # [B, Hkv, S, Dh] bf16
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """int8 KV cache: decode is cache-read-bound, and one byte an element
    plus a float32 scale a position halves the bytes read.  Per-position
    symmetric scales keep the quantization error local."""

    k: torch.Tensor        # [B, Hkv, S, Dh] int8
    v: torch.Tensor
    k_scale: torch.Tensor  # [B, Hkv, S] f32
    v_scale: torch.Tensor


# XLA's compiled reference divides by 127 as a multiply by float32(1/127)
# (its simplifier's rewrite of a division by a constant): the same
# multiply gives the reference's scales bit for bit
_RCP127 = float(np.float32(1.0 / 127.0))


def _quant(x: torch.Tensor):
    """[..., Dh] bf16/f32 → (int8, f32 scale over the last dim).  The
    values' division by the floored scale is one IEEE division (a tensor
    by a tensor) on every device."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) * _RCP127
    q = torch.round(xf / scale.clamp_min(1e-9)[..., None])
    return q.to(torch.int8), scale


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion: a bfloat16 input against
    float32 weights (the reference's encoder input in a float32 model)
    runs in float32."""
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t)


def _project(p, x, n_heads, n_kv, head_dim, qk_norm, positions,
             mrope_sections=None, rope_theta=1e6, kv=None):
    """Q from x, K and V from ``kv`` (cross-attention: no RoPE on them)
    or from x."""
    B, T, _ = x.shape
    src = x if kv is None else kv
    Tk = src.shape[1]
    q = reshape(_mm(x, p["wq"]), B, T, n_heads, head_dim)
    k = reshape(_mm(src, p["wk"]), B, Tk, n_kv, head_dim)
    v = reshape(_mm(src, p["wv"]), B, Tk, n_kv, head_dim)
    if qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if positions is not None:
        if mrope_sections is not None:
            rope = lambda t: apply_mrope(t, positions, mrope_sections,
                                         rope_theta)
        else:
            rope = lambda t: apply_rope(t, positions, rope_theta)
        q = rope(q)
        if kv is None:
            k = rope(k)
    return q, k, v


# context parallelism: the query sequence over the model axis, the batch
# over data (the reference writes this spec out literally)
SEQSHARD_SPEC = ("data", None, "model", None)


def _seqshard(qt: torch.Tensor) -> torch.Tensor:
    """``qt`` [B, H, T, D] laid out as ``SEQSHARD_SPEC`` when it is a
    DTensor; a plain tensor unchanged."""
    if not is_dtensor(qt):
        return qt
    mesh = qt.device_mesh
    return qt.redistribute(mesh, placements(mesh, SEQSHARD_SPEC))


def attn_apply(p, x, *, n_heads, n_kv, head_dim, qk_norm=False,
               positions=None, mrope_sections=None, rope_theta=1e6,
               causal=True, kv: Optional[torch.Tensor] = None,
               attn_impl: str = "grouped"):
    """Full-sequence attention (prefill), x [B, T, d] → [B, T, d].

    ``kv``: an external K/V source sequence [B, Tkv, d] (cross-attention),
    projected with this block's ``wk``/``wv``; no RoPE on it, and the
    attention is not causal.  ``attn_impl``: ``ArchConfig.attn_impl``."""
    B, T, _ = x.shape
    q, k, v = _project(p, x, n_heads, n_kv, head_dim, qk_norm, positions,
                       mrope_sections, rope_theta, kv)
    if kv is not None:
        causal = False
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    if attn_impl in ("flat", "flat_seqshard") and n_kv < n_heads:
        # jnp.repeat(..., g, axis=1): each KV head g times in a row
        g = n_heads // n_kv
        kt = kt.repeat_interleave(g, dim=1)
        vt = vt.repeat_interleave(g, dim=1)
    if attn_impl == "flat_seqshard":
        qt = _seqshard(qt)
    out = flash_attention(qt, kt, vt, causal=causal)
    # a DTensor output back to its logical layout: the attention may
    # leave its rows sharded, which the flattening of [B, T] in the
    # output projection cannot take
    out = constrain(out, ("batch", "heads", "seq", None))
    out = reshape(out.transpose(1, 2), B, T, n_heads * head_dim)
    return residual(out @ p["wo"])


def _write_slot(buf: torch.Tensor, pos: torch.Tensor, val: torch.Tensor):
    """``buf[:, :, pos] = val`` in place (dim 2 is the cache's time axis).
    A DTensor cache is written as a select over the whole axis: DTensor
    has no rule that writes one slot of a sharded axis in place (its
    ``index_copy_`` there leaves the placements and the local shard
    disagreeing), and XLA partitions a dynamic-update-slice on a sharded
    dim the same way."""
    if not is_dtensor(buf):
        buf.index_copy_(2, pos.view(1).long(), val)
        return
    S = buf.shape[2]
    hit = (torch.arange(S, device=buf.device) == pos) \
        .view((1, 1, S) + (1,) * (buf.dim() - 3))
    buf.copy_(torch.where(hit, val, buf))


def attn_decode(p, x, cache, pos: torch.Tensor, *, n_heads, n_kv,
                head_dim, qk_norm=False, mrope_sections=None,
                rope_theta=1e6):
    """One-token decode against a fixed-capacity cache of S slots
    (``KVCache`` or ``QuantKVCache``), of which ``pos`` (a 0-d int32
    tensor on the cache's device, the reference's ``cache.pos``) hold
    tokens.  x [B, 1, d].  The cache is written in place at slot ``pos``
    (the int8 cache: values and scales).  Returns (out [B, 1, d], cache).
    """
    B, T, _ = x.shape
    assert T == 1
    S = cache.k.shape[2]
    positions = pos.view(1, 1).expand(B, 1)
    if mrope_sections is not None:
        positions = positions[None].expand(3, B, 1)
    q, k, v = _project(p, x, n_heads, n_kv, head_dim, qk_norm, positions,
                       mrope_sections, rope_theta)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)       # [B, Hkv, 1, Dh]
    if isinstance(cache, QuantKVCache):
        kq, ks = _quant(kt)
        vq, vs = _quant(vt)
        for buf, val in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                         (cache.v_scale, vs)):
            _write_slot(buf, pos, val)
        k_read = cache.k.float() * cache.k_scale[..., None]
        v_read = cache.v.float() * cache.v_scale[..., None]
    else:
        _write_slot(cache.k, pos, kt.to(cache.k.dtype))
        _write_slot(cache.v, pos, vt.to(cache.v.dtype))
        k_read = cache.k.float()
        v_read = cache.v.float()
    g = n_heads // n_kv
    qg = reshape(q.transpose(1, 2), B, n_kv, g, 1, head_dim).float()
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k_read) \
        * head_dim ** -0.5
    valid = torch.arange(S, device=x.device) <= pos
    logits = torch.where(valid, logits, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v_read)
    out = reshape(reshape(out, B, n_heads, 1, head_dim).transpose(1, 2),
                  B, 1, n_heads * head_dim).to(x.dtype)
    return residual(out @ p["wo"]), cache
