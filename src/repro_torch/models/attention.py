"""GQA attention block: qk-norm, RoPE, the flash kernel, the KV cache.

The port runs the reference's ``attn_impl="grouped"`` formulation (the
kernel reads KV head h // group in place) with the bfloat16 KV cache.
The int8 cache, the ``flat``/``flat_seqshard`` formulations, cross-
attention (``kv=``) and M-RoPE are not ported and raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.flash_attention import attention as flash_attention
from .common import P, apply_rope, rmsnorm


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


def _unported(mrope_sections=None, kv=None, attn_impl="grouped"):
    if mrope_sections is not None:
        raise NotImplementedError("M-RoPE is not ported to repro_torch yet")
    if kv is not None:
        raise NotImplementedError("cross-attention (kv=) is not ported to "
                                  "repro_torch yet")
    if attn_impl != "grouped":
        raise NotImplementedError(f"attn_impl={attn_impl!r} is not ported "
                                  "to repro_torch yet (grouped only)")


def _project(p, x, n_heads, n_kv, head_dim, qk_norm, positions,
             rope_theta=1e6):
    B, T, _ = x.shape
    q = (x @ p["wq"]).reshape(B, T, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, T, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(B, T, n_kv, head_dim)
    if qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if positions is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_apply(p, x, *, n_heads, n_kv, head_dim, qk_norm=False,
               positions=None, mrope_sections=None, rope_theta=1e6,
               causal=True, kv=None, attn_impl: str = "grouped"):
    """Full-sequence attention (prefill), x [B, T, d] → [B, T, d]."""
    _unported(mrope_sections, kv, attn_impl)
    B, T, _ = x.shape
    q, k, v = _project(p, x, n_heads, n_kv, head_dim, qk_norm, positions,
                       rope_theta)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = flash_attention(qt, kt, vt, causal=causal)
    out = out.transpose(1, 2).reshape(B, T, n_heads * head_dim)
    return out @ p["wo"]


def attn_decode(p, x, cache: KVCache, pos: torch.Tensor, *, n_heads, n_kv,
                head_dim, qk_norm=False, mrope_sections=None,
                rope_theta=1e6):
    """One-token decode against a fixed-capacity KV cache of S slots, of
    which ``pos`` (a 0-d int32 tensor on the cache's device, the
    reference's ``cache.pos``) hold tokens.  x [B, 1, d].  The cache is
    written in place at slot ``pos``.  Returns (out [B, 1, d], cache).
    """
    _unported(mrope_sections)
    B, T, _ = x.shape
    assert T == 1
    S = cache.k.shape[2]
    positions = pos.view(1, 1).expand(B, 1)
    q, k, v = _project(p, x, n_heads, n_kv, head_dim, qk_norm, positions,
                       rope_theta)
    slot = pos.view(1).long()
    cache.k.index_copy_(2, slot, k.transpose(1, 2).to(cache.k.dtype))
    cache.v.index_copy_(2, slot, v.transpose(1, 2).to(cache.v.dtype))
    k_read = cache.k.float()
    v_read = cache.v.float()
    g = n_heads // n_kv
    qg = q.transpose(1, 2).reshape(B, n_kv, g, 1, head_dim).float()
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k_read) \
        * head_dim ** -0.5
    valid = torch.arange(S, device=x.device) <= pos
    logits = torch.where(valid, logits, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v_read)
    out = out.reshape(B, n_heads, 1, head_dim).transpose(1, 2) \
        .reshape(B, 1, n_heads * head_dim).to(x.dtype)
    return out @ p["wo"], cache
