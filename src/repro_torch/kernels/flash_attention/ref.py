"""Plain PyTorch causal GQA attention: the CPU path of ``ops.attention``
and the yardstick the CUDA kernel (``csrc/flash_attention.cu``) is held
against on the card.

Shapes: q [B, Hq, Tq, D], k and v [B, Hkv, Tk, D] with Hq % Hkv == 0;
query head h reads KV head h // (Hq // Hkv).  Causal masking aligns the
ends of the sequences: query i sees keys j <= i + (Tk - Tq).  All
arithmetic is float32 whatever the input type; the output has q's type.

A row with no visible key (causal, i + Tk - Tq < 0; only when Tq > Tk)
is defined as the reference's Pallas kernel computes it through its
``ops.attention`` (key blocks of ``MASKED_ROW_BLOCK``): that kernel masks
with the float32 minimum rather than -inf, so every key of such a row,
the zero padding of the last key block included, gets weight exp(0) = 1,
and the row is ΣV over the Tk keys divided by Tk rounded up to a whole
number of blocks.
"""
from __future__ import annotations

import torch

from ...dist.sharding import is_dtensor, on_shards, reshape

MASKED_ROW_BLOCK = 128


def masked_row_denominator(tk: int) -> int:
    return -(-tk // MASKED_ROW_BLOCK) * MASKED_ROW_BLOCK


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None
              ) -> torch.Tensor:
    if is_dtensor(q):
        # batch and heads sharded alike: each shard's heads on its own
        out = on_shards(lambda *t: attention(*t, causal=causal, scale=scale),
                        (q, k, v), q.shape)
        if out is not None:
            return out
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = reshape(q.float(), B, Hkv, g, Tq, D)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    if not causal:
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bhkd->bhgqd", w, vf)
        return reshape(out, B, Hq, Tq, D).to(q.dtype)
    qi = torch.arange(Tq, device=q.device)[:, None]
    kj = torch.arange(Tk, device=q.device)[None, :]
    mask = kj <= qi + (Tk - Tq)                              # [Tq, Tk]
    logits = torch.where(mask, logits, float("-inf"))
    live = mask.any(dim=-1)                                  # [Tq]
    m = torch.amax(logits, dim=-1, keepdim=True)
    m = torch.where(live[:, None], m, 0.0)
    w = torch.exp(logits - m)
    den = torch.where(live[:, None], w.sum(dim=-1, keepdim=True), 1.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w / den, vf)
    if Tq > Tk and not bool(live.all()):     # Tq <= Tk: every row lives
        dead = vf.sum(dim=2)[:, :, None, None, :] \
            / float(masked_row_denominator(Tk))
        out = torch.where(live[:, None], out, dead)
    return reshape(out, B, Hq, Tq, D).to(q.dtype)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dout: torch.Tensor, causal: bool = True,
                  scale: float | None = None):
    """dq, dk, dv of ``attention`` by autograd through it (the VJP the
    reference's ``_flash_bwd`` recomputes): the yardstick of the backward
    kernel (``csrc/flash_attention_bwd.cu``)."""
    with torch.enable_grad():
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = attention(qs, ks, vs, causal=causal, scale=scale)
        return torch.autograd.grad(out, (qs, ks, vs), dout)


def logsumexp(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
              scale: float | None = None) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled logits over the visible keys
    (float32 ``[B, Hq, Tq]``): the yardstick of the forward kernels'
    ``lse`` output.  Rows must see a key."""
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    g = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = q.float().reshape(B, Hkv, g, Tq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if causal:
        qi = torch.arange(Tq, device=q.device)[:, None]
        kj = torch.arange(Tk, device=q.device)[None, :]
        logits = torch.where(kj <= qi + (Tk - Tq), logits, float("-inf"))
    return torch.logsumexp(logits, dim=-1).reshape(B, Hq, Tq)
