"""Jamba-style hybrid (the reference's ``repro.models.hybrid.HybridLM``):
periods of one attention layer and ``attn_period - 1`` Mamba-2 layers,
each mixer followed by a pre-norm FFN, MoE on the odd in-period layers
and SwiGLU on the even ones (arXiv:2403.19887).

The parameters are the reference's schema: a period's leaves stacked
over a leading ``[n_periods, ...]`` axis, and inside a period the Mamba
layers, their norms, the FFN norms, the dense FFNs and the MoE layers
stacked once more.  A Python loop over the periods and their layers
takes the place of the reference's ``lax.scan`` and unrolled period;
``hidden_states(remat=True)`` recomputes each period in the backward, as
the reference's ``jax.checkpoint`` of its period.  The attention layer
runs the flash kernel and the Mamba layers the SSD kernel, forward and
backward (jamba-1.5-large's head width 128 on the tensor-core
``ssd_chunk_sm90`` and ``ssd_bwd_ds``/``_dx``/``_db``, the carry over
chunks in PyTorch).  ``loss_fn`` is the reference's masked-mean cross
entropy over the untied head.

The decode state is a ``DecodeState`` whose ``layers`` hold one dict a
period, ``{"kv": KVCache, "mamba": [MambaState, ...]}``, and ``pos`` a
0-d int32 tensor on the device, the reference's ``cache.pos``.
``decode_step`` writes all of it in place and reads nothing back to the
host, so ``launch/serve.py`` can capture it as a CUDA graph.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.types import resolve_device
from .attention import KVCache, attn_apply, attn_decode, attn_schema
from .common import (P, abstract, apply_mlp, embed, initialize, logical_axes,
                     masked_nll, mlp_schema, rmsnorm, unembed)
from .mamba2 import (mamba_apply, mamba_decode, mamba_schema,
                     mamba_state_zeros)
from .moe import moe_apply, moe_schema
from .transformer import DecodeState, _layer, _stack_schema, unbind_layers


class HybridLM:
    """1:(K-1) attention:mamba interleave, MoE on odd in-period layers."""

    def __init__(self, cfg: ArchConfig):
        if cfg.attn_period < 2 or cfg.n_layers % cfg.attn_period:
            raise ValueError(
                f"{cfg.name}: the hybrid needs attn_period >= 2 dividing "
                f"n_layers, got {cfg.attn_period} and {cfg.n_layers}")
        self.cfg = cfg
        self.period = cfg.attn_period
        self.n_periods = cfg.n_layers // cfg.attn_period
        self.n_mamba = self.period - 1
        # FFN pattern inside a period: MoE on odd local indices
        self.n_moe = self.period // 2
        self.n_dense = self.period - self.n_moe

    # ---------------- schema -------------------------------------------
    def period_schema(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        norm = lambda: P((d,), ("embed",), init="ones", dtype=torch.float32)
        return {
            "attn_norm": norm(),
            "attn": attn_schema(d, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                cfg.qk_norm),
            "mamba_norm": _stack_schema({"n": norm()}, self.n_mamba)["n"],
            "mamba": _stack_schema(mamba_schema(cfg.mamba), self.n_mamba),
            "ffn_norm": _stack_schema({"n": norm()}, self.period)["n"],
            "dense": _stack_schema(mlp_schema(d, cfg.d_ff), self.n_dense),
            "moe": _stack_schema(moe_schema(d, cfg.moe), self.n_moe),
        }

    def schema(self) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       init="small_normal"),
            "periods": _stack_schema(self.period_schema(), self.n_periods),
            "final_norm": P((cfg.d_model,), ("embed",), init="ones",
                            dtype=torch.float32),
            "head": P((cfg.d_model, cfg.vocab), ("embed", "vocab")),
        }

    def abstract_params(self, device="meta"):
        """Meta tensors of every parameter's shape and type."""
        return abstract(self.schema(), device)

    def param_logical_axes(self):
        return logical_axes(self.schema())

    def init_params(self, generator: torch.Generator, device="cuda"):
        """Random parameters from ``generator``, on ``device`` (the card
        unless the caller asks for the CPU)."""
        return initialize(self.schema(), generator, resolve_device(device))

    # ---------------- forward ------------------------------------------
    def _ffn(self, pp, x, local_i: int):
        h = rmsnorm(x, pp["ffn_norm"][local_i])
        if local_i % 2 == 1:
            return x + moe_apply(_layer(pp["moe"], local_i // 2), h,
                                 self.cfg.moe)
        return x + apply_mlp(_layer(pp["dense"], local_i // 2), h)

    def _period(self, pp, x, positions):
        cfg = self.cfg
        # local layer 0: the attention mixer
        h = rmsnorm(x, pp["attn_norm"])
        x = x + attn_apply(pp["attn"], h, n_heads=cfg.n_heads,
                           n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                           qk_norm=cfg.qk_norm, positions=positions,
                           rope_theta=cfg.rope_theta)
        x = self._ffn(pp, x, 0)
        # local layers 1..K-1: the Mamba mixers
        for j in range(self.n_mamba):
            h = rmsnorm(x, pp["mamba_norm"][j])
            x = x + mamba_apply(_layer(pp["mamba"], j), h, cfg.mamba,
                                chunk=cfg.ssd_chunk)
            x = self._ffn(pp, x, j + 1)
        return x

    def hidden_states(self, params, tokens=None, embeds=None,
                      positions=None, remat=False):
        """Full-sequence forward: tokens [B, T] (or embeds [B, T, d]) →
        final-norm hidden states [B, T, d]; positions default to
        0..T-1."""
        x = embed(params["embed"], tokens) if embeds is None else embeds
        B, T = x.shape[:2]
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=x.device).expand(B, T)
        for pp in unbind_layers(params["periods"], self.n_periods):
            if remat:
                x = checkpoint(self._period, pp, x, positions,
                               use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._period(pp, x, positions)
        return rmsnorm(x, params["final_norm"])

    def logits(self, params, hidden):
        return unembed(hidden, params["head"])

    def loss_fn(self, params, batch, remat=True):
        """Causal-LM cross entropy over float32 logits, the mean over the
        positions whose label is not negative (0-d float32)."""
        h = self.hidden_states(params, tokens=batch["tokens"], remat=remat)
        return masked_nll(self.logits(params, h), batch["labels"])

    # ---------------- decode -------------------------------------------
    def init_decode_state(self, batch: int, seq: int,
                          device="cuda") -> DecodeState:
        cfg = self.cfg
        device = resolve_device(device)
        shape = (batch, cfg.n_kv, seq, cfg.head_dim)
        layers = []
        for _ in range(self.n_periods):
            kv = KVCache(
                k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                v=torch.zeros(shape, dtype=torch.bfloat16, device=device))
            layers.append({"kv": kv, "mamba": [
                mamba_state_zeros(batch, cfg.mamba, device)
                for _ in range(self.n_mamba)]})
        return DecodeState(layers=layers, pos=torch.zeros(
            (), dtype=torch.int32, device=device))

    def decode_step(self, params, tokens, state: DecodeState):
        """tokens [B, 1] → (logits [B, 1, V], state).  The state (KV
        caches, Mamba states, ``pos``) is updated in place and returned."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        for p, ls in enumerate(state.layers):
            pp = _layer(params["periods"], p)
            hn = rmsnorm(x, pp["attn_norm"])
            x = x + attn_decode(
                pp["attn"], hn, ls["kv"], state.pos, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv, head_dim=cfg.head_dim, qk_norm=cfg.qk_norm,
                rope_theta=cfg.rope_theta)[0]
            x = self._ffn(pp, x, 0)
            for j, ms in enumerate(ls["mamba"]):
                hn = rmsnorm(x, pp["mamba_norm"][j])
                x = x + mamba_decode(_layer(pp["mamba"], j), hn, ms,
                                     cfg.mamba)[0]
                x = self._ffn(pp, x, j + 1)
        h = rmsnorm(x, params["final_norm"])
        state.pos.add_(1)
        return self.logits(params, h), state
