"""Whisper-style encoder-decoder backbone, conv frontend stubbed (the
reference's ``repro.models.encdec``).

The encoder takes precomputed frame embeddings, adds sinusoidal
positions and runs non-causal self-attention blocks (no RoPE).  The
decoder is a causal LM (RoPE at ``rope_theta``) with cross-attention
into the encoder output, both through the flash kernel, forward and
backward (the cross-attention non-causal, Tq ≠ Tk).  Parameters are
stacked over layers in the reference's layout, so
``models.convert.params_from_numpy`` carries its tree unchanged.
``encode`` and ``decode_train`` unbind the stacked leaves once, as
``transformer.LM`` does, and with ``remat=True`` recompute each block in
the backward (the reference's ``jax.checkpoint`` of each encoder and
decoder block); ``loss_fn`` is the reference's masked-mean cross entropy
over the tied unembedding, on a batch of ``tokens``, ``labels`` and
``frames`` (``data.batch_for``).

Decode runs one token against a stacked self-attention ``KVCache`` and
the stacked cross K/V ``[n_layers, B, n_kv, n_frames, Dh]`` of
``init_decode_state`` (the reference's serving never fills them from an
encoder pass; neither does the port's).  ``decode_step`` writes every
leaf of the state in place, so the step can be captured as a CUDA graph.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.types import resolve_device
from ..dist.sharding import reshape
from .attention import KVCache, attn_apply, attn_decode, attn_schema
from .common import (P, abstract, apply_mlp, embed, initialize, logical_axes,
                     masked_nll, mlp_schema, rmsnorm, sinusoid_positions,
                     unembed)
from .transformer import _layer, _stack_schema, unbind_layers


class EncDecState(NamedTuple):
    self_kv: KVCache              # k, v [n_layers, B, n_kv, S, Dh] bf16
    cross_kv: Dict[str, Any]      # "k", "v" [n_layers, B, n_kv, F, Dh]
    pos: torch.Tensor             # 0-d int32: tokens already decoded


class EncDec:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # ---------------- schema -------------------------------------------
    def _enc_layer(self):
        cfg = self.cfg
        d = cfg.d_model
        f32 = torch.float32
        return {
            "norm1": P((d,), ("embed",), init="ones", dtype=f32),
            "attn": attn_schema(d, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                cfg.qk_norm),
            "norm2": P((d,), ("embed",), init="ones", dtype=f32),
            "mlp": mlp_schema(d, cfg.d_ff),
        }

    def _dec_layer(self):
        cfg = self.cfg
        d = cfg.d_model
        f32 = torch.float32
        return {
            "norm1": P((d,), ("embed",), init="ones", dtype=f32),
            "self_attn": attn_schema(d, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                     cfg.qk_norm),
            "norm2": P((d,), ("embed",), init="ones", dtype=f32),
            "cross_attn": attn_schema(d, cfg.n_heads, cfg.n_kv,
                                      cfg.head_dim, cfg.qk_norm),
            "norm3": P((d,), ("embed",), init="ones", dtype=f32),
            "mlp": mlp_schema(d, cfg.d_ff),
        }

    def schema(self):
        cfg = self.cfg
        f32 = torch.float32
        return {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       init="small_normal"),
            "enc_layers": _stack_schema(self._enc_layer(), cfg.n_enc_layers),
            "enc_norm": P((cfg.d_model,), ("embed",), init="ones",
                          dtype=f32),
            "dec_layers": _stack_schema(self._dec_layer(), cfg.n_layers),
            "dec_norm": P((cfg.d_model,), ("embed",), init="ones",
                          dtype=f32),
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

    def _attn(self, p, x, **kw):
        cfg = self.cfg
        return attn_apply(p, x, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                          head_dim=cfg.head_dim, **kw)

    # ---------------- encoder ------------------------------------------
    def _enc_block(self, lp, x):
        x = x + self._attn(lp["attn"], rmsnorm(x, lp["norm1"]), causal=False)
        return x + apply_mlp(lp["mlp"], rmsnorm(x, lp["norm2"]))

    def encode(self, params, frames, remat=False):
        """frames [B, F, d] → encoder output [B, F, d] (non-causal)."""
        cfg = self.cfg
        T = frames.shape[1]
        pos = torch.from_numpy(sinusoid_positions(T, cfg.d_model))
        x = frames.to(torch.bfloat16) + \
            pos.to(device=frames.device, dtype=torch.bfloat16)[None]
        for lp in unbind_layers(params["enc_layers"], cfg.n_enc_layers):
            x = _run(self._enc_block, remat, lp, x)
        return rmsnorm(x, params["enc_norm"])

    # ---------------- decoder ------------------------------------------
    def _dec_block(self, lp, x, positions, enc_out):
        x = x + self._attn(lp["self_attn"], rmsnorm(x, lp["norm1"]),
                           positions=positions, rope_theta=self.cfg.rope_theta)
        x = x + self._attn(lp["cross_attn"], rmsnorm(x, lp["norm2"]),
                           kv=enc_out)
        return x + apply_mlp(lp["mlp"], rmsnorm(x, lp["norm3"]))

    def decode_train(self, params, tokens, enc_out, remat=False):
        """tokens [B, T] and the encoder output → final-norm decoder hidden
        states [B, T, d]."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        B, T = tokens.shape
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(B, T)
        for lp in unbind_layers(params["dec_layers"], cfg.n_layers):
            x = _run(self._dec_block, remat, lp, x, positions, enc_out)
        return rmsnorm(x, params["dec_norm"])

    def logits(self, params, hidden):
        return unembed(hidden, params["embed"].T)

    def loss_fn(self, params, batch, remat=True):
        """Cross entropy of the decoder's float32 logits over the tied
        embedding, the mean over the positions whose label is not
        negative (0-d float32); the batch holds ``frames``, ``tokens`` and
        ``labels``."""
        enc_out = self.encode(params, batch["frames"], remat=remat)
        h = self.decode_train(params, batch["tokens"], enc_out, remat=remat)
        return masked_nll(self.logits(params, h), batch["labels"])

    # ---------------- serving ------------------------------------------
    def init_decode_state(self, batch: int, seq: int,
                          device="cuda") -> EncDecState:
        cfg = self.cfg
        device = resolve_device(device)
        z = lambda t: torch.zeros((cfg.n_layers, batch, cfg.n_kv, t,
                                   cfg.head_dim), dtype=torch.bfloat16,
                                  device=device)
        return EncDecState(
            self_kv=KVCache(k=z(seq), v=z(seq)),
            cross_kv={"k": z(cfg.n_frames), "v": z(cfg.n_frames)},
            pos=torch.zeros((), dtype=torch.int32, device=device))

    def decode_step(self, params, tokens, state: EncDecState):
        """tokens [B, 1] → (logits [B, 1, V], state); the self-attention
        cache and ``pos`` are updated in place."""
        cfg = self.cfg
        H, Hkv, Dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
        x = embed(params["embed"], tokens)
        B = x.shape[0]
        g = H // Hkv
        for i in range(cfg.n_layers):
            lp = _layer(params["dec_layers"], i)
            cache = KVCache(k=state.self_kv.k[i], v=state.self_kv.v[i])
            x = x + attn_decode(lp["self_attn"], rmsnorm(x, lp["norm1"]),
                                cache, state.pos, n_heads=H, n_kv=Hkv,
                                head_dim=Dh, rope_theta=cfg.rope_theta)[0]
            # cross attention against the stored encoder K/V, in float32
            hq = rmsnorm(x, lp["norm2"])
            q = reshape(hq @ lp["cross_attn"]["wq"], B, 1, H, Dh) \
                .transpose(1, 2)
            qg = reshape(q, B, Hkv, g, 1, Dh).float()
            logits = torch.einsum("bkgqd,bksd->bkgqs", qg,
                                  state.cross_kv["k"][i].float()) \
                * Dh ** -0.5
            w = torch.softmax(logits, dim=-1)
            c = torch.einsum("bkgqs,bksd->bkgqd", w,
                             state.cross_kv["v"][i].float())
            c = reshape(reshape(c, B, H, 1, Dh).transpose(1, 2),
                        B, 1, H * Dh)
            x = x + c.to(x.dtype) @ lp["cross_attn"]["wo"]
            x = x + apply_mlp(lp["mlp"], rmsnorm(x, lp["norm3"]))
        h = rmsnorm(x, params["dec_norm"])
        state.pos.add_(1)
        return self.logits(params, h), state


def _run(block, remat: bool, *args):
    """``block(*args)``, recomputed in the backward under ``remat``."""
    if remat:
        return checkpoint(block, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return block(*args)
