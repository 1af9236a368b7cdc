"""Decoder-only LM of the ``dense``, ``moe``, ``ssm`` and ``vlm`` families
(the reference's ``repro.models.transformer.LM``).

Layer structure: pre-norm mixer (attention or Mamba-2) + for attention
a pre-norm FFN, SwiGLU or (``cfg.moe``) the MoE layer of ``models.moe``.
Parameters are stacked over a leading ``[n_layers, ...]`` axis as in
the reference, and a Python loop over the layers takes the place of its
``lax.scan``: the full-sequence forward unbinds the stacked leaves once
(``unbind_layers``), so a backward through it stacks each leaf's
gradient once instead of building a full-size zero gradient per layer.
``hidden_states(remat=True)`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``);
serving runs no remat.  ``loss_fn`` is the reference's masked-mean cross
entropy over the batch's ``tokens``, or for the ``vlm`` family its
``embeds`` and ``positions`` where the batch brings them (the reference's
``launch/train.py`` gives the vlm family tokens only).  In decode the cache
position is a 0-d int32 tensor on the model's device, as the reference's
``cache.pos``, and ``decode_step`` writes the whole decode state in
place: every step reads and writes the same buffers, so the step can be
captured as a CUDA graph and replayed (``launch/serve.py``), and no
layer reads anything back from the device.  The ``vlm`` family takes
precomputed embeddings (its patch frontend is stubbed, as in the
reference) and M-RoPE positions ``[3, B, T]``; its decode feeds tokens
through the embedding table.  With ``cfg.kv_dtype == "int8"`` the decode
state holds ``QuantKVCache`` leaves.  ``hybrid`` is ``models.hybrid``
and ``encdec`` ``models.encdec``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.types import resolve_device
from .attention import (KVCache, QuantKVCache, attn_apply, attn_decode,
                        attn_schema)
from .common import (P, abstract, apply_mlp, embed, initialize, logical_axes,
                     map_schema, masked_nll, mlp_schema, rmsnorm, unembed)
from .mamba2 import (mamba_apply, mamba_decode, mamba_schema,
                     mamba_state_zeros)
from .moe import moe_apply, moe_schema


def _stack_schema(schema, n: int):
    """Prepend a layer axis to every parameter of a per-layer schema."""
    return map_schema(lambda p: P((n,) + p.shape, ("layers",) + p.axes,
                                  p.init, p.scale, p.dtype), schema)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def unbind_layers(tree, n: int) -> List[Any]:
    """The per-layer trees of a stacked parameter tree, each leaf unbound
    once along its layer axis (views)."""
    def cut(t):
        if isinstance(t, torch.Tensor):
            return t.unbind(0)
        return {k: cut(v) for k, v in t.items()}

    def pick(t, i):
        if isinstance(t, tuple):
            return t[i]
        return {k: pick(v, i) for k, v in t.items()}
    parts = cut(tree)
    return [pick(parts, i) for i in range(n)]


class DecodeState(NamedTuple):
    layers: List[Any]        # per-layer KVCache, QuantKVCache or MambaState
    pos: torch.Tensor        # 0-d int32: tokens already decoded


class LM:
    """Decoder-only language model (family chosen by ArchConfig)."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family not in ("dense", "moe", "ssm", "vlm"):
            raise NotImplementedError(
                f"the {cfg.family} family ({cfg.name}) is not ported to "
                "repro_torch's LM (dense, moe, ssm and vlm; encdec is "
                "models.encdec.EncDec, hybrid models.hybrid.HybridLM)")
        self.cfg = cfg
        self.is_mamba = cfg.family == "ssm"
        self.is_moe = cfg.moe is not None

    # ---------------- schema -------------------------------------------
    def layer_schema(self) -> Dict[str, Any]:
        cfg = self.cfg
        f32 = torch.float32
        s: Dict[str, Any] = {"mixer_norm": P((cfg.d_model,), ("embed",),
                                             init="ones", dtype=f32)}
        if self.is_mamba:
            s["mamba"] = mamba_schema(cfg.mamba)
        else:
            s["attn"] = attn_schema(cfg.d_model, cfg.n_heads, cfg.n_kv,
                                    cfg.head_dim, cfg.qk_norm)
            s["mlp_norm"] = P((cfg.d_model,), ("embed",), init="ones",
                              dtype=f32)
            if self.is_moe:
                s["moe"] = moe_schema(cfg.d_model, cfg.moe)
            else:
                s["mlp"] = mlp_schema(cfg.d_model, cfg.d_ff)
        return s

    def schema(self) -> Dict[str, Any]:
        cfg = self.cfg
        s = {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       init="small_normal"),
            "layers": _stack_schema(self.layer_schema(), cfg.n_layers),
            "final_norm": P((cfg.d_model,), ("embed",), init="ones",
                            dtype=torch.float32),
        }
        if not cfg.tie_embeddings:
            s["head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        return s

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
    def _block(self, lp, x, positions):
        cfg = self.cfg
        h = rmsnorm(x, lp["mixer_norm"])
        if self.is_mamba:
            return x + mamba_apply(lp["mamba"], h, cfg.mamba,
                                   chunk=cfg.ssd_chunk)
        x = x + attn_apply(
            lp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.head_dim, qk_norm=cfg.qk_norm, positions=positions,
            mrope_sections=cfg.mrope_sections, rope_theta=cfg.rope_theta,
            attn_impl=cfg.attn_impl)
        return x + self._ffn(lp, rmsnorm(x, lp["mlp_norm"]))

    def _ffn(self, lp, h):
        if self.is_moe:
            return moe_apply(lp["moe"], h, self.cfg.moe)
        return apply_mlp(lp["mlp"], h)

    def hidden_states(self, params, tokens=None, embeds=None,
                      positions=None, remat=False):
        """Full-sequence forward: tokens [B, T] (or, for the vlm family,
        embeds [B, T, d] cast to the embedding's type) → final-norm hidden
        states [B, T, d].  Positions default to 0..T-1, as ``[3, B, T]``
        under M-RoPE."""
        if embeds is None:
            x = embed(params["embed"], tokens)
        else:
            x = embeds.to(params["embed"].dtype)
        B, T = x.shape[:2]
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=x.device).expand(B, T)
            if self.cfg.mrope_sections is not None:
                positions = positions[None].expand(3, B, T)
        for lp in unbind_layers(params["layers"], self.cfg.n_layers):
            if remat:
                x = checkpoint(self._block, lp, x, positions,
                               use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._block(lp, x, positions)
        return rmsnorm(x, params["final_norm"])

    def logits(self, params, hidden):
        head = params.get("head")
        if head is None:
            return unembed(hidden, params["embed"].T)
        return unembed(hidden, head)

    def loss_fn(self, params, batch, remat=True):
        """Causal-LM cross entropy over float32 logits, the mean over the
        positions whose label is not negative (0-d float32).  The batch
        holds ``tokens`` or ``embeds`` (with ``positions`` where given)."""
        h = self.hidden_states(params, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               positions=batch.get("positions"), remat=remat)
        return masked_nll(self.logits(params, h), batch["labels"])

    # ---------------- decode -------------------------------------------
    def init_decode_state(self, batch: int, seq: int,
                          device="cuda") -> DecodeState:
        cfg = self.cfg
        device = resolve_device(device)
        shape = (batch, cfg.n_kv, seq, cfg.head_dim)
        z = lambda sh, dt: torch.zeros(sh, dtype=dt, device=device)
        layers = []
        for _ in range(cfg.n_layers):
            if self.is_mamba:
                layers.append(mamba_state_zeros(batch, cfg.mamba, device))
            elif cfg.kv_dtype == "int8":
                layers.append(QuantKVCache(
                    k=z(shape, torch.int8), v=z(shape, torch.int8),
                    k_scale=z(shape[:3], torch.float32),
                    v_scale=z(shape[:3], torch.float32)))
            else:
                layers.append(KVCache(k=z(shape, torch.bfloat16),
                                      v=z(shape, torch.bfloat16)))
        return DecodeState(layers=layers, pos=torch.zeros(
            (), dtype=torch.int32, device=device))

    def decode_step(self, params, tokens, state: DecodeState):
        """tokens [B, 1] → (logits [B, 1, V], state).  The state (KV
        caches, Mamba states, ``pos``) is updated in place and returned."""
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        for i, ls in enumerate(state.layers):
            lp = _layer(params["layers"], i)
            hn = rmsnorm(x, lp["mixer_norm"])
            if self.is_mamba:
                x = x + mamba_decode(lp["mamba"], hn, ls, cfg.mamba)[0]
            else:
                x = x + attn_decode(
                    lp["attn"], hn, ls, state.pos, n_heads=cfg.n_heads,
                    n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                    qk_norm=cfg.qk_norm, mrope_sections=cfg.mrope_sections,
                    rope_theta=cfg.rope_theta)[0]
                x = x + self._ffn(lp, rmsnorm(x, lp["mlp_norm"]))
        h = rmsnorm(x, params["final_norm"])
        state.pos.add_(1)
        return self.logits(params, h), state
