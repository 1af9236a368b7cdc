"""Architecture config schema and the shape grid, as the reference's
``repro.configs.base`` declares them (the port keeps its own copies of
``MambaDims`` and ``MoECfg``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..models.mamba2 import MambaDims
from ..models.moe import MoECfg


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, int, int]] = None
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaDims] = None
    attn_period: int = 0     # hybrid: layers per period (1 attn + rest mamba)
    ssd_chunk: int = 128
    n_enc_layers: int = 0        # enc-dec only
    n_frames: int = 0            # audio/vision stub frontend length
    tie_embeddings: bool = False
    sub_quadratic: bool = False  # True → long_500k cell applies
    # attention formulation:
    #   grouped       : the GQA kernel reads KV head h // group in place
    #   flat          : K/V repeated to Hq heads (the reference's head-
    #                   sharding formulation), the kernel at Hkv = Hq
    #   flat_seqshard : flat plus the reference's query-sequence sharding
    #                   constraint: a DTensor query is laid out as
    #                   ("data", None, "model", None); on one device it
    #                   computes what flat computes
    attn_impl: str = "grouped"
    # decode KV cache precision: "bf16" | "int8" (per-position f32 scales)
    kv_dtype: str = "bf16"

    def reduced(self, **kw) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests, as the
        reference's: a hybrid keeps 4 layers in one period of 4."""
        base = dict(
            name=self.name + "-smoke", family=self.family,
            n_layers=4 if self.attn_period else min(self.n_layers, 2),
            d_model=64,
            n_heads=4, n_kv=max(1, min(self.n_kv, 2)), head_dim=16,
            d_ff=128, vocab=256, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, attn_period=self.attn_period and 4,
            ssd_chunk=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=min(self.n_frames, 8) if self.n_frames else 0,
            tie_embeddings=self.tie_embeddings,
            sub_quadratic=self.sub_quadratic,
        )
        if self.mrope_sections is not None:
            base["mrope_sections"] = (2, 3, 3)   # sums to head_dim/2 = 8
        if self.moe is not None:
            base["moe"] = MoECfg(
                n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_expert=32,
                n_shared=min(self.moe.n_shared, 1),
                d_shared=64 if self.moe.n_shared else 0,
                capacity_factor=self.moe.capacity_factor,
                norm_topk=self.moe.norm_topk)
        if self.mamba is not None:
            base["mamba"] = MambaDims.make(64, headdim=16, d_state=16,
                                           n_groups=1, d_conv=4)
        base.update(kw)
        return ArchConfig(**base)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = (
    ShapeCfg("train_4k", 4_096, 256, "train"),
    ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    ShapeCfg("decode_32k", 32_768, 128, "decode"),
    ShapeCfg("long_500k", 524_288, 1, "decode"),
)


def shape_applies(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether the (arch × shape) cell applies, and why not: ``long_500k``
    only for sub-quadratic architectures, as the reference rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (skip for " \
                      "pure full-attention archs)"
    return True, ""
