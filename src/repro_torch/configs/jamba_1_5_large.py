"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with
MoE 16e top-2 on alternating layers [arXiv:2403.19887; hf]."""
from ..models.mamba2 import MambaDims
from ..models.moe import MoECfg
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, head_dim=128,
    d_ff=24576, vocab=65536,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=24576),
    mamba=MambaDims.make(8192, headdim=128, d_state=128, n_groups=1,
                         d_conv=4, expand=2),
    attn_period=8, ssd_chunk=128, sub_quadratic=True,
)
