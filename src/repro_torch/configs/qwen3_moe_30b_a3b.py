"""qwen3-moe-30b-a3b — 128 routed experts top-8, qk-norm
[hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.moe import MoECfg
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, head_dim=128,
    d_ff=768, vocab=151936, qk_norm=True, rope_theta=1e6,
    moe=MoECfg(n_experts=128, top_k=8, d_expert=768),
)
