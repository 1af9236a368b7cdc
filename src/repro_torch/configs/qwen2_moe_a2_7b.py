"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from ..models.moe import MoECfg
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=1408, vocab=151936, rope_theta=1e6,
    moe=MoECfg(n_experts=60, top_k=4, d_expert=1408,
               n_shared=4, d_shared=5632, norm_topk=False),
)
