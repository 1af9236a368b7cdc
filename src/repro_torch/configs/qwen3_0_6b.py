"""qwen3-0.6b — dense, GQA + per-head qk-norm
[hf:Qwen/Qwen3-8B family; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv=8, head_dim=128,
    d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
)
