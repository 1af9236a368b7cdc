"""phi3-medium-14b — dense, RoPE + SwiGLU + GQA 40H/10KV
[arXiv:2404.14219; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv=10, head_dim=128,
    d_ff=17920, vocab=100352, rope_theta=1e4,
)
