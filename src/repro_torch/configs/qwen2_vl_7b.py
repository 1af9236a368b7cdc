"""qwen2-vl-7b — VLM backbone with M-RoPE; patch frontend stubbed (the
prefill program takes merged embeddings) [arXiv:2409.12191; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, head_dim=128,
    d_ff=18944, vocab=152064, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)
