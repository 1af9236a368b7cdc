"""internlm2-1.8b — dense GQA [arXiv:2403.17297; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv=8, head_dim=128,
    d_ff=8192, vocab=92544, rope_theta=1e6,
)
