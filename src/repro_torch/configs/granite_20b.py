"""granite-20b — dense code model, llama-arch with MQA (kv=1)
[arXiv:2405.04324; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, head_dim=128,
    d_ff=24576, vocab=49152, rope_theta=1e5,
)
