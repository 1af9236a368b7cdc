"""mamba2-130m — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from ..models.mamba2 import MambaDims
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv=0, head_dim=0,
    d_ff=0, vocab=50280,
    mamba=MambaDims.make(768, headdim=64, d_state=128, n_groups=1,
                         d_conv=4, expand=2),
    ssd_chunk=128, tie_embeddings=True, sub_quadratic=True,
)
