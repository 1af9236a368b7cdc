"""whisper-base — encoder-decoder audio backbone; conv frontend stubbed
(the prefill program takes precomputed frame embeddings)
[arXiv:2212.04356; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, head_dim=64,
    d_ff=2048, vocab=51865, n_enc_layers=6, n_frames=1500,
    tie_embeddings=True, rope_theta=1e4,
)
