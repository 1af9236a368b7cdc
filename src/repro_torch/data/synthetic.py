"""Deterministic, step-indexed synthetic data pipeline (the reference's
``repro.data.synthetic.SyntheticLM``).

A batch is a pure function of (seed, step), so a restored run regenerates
batch k exactly.  Tokens mix Zipf-distributed unigrams (inverse CDF on
u^a) with a 45 % copy rule (x[t] = x[t-1]); labels are the next token,
-1 at the last position.  The bits are the reference's: the keys and the
uniform draws are ``jax.random``'s threefry (``repro_torch.random``) in
its partitionable derivation, JAX's default since 0.5, ``u ** a`` is the
C library's ``powf`` as the reference's op-by-op ``pow`` calls it
(``numerics.pow32``: ``torch.pow`` cubes by two multiplies and misses it
by an ulp on a quarter of the draws, which moves about 800 tokens a
million at V = 151,936).  The batch is generated on ``device``.

``batch_for`` is the reference's batch of a config at a shape: the
tokens and labels, for the vlm family bfloat16 ``embeds`` and M-RoPE
``positions`` in place of the tokens, for the encdec family bfloat16
``frames`` beside them; the bfloat16 draws are ``random.normal_bf16``,
bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import random
from ..core.types import resolve_device
from ..numerics import pow32


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 3.0
    copy_p: float = 0.45

    def batch(self, step: int, device="cuda") -> dict:
        """Global batch for ``step``: ``tokens`` and ``labels``, int32
        ``[global_batch, seq_len]`` on ``device``."""
        device = resolve_device(device)
        key = random.fold_in(random.PRNGKey(self.seed), step)
        k1, k2 = random.split(key, 2, partitionable=True)
        B, T, V = self.global_batch, self.seq_len, self.vocab
        u = random.uniform(k1, (B, T), device=device, partitionable=True)
        ranks = torch.floor(float(np.float32(V - 1))
                            * pow32(u, self.zipf_a)).to(torch.int32)
        mask = random.uniform(k2, (B, T), device=device,
                              partitionable=True) \
            < float(np.float32(self.copy_p))
        tokens = torch.where(mask, torch.roll(ranks, 1, dims=1), ranks)
        labels = torch.roll(tokens, -1, dims=1)
        labels[:, -1] = -1
        return {"tokens": tokens, "labels": labels}


def batch_for(cfg, shape, step: int = 0, seed: int = 0,
              device="cuda") -> dict:
    """The reference's batch for ``cfg`` at ``shape`` (its ``seq_len`` and
    ``global_batch``) and ``step``, on ``device``: ``SyntheticLM``'s
    tokens and labels; for the vlm family ``embeds`` ``[B, T, d]``
    (bfloat16 normals under ``fold_in(PRNGKey(seed + 1), step)``), int32
    ``positions`` ``[3, B, T]`` (0..T-1 in every row) and the labels; for
    the encdec family also ``frames`` ``[B, n_frames, d]`` (bfloat16
    normals under ``fold_in(PRNGKey(seed + 2), step)``)."""
    device = resolve_device(device)
    B, T = shape.global_batch, shape.seq_len
    ds = SyntheticLM(vocab=max(cfg.vocab, 2), seq_len=T, global_batch=B,
                     seed=seed)
    batch = ds.batch(step, device=device)
    if cfg.family == "vlm":
        key = random.fold_in(random.PRNGKey(seed + 1), step)
        batch = {
            "embeds": random.normal_bf16(key, (B, T, cfg.d_model), device),
            "positions": torch.arange(T, dtype=torch.int32, device=device)
            .expand(3, B, T),
            "labels": batch["labels"],
        }
    elif cfg.family == "encdec":
        key = random.fold_in(random.PRNGKey(seed + 2), step)
        batch["frames"] = random.normal_bf16(
            key, (B, cfg.n_frames, cfg.d_model), device)
    return batch
