"""The port's training numerics against the JAX package on the CPU, bit
for bit: ``numerics.pow32`` and ``numerics.cos32`` against XLA's ``pow``
and ``cos`` (the C library's ``powf`` and ``cosf``), ``numerics.fma64``
and ``numerics.fma32`` against exact fused multiply-adds, and
``data.SyntheticLM`` against the reference's pipeline (JAX's default,
partitionable threefry).  No tolerance anywhere here: every comparison
is of bits.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.launch.train import PRESETS as JPRESETS
from repro.train.optimizer import AdamWCfg as JAdamWCfg
from repro.train.optimizer import lr_schedule as jlr_schedule

from repro_torch import numerics
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.random import fma32 as random_fma32

torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def test_pow32_is_xlas_pow_on_the_pipelines_draws():
    """Every u = m·2^-23 that ``uniform`` can draw, in a stride that keeps
    the test short, plus all of the 2^15 smallest (where exact ties of
    the cube lie), cubed by the reference's op-by-op ``pow``."""
    m = np.concatenate([np.arange(0, 2 ** 23, 7),
                        np.arange(2 ** 15)]).astype(np.float32)
    u = m * np.float32(2.0 ** -23)
    want = np.asarray(jnp.asarray(u) ** 3.0)
    got = numerics.pow32(torch.from_numpy(u), 3.0)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # torch.pow cubes by two multiplies: a quarter of the draws differ
    assert (_bits(torch.pow(torch.from_numpy(u), 3.0)) != _bits(want)).sum() \
        > len(u) // 8


@pytest.mark.parametrize("base", [0.9, 0.95, 0.999, 0.5])
def test_pow32_is_xlas_pow_for_the_bias_correction(base):
    """``b ** step`` for steps 0..20,000, the underflow to 0 included."""
    steps = np.arange(0, 20001, dtype=np.float32)
    want = np.asarray(jnp.float32(base) ** jnp.asarray(steps))
    got = numerics.pow32(torch.full((len(steps),), base), torch.from_numpy(
        steps))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_cos32_is_xlas_cos():
    """Random float32 angles in [0, pi] (the schedule's), both sides of the
    small-angle switch at 0.75 and of 2^-12, and negative angles."""
    r = np.random.default_rng(0)
    hi = np.float32(np.pi).view(np.int32)
    bits = np.concatenate([
        r.integers(0, hi + 1, 200_000), np.arange(0x3F3FF000, 0x3F401000),
        np.arange(0x39000000 - 2000, 0x39000000 + 2000),
        np.arange(hi - 3000, hi + 1)]).astype(np.int32)
    y = bits.view(np.float32)
    y = np.concatenate([y, -y[:5000]])
    want = np.asarray(jax.jit(jnp.cos)(y))
    np.testing.assert_array_equal(_bits(numerics.cos32(torch.from_numpy(y))),
                                  _bits(want))


def test_cos32_through_the_schedule_is_the_reference_lr():
    """The reference's jitted ``lr_schedule`` at every step of a cosine
    decay over 10,000 steps calls ``cosf`` on its angles: its bits."""
    from repro_torch.train.optimizer import AdamWCfg, lr_schedule
    cfg = JAdamWCfg()
    f = jax.jit(lambda s: jlr_schedule(s, cfg))
    steps = np.arange(0, 10_101, 3, dtype=np.int32)
    want = np.stack([np.asarray(f(jnp.int32(s))) for s in steps[::50]])
    got = torch.stack([lr_schedule(torch.tensor(int(s), dtype=torch.int32),
                                   AdamWCfg()) for s in steps[::50]])
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _exact_fma(a, b, c) -> float:
    """float64 a·b + c rounded once, through exact rationals (Python's
    int / int is correctly rounded)."""
    x = Fraction(a) * Fraction(b) + Fraction(c)
    return x.numerator / x.denominator


def test_fma64_is_exact_rounding():
    r = np.random.default_rng(1)
    n = 3000
    a = r.standard_normal(n) * 2.0 ** r.integers(-30, 30, n)
    b = r.standard_normal(n) * 2.0 ** r.integers(-30, 30, n)
    # c cancelling a·b to varied depths, and unrelated c
    c = -(a * b) * (1 + r.standard_normal(n) * 2.0 ** r.integers(-60, 0, n))
    c[::3] = r.standard_normal(n)[::3] * 2.0 ** r.integers(-80, 80, n)[::3]
    got = numerics.fma64(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def test_fma32_cpu_path_is_random_fma32():
    """The cheaper CPU path gives ``random.fma32``'s bits, on random
    operands and where rounding twice errs: a = 2^-12(1 + 2^-23),
    b = 2^-12(1 - 2^-23), c = 1 + 2^-23 make a·b + c = 1 + 3·2^-24 -
    2^-70, whose float64 rounding is the float32 midpoint 1 + 3·2^-24
    (rounded to even: up), while the exact sum rounds down to c."""
    r = np.random.default_rng(2)
    n = 100_000
    a = r.standard_normal(n).astype(np.float32)
    b = r.standard_normal(n).astype(np.float32)
    c = r.standard_normal(n).astype(np.float32)
    k = 1000
    a[:k] = 2.0 ** -12 * (1 + 2.0 ** -23)
    b[:k] = 2.0 ** -12 * (1 - 2.0 ** -23)
    c[:k] = 1 + 2.0 ** -23
    a[k:2 * k], b[k:2 * k], c[k:2 * k] = -a[:k], b[:k], -c[:k]
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    got = numerics.fma32(ta, tb, tc)
    np.testing.assert_array_equal(_bits(got), _bits(random_fma32(ta, tb, tc)))
    np.testing.assert_array_equal(got[:2 * k].numpy(), c[:2 * k])
    for bb, cc in ((0.1, tc), (tb, 0.25)):
        np.testing.assert_array_equal(
            _bits(numerics.fma32(ta, bb, cc)), _bits(random_fma32(ta, bb, cc)))


# SyntheticLM: (vocab, seq, batch, seed, step)
DATA_CASES = [(1000, 64, 4, 3, 17), (2048, 128, 8, 0, 0),
              (JPRESETS["tiny"].vocab, 32, 2, 5, 99), (151936, 4096, 2, 1, 3)]


@pytest.mark.parametrize("V,T,B,seed,step", DATA_CASES)
def test_synthetic_batch_is_the_references_bits(V, T, B, seed, step):
    want = JSyntheticLM(V, T, B, seed).batch(step)
    got = SyntheticLM(V, T, B, seed).batch(step, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_synthetic_batch_of_a_million_positions_at_qwen3_vocab():
    """256 x 4096 positions at V = 151,936 (``train_4k``'s global batch):
    every token and label equal; the cube through ``torch.pow`` would move
    hundreds of them."""
    V, T, B = 151936, 4096, 256
    want = JSyntheticLM(V, T, B).batch(0)
    got = SyntheticLM(V, T, B).batch(0, device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    # the ranks the reference draws, with the cube by torch.pow instead
    from repro_torch import random as trnd
    key = trnd.fold_in(trnd.PRNGKey(0), 0)
    k1 = trnd.split(key, 2, partitionable=True)[0]
    u = trnd.uniform(k1, (B, T), partitionable=True)
    ranks = lambda p: torch.floor(float(V - 1) * p).to(torch.int32)
    moved = int((ranks(torch.pow(u, 3.0))
                 != ranks(numerics.pow32(u, 3.0))).sum())
    assert moved > 100


def test_pipeline_deterministic_and_step_indexed():
    """Twin of the reference's ``test_pipeline_deterministic_and_step_
    indexed``."""
    ds = SyntheticLM(vocab=1000, seq_len=64, global_batch=4, seed=3)
    b1 = ds.batch(17, device="cpu")
    b2 = ds.batch(17, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = ds.batch(18, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert bool((b1["labels"][:, -1] == -1).all())
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
