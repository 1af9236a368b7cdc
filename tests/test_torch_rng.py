"""The port's threefry random numbers against ``jax.random``, bit for bit,
under the non-partitionable derivation the reference's goldens use.

``normal`` goes through ``erf_inv``, which XLA lowers to Giles' float32
polynomial over its own ``log1p``, both with fused multiply-adds; the
port writes the same arithmetic out.  Held over every input ``normal``
can produce (the 2^23 values of its uniform grid): ULP bound 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as tr
from repro_torch.analysis import streams as tstreams

# the port's tensors here are small: one intra-op thread per test
# process beats oversubscribing the cores across test workers
torch.set_num_threads(1)

SEEDS = (0, 3, 123, 2 ** 31 - 1)


@pytest.fixture(autouse=True)
def _non_partitionable():
    with jax.threefry_partitionable(False):
        yield


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    tk = tr.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(k), tk.numpy())
    for num in (1, 2, 5, 7):
        np.testing.assert_array_equal(_u32(jax.random.split(k, num)),
                                      tr.split(tk, num).numpy())
    for data in (0, 1, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(_u32(jax.random.fold_in(k, data)),
                                      tr.fold_in(tk, data).numpy())


def test_named_streams_are_the_plain_derivations():
    k = tr.PRNGKey(5)
    np.testing.assert_array_equal(
        tstreams.split(k, 3, names=("a", "b", "c")).numpy(),
        tr.split(k, 3).numpy())
    np.testing.assert_array_equal(
        tstreams.fold_in(k, 9, name="x").numpy(), tr.fold_in(k, 9).numpy())
    with pytest.raises(ValueError):
        tstreams.split(k, 2, names=("a",))
    with pytest.raises(ValueError):
        tstreams.split(k, 2, names=("a", "a"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", (1, 2, 7, 1000, 4097))
def test_bits_uniform_randint(seed, n):
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    tk = tr.split(tr.PRNGKey(seed), 3)
    np.testing.assert_array_equal(_u32(jax.random.bits(k[0], (n,))),
                                  tr.random_bits(tk[0], (n,)).numpy())
    u = np.asarray(jax.random.uniform(k[1], (n,)))
    np.testing.assert_array_equal(u.view(np.uint32),
                                  tr.uniform(tk[1], (n,)).numpy()
                                  .view(np.uint32))
    for lo, hi in ((0, 1 << 30), (0, 7), (-5, 1000)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(k[2], (n,), lo, hi)),
            tr.randint(tk[2], (n,), lo, hi).numpy())


@pytest.mark.parametrize("seed", (0, 5))
def test_normal_bit_exact(seed):
    k = jax.random.PRNGKey(seed)
    n = np.asarray(jax.random.normal(k, (1 << 16,)))
    tn = tr.normal(tr.PRNGKey(seed), (1 << 16,)).numpy()
    np.testing.assert_array_equal(n.view(np.uint32), tn.view(np.uint32))


def _normal_domain() -> np.ndarray:
    """Every uniform value ``normal`` feeds to erf_inv (2^23 of them)."""
    m = np.arange(1 << 23, dtype=np.uint32)
    f = (m | 0x3F800000).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.maximum(lo, f * np.float32(2.0) + lo).astype(np.float32)


def test_erf_inv_and_log1p_over_the_whole_normal_domain():
    x = _normal_domain()
    X = torch.from_numpy(x)
    want = np.asarray(jax.jit(
        lambda u: np.float32(np.sqrt(2)) * jax.lax.erf_inv(u))(x))
    got = (tr.erf_inv(X) * tr._SQRT2).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    a = (x * -x).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log1p)(a))
    got = tr.log1p(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_keys_stay_on_the_host():
    with pytest.raises(ValueError):
        tr.split(torch.zeros((3,), dtype=torch.int64))


def _fma_exact(a, b, c):
    """``a*b + c`` rounded once to float32 (ties to even), from the exact
    rational value."""
    from fractions import Fraction
    e = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(e))
    near = (f, np.nextafter(f, np.float32(np.inf)),
            np.nextafter(f, np.float32(-np.inf)))
    return min(near, key=lambda v: (abs(Fraction(float(v)) - e),
                                    int(np.float32(v).view(np.uint32)) & 1))


def test_fma32_rounds_once():
    # a*b = 2^-24 + 2^-61 on c = 1: the exact sum lies just above the
    # float32 midpoint 1 + 2^-24, so it rounds up; rounding it to float64
    # first would land on the midpoint and tie back down to 1
    a = np.float32(11860630 * 2.0 ** -23)
    b = np.float32(11865937 * 2.0 ** -48)
    one = torch.ones(1)
    got = tr.fma32(torch.tensor([a]), torch.tensor([b]), one)
    assert got.item() == np.float32(1.0 + 2.0 ** -23) == _fma_exact(a, b, 1)
    # rem - rate*dt (the cloudlet progress) with rem up to 1e11 times the
    # step, and the signs mixed
    g = np.random.default_rng(0)
    n = 3000
    x = g.uniform(-300.0, 300.0, n).astype(np.float32)
    c = (g.uniform(-1.0, 1.0, n) * 10.0 ** g.integers(0, 12, n)) \
        .astype(np.float32)
    got = tr.fma32(torch.from_numpy(x), 0.1, torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(x[i], np.float32(0.1), c[i])
                     for i in range(n)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_table,n,steps", [(1, 4096, 1), (3, 4096, 1),
                                             (1, 1, 512)])
def test_normal_fma_follows_the_compiled_tick(n_table, n, steps):
    """``max(mean[i] + std[i]·normal, 1)`` drawn ``n`` at a time inside a
    compiled loop, as the tick draws spawn lengths and payloads.  From a
    one-entry table XLA folds ``normal``'s sqrt(2) into the broadcast std
    (``lone``); from a larger table, or in a one-element draw, it keeps
    ``normal``'s order.  The other order gives other bits on some
    draws."""
    r = np.random.default_rng(n_table + n)
    mean = r.uniform(10.0, 100.0, n_table).astype(np.float32)
    std = r.uniform(1.0, 30.0, n_table).astype(np.float32)
    idx = r.integers(0, n_table, n).astype(np.int32)

    def body(key, m, s, i):
        key, sub = jax.random.split(key)
        x = m[i] + s[i] * jax.random.normal(sub, (n,), jnp.float32)
        return key, jnp.maximum(x, 1.0)
    draw = jax.jit(lambda k, m, s, i: jax.lax.scan(
        lambda c, _: body(c, m, s, i), k, None, length=steps)[1])
    want = np.asarray(draw(jax.random.PRNGKey(7), mean, std, idx))
    ti = torch.from_numpy(idx).long()
    m, s = torch.from_numpy(mean)[ti], torch.from_numpy(std)[ti]
    lone = n_table == 1
    folded = lone and n > 1
    key, got, other = tr.PRNGKey(7), [], []
    for _ in range(steps):
        key, sub = tr.split(key, 2)
        got.append(torch.clamp_min(
            tr.normal_fma(sub, (n,), s, m, lone=lone), 1.0).numpy())
        e = tr.erf_inv(tr.uniform(sub, (n,), tr._NORMAL_LO, 1.0))
        alt = (tr.fma32(s, e * tr._SQRT2, m) if folded
               else tr.fma32(e, s * tr._SQRT2, m))
        other.append(torch.clamp_min(alt, 1.0).numpy())
    np.testing.assert_array_equal(np.stack(got).view(np.uint32),
                                  want.view(np.uint32))
    assert not np.array_equal(np.stack(other), want)
