"""The port's tropical closure on the CPU against the JAX reference.

``ref.tropical_closure`` (the plain squarings) and ``ops.tropical_closure``
on a CPU tensor (which runs that plain version) against the reference's
``ops.tropical_closure`` through its Pallas kernel in interpret mode:
bit-equal.  Each term is one float32 add and max is exact, so the order
of the terms cannot change a bit; the inputs hold no -0, so no tie
between +0 and -0 arises.  The route rule ``ops.closure_route`` that
sends an [S, S] closure on the card to the closure kernel (S up to
``ops.CLOSURE_MAX_S``) or to the repeated products is checked at and
around its limit.  The kernels themselves run in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tropical.ops import tropical_closure as jclosure

from repro_torch.kernels import counts
from repro_torch.kernels.tropical import ops as ttrop
from repro_torch.kernels.tropical import ref as ttrop_ref

# the port's tensors here are small: one intra-op thread per test
# process beats oversubscribing the cores across test workers
torch.set_num_threads(1)


def _closure_input(S, seed, dag):
    """Two [S, S] delay matrices: a DAG's (edges i -> j > i, weights in
    [0.1, 2)) or a general one (signed weights, cycles), -inf off the
    edges."""
    rng = np.random.default_rng(seed)
    if dag:
        w = rng.uniform(0.1, 2.0, size=(2, S, S))
        keep = np.triu(rng.random((2, S, S)) < 0.3, k=1)
    else:
        w = rng.normal(size=(2, S, S)) * 3.0
        keep = rng.random((2, S, S)) < 0.3
    return np.where(keep, w, -np.inf).astype(np.float32)


@pytest.mark.parametrize("depth", [None, 1, 2, 3, 9])
@pytest.mark.parametrize("S", [1, 13, 127, 128, 129])
def test_closure_matches_reference(S, depth):
    a = _closure_input(S, S * 10 + (depth or 0), dag=S % 2 == 1)
    want = np.asarray(jclosure(jnp.asarray(a), depth=depth, use_pallas=True,
                               interpret=True))
    before = dict(counts)
    plain = ttrop_ref.tropical_closure(torch.from_numpy(a), depth)
    got = ttrop.tropical_closure(torch.from_numpy(a), depth=depth)
    assert counts == before, "the CPU path launched a kernel"
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S,route", [
    (1, ttrop.CLOSURE), (13, ttrop.CLOSURE), (127, ttrop.CLOSURE),
    (128, ttrop.CLOSURE), (129, ttrop.PRODUCTS), (130, ttrop.PRODUCTS),
    (1024, ttrop.PRODUCTS)])
def test_closure_route_at_its_limit(S, route):
    assert ttrop.CLOSURE_MAX_S == 128
    assert ttrop.closure_route(S) == route


@pytest.mark.parametrize("S,depth,n", [
    (1, None, 1), (2, None, 1), (3, None, 2), (13, None, 4), (13, 4, 2),
    (13, 5, 3), (128, None, 7), (129, None, 8), (40, 1, 1), (40, 0, 1),
    (1024, 33, 6)])
def test_squarings_count_the_references_products(S, depth, n):
    """``ops.squarings`` is the number of products the reference's closure
    makes (⌈log₂ max(depth, 2)⌉, depth defaulting to S)."""
    assert ttrop.squarings(S, depth) == n


def test_closure_keeps_nan_and_inf():
    """NaN and +inf entries in a DAG, one squaring: the plain squarings
    against the reference, NaN where the reference has NaN and every
    other value equal."""
    a = _closure_input(13, 7, dag=True)
    a[0, 2, 5] = np.nan
    a[1, 4, 6] = np.inf
    want = np.asarray(jclosure(jnp.asarray(a), depth=2, use_pallas=True,
                               interpret=True))
    got = ttrop.tropical_closure(torch.from_numpy(a), depth=2).numpy()
    assert np.isnan(want).any() and np.isposinf(want).any()
    assert np.isfinite(want).any()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.where(nan, 0.0, got),
                                  np.where(nan, 0.0, want))
