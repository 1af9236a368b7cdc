"""The port's optimizer and gradient compression on the CPU against the
JAX package's, jitted as its train step runs them.

Aimed bit for bit, and held so: ``adamw_update`` (parameters, moments,
step, ``lr`` and ``grad_norm``) over several steps on trees of bfloat16
and float32 leaves of 1 to 3 dimensions, at gradient scales that clip and
that do not; ``lr_schedule`` at every step of three schedules;
``clip_by_global_norm``; ``compress_decompress`` and ``ef_compress`` in
float32 and bfloat16.  The global norm sums each leaf in XLA's tree
order (``optimizer.xla_sum``); for some multi-dimensional shapes LLVM's
vectoriser re-associates a reduction loop (``test_xla_sum_order``'s
``REASSOCIATED`` shapes), where a leaf's sum is held within
``REASSOCIATED_ULPS`` instead: the trees of the bit-equal tests here
avoid them.
Then the reference's own substrate tests (``tests/test_substrate.py``),
twinned on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as jcomp
from repro.train import optimizer as jopt

from repro_torch.dist import compression as tcomp
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, tensor_from_numpy,
                                        tree_to_numpy)
from repro_torch.train import optimizer as topt
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    return params_from_numpy(_np(tree), "cpu")


def _same_bits(a, b):
    """numpy arrays (bfloat16 through ml_dtypes) equal bit for bit."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


def _assert_tree_bits(want, got):
    """A reference tree and a port tree: every leaf bit-equal."""
    w = jax.tree_util.tree_leaves(_np(want))
    g = jax.tree_util.tree_leaves(tree_to_numpy(got, jnp.bfloat16))
    assert len(w) == len(g)
    for a, b in zip(w, g):
        _same_bits(a, b)


SHAPES = {"embed": ((300, 64), jnp.bfloat16),
          "final_norm": ((64,), jnp.float32),
          "layers": {"attn": {"wq": ((2, 256, 1024), jnp.bfloat16),
                              "q_norm": ((2, 64), jnp.float32)},
                     "mlp": {"gate": ((2, 64, 96), jnp.bfloat16)},
                     "mixer_norm": ((2, 64), jnp.float32)}}
# the same leaves flattened: each leaf's sum of squares is one loop, in
# XLA's order exactly
FLAT = {"embed": ((300 * 64,), jnp.bfloat16),
        "final_norm": ((64,), jnp.float32),
        "layers": {"attn": {"wq": ((2 * 256 * 1024,), jnp.bfloat16),
                            "q_norm": ((2 * 64,), jnp.float32)},
                   "mlp": {"gate": ((2 * 64 * 96,), jnp.bfloat16)},
                   "mixer_norm": ((2 * 64,), jnp.float32)}}


def _tree(rng, scale=0.1, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    shape, dt = shapes
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32) * scale,
                       dt)


def _run_adamw(cfg, shapes, scales, exact_norm=True):
    rng = np.random.default_rng(0)
    jcfg, tcfg = jopt.AdamWCfg(**cfg), topt.AdamWCfg(**cfg)
    step = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jcfg))
    params = _tree(rng, shapes=shapes)
    state = jopt.adamw_init(params)
    tp = _port(params)
    ts = opt_state_from_numpy(_np(state), "cpu")
    for scale in scales:
        grads = _tree(rng, scale, shapes)
        params, state, m = step(params, grads, state)
        tp, ts, tm = topt.adamw_update(tp, _port(grads), ts, tcfg)
        _assert_tree_bits(params, tp)
        _assert_tree_bits((state.step, state.mu, state.nu),
                          (ts.step, ts.mu, ts.nu))
        _same_bits(m["lr"], tm["lr"].numpy())
        if exact_norm:
            _same_bits(m["grad_norm"], tm["grad_norm"].numpy())
        else:
            ulps = abs(int(np.asarray(m["grad_norm"]).view(np.int32))
                       - int(tm["grad_norm"].numpy().view(np.int32)))
            assert ulps <= REASSOCIATED_ULPS


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-3, warmup_steps=5, total_steps=100),
    dict(),                                   # the defaults
    dict(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=1000,
         clip_norm=100.0),
], ids=["short", "defaults", "no-decay"])
def test_adamw_update_is_the_jitted_references_bits(cfg):
    """Six steps whose gradients clip every other step: every bit."""
    _run_adamw(cfg, FLAT, [10.0 if i % 2 else 0.01 for i in range(6)])


def test_adamw_update_on_model_shaped_leaves():
    """Leaves of 1 to 3 dimensions, gradients that do not clip (the scale
    is exactly 1): every parameter and moment bit-equal, the norm within
    ``REASSOCIATED_ULPS``."""
    _run_adamw(dict(lr=1e-3, warmup_steps=5, total_steps=100), SHAPES,
               [1e-4, 3e-4, 1e-4], exact_norm=False)


@pytest.mark.parametrize("cfg", [
    dict(), dict(lr=1e-3, warmup_steps=5, total_steps=100),
    dict(lr=3e-3, warmup_steps=2, total_steps=10, min_lr_frac=0.0)])
def test_lr_schedule_is_the_jitted_references_bits(cfg):
    jcfg, tcfg = jopt.AdamWCfg(**cfg), topt.AdamWCfg(**cfg)
    f = jax.jit(lambda s: jopt.lr_schedule(s, jcfg))
    stride = 37 if jcfg.total_steps > 1000 else 1
    for s in range(0, jcfg.total_steps + 20, stride):
        got = topt.lr_schedule(torch.tensor(s, dtype=torch.int32), tcfg)
        _same_bits(f(jnp.int32(s)), got.numpy())


def test_clip_by_global_norm_is_the_jitted_references_bits():
    rng = np.random.default_rng(1)
    f = jax.jit(lambda g: jopt.clip_by_global_norm(g, 1.0))
    for scale in (0.001, 1.0):
        grads = _tree(rng, scale, FLAT)
        (cj, nj), (ct, nt) = f(grads), topt.clip_by_global_norm(
            _port(grads), 1.0)
        _assert_tree_bits(cj, ct)
        _same_bits(nj, nt.numpy())


# leaf shapes whose sum of squares the reference's jitted program computes
# in the order ``xla_sum`` writes, over every seed tried (1-d leaves
# always: one loop); for other multi-dimensional shapes LLVM vectorises
# a reduction loop across rows and re-associates it, data-dependently:
# within REASSOCIATED_ULPS (measured at most 7 over 10 seeds on these
# shapes, the tiny preset's among them)
XLA_ORDER = [(1000,), (37,), (33,), (1025,), (2, 256, 1024), (4, 1024),
             (28, 128), (2, 64, 96), (300, 7, 11), (5000, 33), (300, 64),
             (2, 64), (2, 256)]
REASSOCIATED = [(1024, 4), (30, 8), (4, 1024, 256), (2048, 256), (4, 32),
                (40, 50), (28, 64, 160)]
REASSOCIATED_ULPS = 16


def test_xla_sum_order():
    f = jax.jit(lambda x: jnp.sum(jnp.square(x)))
    rng = np.random.default_rng(2)
    for shape in XLA_ORDER + REASSOCIATED:
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(f(x))
        t = torch.from_numpy(x)
        got = topt.xla_sum(t * t).numpy()
        if shape in REASSOCIATED:
            ulps = abs(int(got.view(np.int32)) - int(want.view(np.int32)))
            assert ulps <= REASSOCIATED_ULPS, (shape, ulps)
        else:
            _same_bits(want, got)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_compression_is_the_jitted_references_bits(dtype):
    rng = np.random.default_rng(3)
    cd = jax.jit(jcomp.compress_decompress)
    for shape, scale in (((1000,), 1e-3), ((64, 96), 1.0),
                         ((3, 50, 7), 30.0)):
        x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        * scale, dtype)
        _same_bits(cd(x), tree_to_numpy(tcomp.compress_decompress(
            tensor_from_numpy(np.asarray(x), "cpu")), jnp.bfloat16))
    grads = {"w": jnp.asarray(rng.standard_normal((2048,)).astype(
        np.float32) * 1e-3, dtype), "b": jnp.asarray(
        rng.standard_normal((7, 33)).astype(np.float32), dtype)}
    ef = jcomp.ef_init(grads)
    tef = tcomp.ef_init(_port(grads))
    efc = jax.jit(jcomp.ef_compress)
    for _ in range(3):
        c, ef = efc(grads, ef)
        tc, tef = tcomp.ef_compress(_port(grads), tef)
        _assert_tree_bits((c, ef), (tc, tef))


# ---------------------------------------------------------------------------
# twins of the reference's tests/test_substrate.py (optimizer, compression)
# ---------------------------------------------------------------------------

def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    cfg = topt.AdamWCfg(lr=0.1, weight_decay=0.0, warmup_steps=1,
                        total_steps=1000, clip_norm=100.0)
    state = topt.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_weight_decay_shrinks_without_gradient():
    params = {"w": torch.ones(4) * 2.0}
    cfg = topt.AdamWCfg(lr=0.1, weight_decay=0.5, warmup_steps=1,
                        total_steps=100)
    state = topt.adamw_init(params)
    p1, _, _ = topt.adamw_update(params, {"w": torch.zeros(4)}, state, cfg)
    assert float(p1["w"][0]) < 2.0


def test_lr_schedule_shape():
    cfg = topt.AdamWCfg(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    lrs = [float(topt.lr_schedule(torch.tensor(s), cfg)) for s in range(101)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6
    assert abs(lrs[10] - 1.0) < 0.01
    assert lrs[100] == pytest.approx(0.1, rel=0.05)


def test_grad_clip():
    g = {"a": torch.ones(100) * 10.0}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(100.0)
    assert float(torch.sqrt(torch.sum(clipped["a"] ** 2))) == \
        pytest.approx(1.0, rel=1e-4)


def test_int8_compression_error_bounded(rng):
    x = torch.from_numpy(rng.normal(size=(1024,)).astype(np.float32))
    y = tcomp.compress_decompress(x)
    err = (x - y).abs().numpy()
    assert err.max() <= float(x.abs().max()) / 127 * 1.01


def test_error_feedback_reduces_bias(rng):
    g = torch.from_numpy(rng.normal(size=(2048,)).astype(np.float32)) * 1e-3
    grads = {"w": g}
    ef = tcomp.ef_init(grads)
    total_plain = np.zeros(2048, np.float32)
    total_ef = np.zeros(2048, np.float32)
    for _ in range(50):
        total_plain += tcomp.compress_decompress(g).numpy()
        c, ef = tcomp.ef_compress(grads, ef)
        total_ef += c["w"].numpy()
    true = g.numpy() * 50
    assert np.abs(total_ef - true).mean() <= \
        np.abs(total_plain - true).mean() + 1e-6


def test_adamw_state_leaves_follow_jax_order():
    """``tree_leaves`` walks dicts in sorted-key order, as
    ``jax.tree_util`` does: the clip's sum follows it."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jopt.adamw_init(params))]
    got = tree_leaves(opt_state_from_numpy(_np(jopt.adamw_init(params)),
                                           "cpu"))
    assert [tuple(x.shape) for x in want] == [tuple(x.shape) for x in got]
