"""Gradients of the port's attention on the CPU against the reference's:
``jax.grad`` through its Pallas kernel's custom VJP in interpret mode
(``impl="flash", interpret=True``, whose backward recomputes through its
plain version) and through its plain ``ref.attention``; the port's
``ops.attention`` on a CPU tensor differentiates through its own plain
version, and ``ref.attention_bwd`` (the backward kernel's yardstick on
the card) is that gradient.  GQA groups 1, 2 and 7, causal (Tq <= Tk)
and not, float32 and bfloat16.  The forward kernels' log-sum-exp
yardstick (``ref.logsumexp``) against ``jax.nn.logsumexp``.

Tolerances: float32 within 2e-5 of each output's max magnitude (the
same float32 sums in another order); bfloat16 within 2^-7 of it (both
sides round the gradients to bfloat16, 2^-8 of an element, from float32
sums taken in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref

from repro_torch.kernels.flash_attention import attention
from repro_torch.kernels.flash_attention import ref as tref

torch.set_num_threads(1)

TOL = {"f32": 2e-5, "bf16": 2.0 ** -7}
CASES = [  # B, Hq, Hkv, Tq, Tk, D, causal
    (2, 4, 4, 40, 40, 16, True),          # group 1
    (1, 4, 2, 70, 70, 32, True),          # group 2, ragged to the blocks
    (1, 14, 2, 33, 33, 16, True),         # group 7
    (1, 4, 2, 20, 48, 16, True),          # causal, Tq < Tk
    (2, 4, 2, 24, 40, 16, False),         # non-causal
    (1, 7, 1, 40, 24, 32, False),         # group 7, non-causal, Tq > Tk
]


def _inputs(B, Hq, Hkv, Tq, Tk, D, precision, seed=0):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, Hq, Tq, D)).astype(np.float32)
    k = r.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    v = r.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    do = r.normal(size=(B, Hq, Tq, D)).astype(np.float32)
    jt = jnp.float32 if precision == "f32" else jnp.bfloat16
    j = [jnp.asarray(a, jt) for a in (q, k, v, do)]
    tt = torch.float32 if precision == "f32" else torch.bfloat16
    t = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tt)
         for a in j]
    return j, t


def _close(got, want, precision):
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL[precision] * np.abs(w).max())


def _jax_vjp(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, q, k, v)
    return vjp(do)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", CASES)
def test_attention_gradients_match_reference(B, Hq, Hkv, Tq, Tk, D, causal,
                                             precision):
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(B, Hq, Hkv, Tq, Tk, D,
                                               precision)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = attention(qs, ks, vs, causal=causal)
    got = torch.autograd.grad(out, (qs, ks, vs), do)
    assert all(g.dtype == q.dtype for g in got)
    kernel = _jax_vjp(lambda a, b, c: jops.attention(
        a, b, c, causal=causal, impl="flash", interpret=True),
        jq, jk, jv, jdo)
    plain = _jax_vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal),
                     jq, jk, jv, jdo)
    _close(got, kernel, precision)
    _close(got, plain, precision)
    # the yardstick of the card's backward kernel is this gradient
    for a, b in zip(tref.attention_bwd(q, k, v, do, causal=causal), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", CASES)
def test_logsumexp_matches_jax(B, Hq, Hkv, Tq, Tk, D, causal):
    (jq, jk, _, _), (q, k, _, _) = _inputs(B, Hq, Hkv, Tq, Tk, D, "f32")
    g = Hq // Hkv
    logits = jnp.einsum("bhgqd,bhkd->bhgqk", jq.reshape(B, Hkv, g, Tq, D),
                        jk) * D ** -0.5
    if causal:
        mask = jnp.arange(Tk)[None, :] <= jnp.arange(Tq)[:, None] + Tk - Tq
        logits = jnp.where(mask, logits, -jnp.inf)
    want = jax.nn.logsumexp(logits, axis=-1).reshape(B, Hq, Tq)
    got = tref.logsumexp(q, k, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6 * float(np.abs(want).max()))
