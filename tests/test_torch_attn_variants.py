"""The rest of the port's attention block on the CPU against the JAX
package: the int8 KV cache (``QuantKVCache``, ``_quant``), the ``flat``
and ``flat_seqshard`` formulations, and cross-attention's shape of the
kernel (non-causal, ragged, Tq ≠ Tk), with the reference's parameters
carried across by ``models.convert``.

Tolerances:
  * ``_quant``: bit-equal, int8 values and float32 scales, to the
    reference's jitted ``_quant`` on the same arrays (XLA turns its
    division by 127 into a multiply by float32(1/127), which the port
    copies; the division by the floored scale is one IEEE division on
    both sides; both round half to even);
  * int8 decode against the reference's int8 decode, from the same
    non-zero int8 cache: each step's logits within ``DECODE_TOL`` = 2e-2
    relative + absolute (measured 0.0053 and 0.021 max abs), the cache
    the steps write, dequantized, within the bf16
    hidden-state tolerance 2.5e-2 relative + 5e-2 absolute (the K/V
    projections are bf16 products that the two libraries round apart
    here and there; one such rounding moves the row's scale and its int8
    values by up to 2 steps: measured 0.044 max abs);
  * int8 against the port's own bf16 cache: ``test_quant_kv.py``'s rule
    (next-token probabilities within 1e-2; the bf16 argmax kept where it
    leads by more than 2e-2, near-maximal elsewhere);
  * ``flat``/``flat_seqshard`` hidden states against the reference's at
    the same setting: float32 1e-5, bf16 2.5e-2 relative + 5e-2 absolute;
    against the port's ``grouped`` in float32 1e-5 (the plain version
    batches the heads in another einsum, so the sums may round apart;
    measured 0 here);
  * the plain attention, non-causal with ragged Tq ≠ Tk, against the
    reference's Pallas kernel in interpret mode (which pads to its
    blocks): float32 2e-5, as ``test_torch_flash.py``.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.flash_attention import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models.attention import _quant as jquant

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import attention
from repro_torch.models import build_model
from repro_torch.models.attention import QuantKVCache, _quant
from repro_torch.models.convert import (decode_state_from_numpy,
                                        params_from_numpy)

from test_torch_models import DECODE_TOL, F32_TOL, _f, _pair, _tokens

torch.set_num_threads(1)

QTOL = 1e-2
BF16_H_TOL = dict(rtol=2.5e-2, atol=5e-2)


def _int8_pair(arch, f32=False):
    """(reference model, params, port model, params) with the int8 cache."""
    jm, jp, tm, tp = _pair(arch, f32=f32)
    jm = jbuild_model(dc.replace(jm.cfg, kv_dtype="int8"))
    tm = build_model(dc.replace(tm.cfg, kv_dtype="int8"))
    return jm, jp, tm, tp


@pytest.mark.parametrize("shape,dtype,scale", [
    ((2, 4, 1, 16), np.float32, 1.0),       # one decode step's K
    ((3, 2, 7, 128), np.float32, 3.7),      # qwen3's head width
    ((5, 64), np.float32, 1e-3),
    ((4, 2, 1, 16), "bfloat16", 2.0),       # as the model feeds it
])
def test_quant_is_the_references_bits(shape, dtype, scale):
    r = np.random.default_rng(0)
    x = (r.normal(size=shape) * scale).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0                   # a zero row
    x.reshape(-1, shape[-1])[1, :3] = [127.0, -127.0, 0.5]
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        jx = jx.astype(jnp.bfloat16)
        x = np.asarray(jx)
    wq, ws = jax.jit(jquant)(jx)
    tx = params_from_numpy({"x": np.asarray(jx)}, device="cpu")["x"]
    q, s = _quant(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(ws).view(np.int32))


def test_int8_cache_is_half_the_bytes():
    """``test_quant_kv.test_int8_cache_is_half_the_bytes`` on the port."""
    cfg = get_config("granite-20b")
    bf = build_model(cfg).init_decode_state(4, 128, device="cpu")
    q = build_model(dc.replace(cfg, kv_dtype="int8")).init_decode_state(
        4, 128, device="cpu")
    assert all(isinstance(c, QuantKVCache) for c in q.layers)
    assert q.layers[0].k.dtype == torch.int8
    nbytes = lambda layers: sum(t.numel() * t.element_size()
                                for c in layers for t in c)
    ratio = nbytes(q.layers) / nbytes(bf.layers)
    assert 0.5 < ratio < 0.54


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3-medium-14b"])
def test_int8_decode_matches_reference(arch):
    """10 decode steps of both programs from the same int8 cache, 5
    positions already filled with random values and scales."""
    jm, jp, tm, tp = _int8_pair(arch)
    B, S, filled = 2, 24, 5
    r = np.random.default_rng(4)
    js = jm.init_decode_state(B, S)
    lay = js.layers
    kq = r.integers(-127, 128, lay.k.shape).astype(np.int8)
    vq = r.integers(-127, 128, lay.v.shape).astype(np.int8)
    ks = (r.uniform(0.005, 0.02, lay.k_scale.shape)).astype(np.float32)
    vs = (r.uniform(0.005, 0.02, lay.v_scale.shape)).astype(np.float32)
    for a in (kq, vq, ks, vs):
        a[:, :, :, filled:] = 0
    js = js._replace(layers=lay._replace(
        k=jnp.asarray(kq), v=jnp.asarray(vq), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)), pos=jnp.asarray(filled, jnp.int32))
    ts = decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                 device="cpu")
    assert isinstance(ts.layers[0], QuantKVCache)
    np.testing.assert_array_equal(ts.layers[1].k.numpy(), kq[1])
    tok = _tokens(tm.cfg.vocab, B, 10, seed=5)
    step = jax.jit(jm.decode_step)
    for t in range(10):
        jl, js = step(jp, jnp.asarray(tok[:, t:t + 1]), js)
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok[:, t:t + 1])
                                .long(), ts)
        assert int(ts.pos) == filled + t + 1
        np.testing.assert_allclose(_f(tl), _f(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {t}")
    deq = lambda q, sc: np.asarray(q).astype(np.float32) \
        * np.asarray(sc)[..., None]
    for i, c in enumerate(ts.layers):
        np.testing.assert_array_equal(c.k[:, :, :filled].numpy(),
                                      kq[i, :, :, :filled])
        for got, want in ((deq(c.k, c.k_scale), deq(js.layers.k[i],
                                                     js.layers.k_scale[i])),
                          (deq(c.v, c.v_scale), deq(js.layers.v[i],
                                                     js.layers.v_scale[i]))):
            np.testing.assert_allclose(got, want, **BF16_H_TOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b"])
def test_int8_decode_tracks_bf16_on_the_port(arch):
    """``test_quant_kv.test_int8_kv_decode_matches_bf16``'s rule, the
    port's int8 cache against its bf16 cache on the same parameters."""
    cfg = get_config(arch).reduced()
    model, model_q = build_model(cfg), build_model(
        dc.replace(cfg, kv_dtype="int8"))
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    st = model.init_decode_state(B, S, device="cpu")
    st_q = model_q.init_decode_state(B, S, device="cpu")
    rng = np.random.default_rng(0)
    for t in range(6):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)))
        lg, st = model.decode_step(params, tok, st)
        lg_q, st_q = model_q.decode_step(params, tok, st_q)
        a = torch.softmax(lg[:, 0], -1).numpy()
        b = torch.softmax(lg_q[:, 0], -1).numpy()
        assert np.abs(a - b).max() < QTOL, t
        srt = np.sort(a, axis=-1)
        decisive = (srt[:, -1] - srt[:, -2]) > 2 * QTOL
        for i in range(B):
            if decisive[i]:
                assert a[i].argmax() == b[i].argmax(), (t, i)
            else:
                assert b[i, a[i].argmax()] >= b[i].max() - 2 * QTOL, (t, i)
    assert int(st_q.pos) == 6


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["flat", "flat_seqshard"])
def test_flat_formulations_match_reference(impl, precision):
    """Hidden states at ``attn_impl=impl`` against the reference's at the
    same setting, and (float32) against the port's ``grouped``."""
    f32 = precision == "f32"
    jm, jp, tm, tp = _pair("phi3-medium-14b", f32=f32)
    assert tm.cfg.n_kv < tm.cfg.n_heads
    jm = jbuild_model(dc.replace(jm.cfg, attn_impl=impl))
    flat = build_model(dc.replace(tm.cfg, attn_impl=impl))
    tok = _tokens(tm.cfg.vocab, seed=6)
    # flat_seqshard's sharding constraint names the mesh axes: a mesh of
    # the one CPU device, as the reference's launchers give it one
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with jax.set_mesh(mesh):
        jh = jm.hidden_states(jp, tokens=jnp.asarray(tok), remat=False)
    th = flat.hidden_states(tp, tokens=torch.from_numpy(tok).long())
    tol = dict(rtol=F32_TOL, atol=F32_TOL) if f32 else BF16_H_TOL
    np.testing.assert_allclose(_f(th), _f(jh), **tol)
    if f32:
        grouped = tm.hidden_states(tp, tokens=torch.from_numpy(tok).long())
        np.testing.assert_allclose(_f(th), _f(grouped), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", [
    (1, 4, 2, 40, 13, 16),        # cross: Tq > Tk, both ragged
    (2, 4, 4, 77, 150, 64),       # cross: Tq < Tk, whisper's head width
    (1, 8, 8, 150, 150, 64),      # the encoder's self-attention, ragged
])
def test_noncausal_ragged_plain_matches_pallas(B, Hq, Hkv, Tq, Tk, D):
    r = np.random.default_rng(7)
    q = r.normal(size=(B, Hq, Tq, D)).astype(np.float32)
    k = r.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    v = r.normal(size=(B, Hkv, Tk, D)).astype(np.float32)
    got = attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=False).numpy()
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False,
                                 impl="flash", interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
