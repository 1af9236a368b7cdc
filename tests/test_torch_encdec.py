"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-base
at its ``reduced()`` size) on the CPU against the JAX package, with the
reference's parameters carried across by ``models.convert``: ``encode``,
``decode_train``, ``prefill_step`` (the reference's prefill program,
``repro.launch.specs``: the encoder, the decoder against its output, the
last position's logits through ``embed.T``), ``decode_step`` from a
non-zero cross K/V state, and the greedy serve waves.

The reference's ``encode`` cannot run with float32 parameters: it casts
the frames to bfloat16, and its ``lax.scan`` then refuses a carry that
the first block turns into float32 (a TypeError).  The float32 cases
unroll its encoder from the reference's own ``attn_apply``, ``apply_mlp``,
``rmsnorm`` and ``sinusoid_positions``, as its ``encode`` composes them.

Tolerances (``test_torch_models``'s, for the same reasons): float32
1e-5 (measured ~1e-6 on the encoder and decoder, 2e-7 on the logits);
bfloat16 hidden states 2.5e-2 relative + 5e-2 absolute (measured 0.023
and 0.031 max abs), logits 2e-2 (measured 0.0033); decode in bfloat16
2e-2 a step (measured 0.0055 over 20 steps).
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import build_model as jbuild_model
from repro.models.attention import attn_apply as jattn_apply
from repro.models.common import apply_mlp as japply_mlp
from repro.models.common import rmsnorm as jrmsnorm
from repro.models.common import sinusoid_positions as jsinusoid
from repro.models.common import unembed as junembed

from repro_torch.configs import get_config
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.common import sinusoid_positions
from repro_torch.models.convert import (decode_state_from_numpy,
                                        params_from_numpy)
from repro_torch.models.encdec import EncDec, EncDecState

from test_torch_models import (BF16_LOGITS_TOL, DECODE_TOL, F32_TOL, _f,
                               _margin_agree)

torch.set_num_threads(1)

ARCH = "whisper-base"
BF16_H_TOL = dict(rtol=2.5e-2, atol=5e-2)


def _pair(f32: bool):
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    assert dc.asdict(cfg) == dc.asdict(jcfg)
    jm, tm = jbuild_model(jcfg), build_model(cfg)
    assert isinstance(tm, EncDec)
    jp = jm.init_params(jax.random.PRNGKey(0))
    if f32:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _inputs(cfg, B=2, T=40, seed=0):
    r = np.random.default_rng(seed)
    frames = r.normal(size=(B, cfg.n_frames, cfg.d_model)).astype(
        np.float32)
    tok = r.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    return frames, tok


def _jencode(jm, jp, frames, f32: bool):
    """The reference's encoder output; in float32 its block unrolled
    (its ``encode`` refuses float32 parameters, see the module doc)."""
    if not f32:
        return jm.encode(jp, jnp.asarray(frames), remat=False)
    cfg = jm.cfg
    T = frames.shape[1]
    x = jnp.asarray(frames).astype(jnp.bfloat16) + \
        jsinusoid(T, cfg.d_model).astype(jnp.bfloat16)[None]
    for i in range(cfg.n_enc_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], jp["enc_layers"])
        x = x + jattn_apply(lp["attn"], jrmsnorm(x, lp["norm1"]),
                            n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                            head_dim=cfg.head_dim, causal=False,
                            positions=None)
        x = x + japply_mlp(lp["mlp"], jrmsnorm(x, lp["norm2"]))
    return jrmsnorm(x, jp["enc_norm"])


def test_reference_encode_refuses_float32_parameters():
    """The reason the float32 cases unroll the reference's encoder."""
    jm, jp, _, _ = _pair(f32=True)
    frames, _ = _inputs(jm.cfg)
    with pytest.raises(TypeError, match="carry"):
        jm.encode(jp, jnp.asarray(frames), remat=False)


def test_sinusoid_positions_match_reference():
    np.testing.assert_array_equal(sinusoid_positions(1500, 512),
                                  np.asarray(jsinusoid(1500, 512)))


def test_params_and_decode_state_carry_across():
    """The port's schema is the reference's tree (shapes, types), and its
    decode state has the reference's leaves less the per-layer ``pos``."""
    jm, jp, tm, tp = _pair(f32=False)
    own = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    flat = lambda t, pre="": sum(
        (flat(v, pre + k + ".") if isinstance(v, dict) else
         [(pre + k, tuple(v.shape), v.dtype)] for k, v in t.items()), [])
    assert sorted(flat(own)) == sorted(flat(tp))
    js = jm.init_decode_state(3, 12)
    ts = tm.init_decode_state(3, 12, device="cpu")
    assert isinstance(ts, EncDecState)
    for got, want in ((ts.self_kv.k, js.self_kv.k),
                      (ts.self_kv.v, js.self_kv.v),
                      (ts.cross_kv["k"], js.cross_kv["k"]),
                      (ts.cross_kv["v"], js.cross_kv["v"])):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.bfloat16 and not bool(got.any())
    assert ts.pos.dtype == torch.int32 and ts.pos.dim() == 0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_encode_matches_reference(precision):
    f32 = precision == "f32"
    jm, jp, tm, tp = _pair(f32)
    frames, _ = _inputs(tm.cfg)
    want = _jencode(jm, jp, frames, f32)
    before = dict(counts)
    got = tm.encode(tp, torch.from_numpy(frames))
    assert counts == before
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    tol = dict(rtol=F32_TOL, atol=F32_TOL) if f32 else BF16_H_TOL
    np.testing.assert_allclose(_f(got), _f(want), **tol)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_decode_train_and_prefill_match_reference(precision):
    f32 = precision == "f32"
    jm, jp, tm, tp = _pair(f32)
    frames, tok = _inputs(tm.cfg, seed=1)
    je = _jencode(jm, jp, frames, f32)
    jh = jm.decode_train(jp, jnp.asarray(tok), je, remat=False)
    jlog = junembed(jh[:, -1:], jp["embed"].T)
    th = tm.decode_train(tp, torch.from_numpy(tok).long(),
                         tm.encode(tp, torch.from_numpy(frames)))
    tpre = tserve.prefill_step(tm, tp, {
        "frames": torch.from_numpy(frames),
        "tokens": torch.from_numpy(tok).long()})
    assert tpre.dtype == torch.float32
    assert tuple(tpre.shape) == (2, 1, tm.cfg.vocab)
    if f32:
        h_tol = l_tol = dict(rtol=F32_TOL, atol=F32_TOL)
    else:
        h_tol = BF16_H_TOL
        l_tol = dict(rtol=BF16_LOGITS_TOL, atol=BF16_LOGITS_TOL)
    np.testing.assert_allclose(_f(th), _f(jh), **h_tol)
    np.testing.assert_allclose(_f(tpre), _f(jlog), **l_tol)


def test_decode_steps_from_nonzero_cross_kv():
    """20 bf16 decode steps from the same non-zero cross K/V state,
    carried across from numpy."""
    jm, jp, tm, tp = _pair(f32=False)
    B, T = 2, 20
    r = np.random.default_rng(3)
    js = jm.init_decode_state(B, T + 4)
    js = js._replace(cross_kv={
        n: jnp.asarray(r.normal(size=js.cross_kv[n].shape)).astype(
            jnp.bfloat16) for n in ("k", "v")})
    ts = decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                 device="cpu")
    np.testing.assert_array_equal(
        ts.cross_kv["k"].view(torch.int16).numpy(),
        np.asarray(js.cross_kv["k"]).view(np.int16))
    tok = r.integers(0, tm.cfg.vocab, (B, T)).astype(np.int32)
    step = jax.jit(jm.decode_step)
    for t in range(T):
        jl, js = step(jp, jnp.asarray(tok[:, t:t + 1]), js)
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok[:, t:t + 1])
                                .long(), ts)
        assert int(ts.pos) == t + 1
        np.testing.assert_allclose(_f(tl), _f(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {t}")
    # the self-attention cache holds the same tokens' K/V
    np.testing.assert_allclose(_f(ts.self_kv.k[:, :, :, :T]),
                               _f(js.self_kv.k[:, :, :, :T]),
                               rtol=BF16_H_TOL["rtol"],
                               atol=BF16_H_TOL["atol"])


def serve_waves_against_reference(arch, monkeypatch):
    """The reference's ``serve.main`` on ``arch``'s reduced config (its
    ``get_config`` patched in the test; two waves of 4 slots, one
    part-filled) against the port's waves on the same parameters: each
    step's logits on the same inputs within ``DECODE_TOL``, the greedy
    tokens equal where the reference's top-2 margin is decisive."""
    jcfg = jget_config(arch).reduced()
    monkeypatch.setattr(jserve, "get_config", lambda name: jcfg)
    argv = ["--arch", arch, "--requests", "6", "--batch-slots", "4",
            "--prompt-len", "6", "--gen-len", "8", "--max-seq", "16"]
    want = jserve.main(argv)
    cfg = get_config(arch).reduced()
    jm, tm = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 6).astype(np.int32)
               for _ in range(6)]
    record = []
    got, n_tok = tserve.serve_waves(tm, tp, prompts, batch_slots=4,
                                    prompt_len=6, gen_len=8, max_seq=16,
                                    device="cpu", record=record)
    assert n_tok == 4 * 13 + 2 * 13
    assert [len(o) for o in got] == [8] * 6
    step = jax.jit(jm.decode_step)
    checked = 0
    for w0 in (0, 4):
        wave = prompts[w0:w0 + 4]
        seq = np.zeros((4, 14), np.int32)
        for s in range(len(wave)):
            seq[s, :6] = wave[s]
            seq[s, 6:] = got[w0 + s][:8]
        js = jm.init_decode_state(4, 16)
        jlog = []
        for t in range(13):
            lg, js = step(jp, jnp.asarray(seq[:, t:t + 1]), js)
            jlog.append(np.asarray(lg[:, 0]))
        steps = record[13 * (w0 // 4):13 * (w0 // 4 + 1)]
        for s in range(len(wave)):
            for t in range(13):
                np.testing.assert_allclose(_f(steps[t][s]), jlog[t][s],
                                           rtol=DECODE_TOL,
                                           atol=DECODE_TOL)
            checked += _margin_agree(got[w0 + s], want[w0 + s],
                                     [jlog[t][s] for t in range(5, 13)],
                                     2 * DECODE_TOL)
    assert checked > 0


def test_serve_waves_match_reference_greedy(monkeypatch):
    serve_waves_against_reference(ARCH, monkeypatch)
