"""The port's vlm family (qwen2-vl-7b at its ``reduced()`` size: M-RoPE
sections (2, 3, 3), precomputed embeddings) on the CPU against the JAX
package, with the reference's parameters carried across by
``models.convert``: ``apply_mrope`` on positions whose three rows differ,
``hidden_states(embeds=, positions=)``, ``prefill_step`` (the reference's
prefill program: the forward without remat, the last position's
logits), decode through the embedding table, and the greedy serve waves.

Positions: a text run, an image of h x w patches (t fixed at the image's
start, h and w counting its rows and columns from there, as Qwen2-VL
numbers them), then text again from one past the image's largest
position.

Tolerances (``test_torch_models``'s, for the same reasons): ``apply_mrope``
in float32 within 2e-6 (the angles are the reference's products, bit for
bit; ``cos``/``sin`` differ between the two libraries by an ulp or two:
measured 2.4e-7); the model in float32 1e-5, in bfloat16 hidden states
2.5e-2 relative + 5e-2 absolute, logits and decode steps 2e-2.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.common import apply_mrope as japply_mrope

from repro_torch.configs import get_config
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.models.common import apply_mrope, apply_rope

from test_torch_encdec import serve_waves_against_reference
from test_torch_models import (BF16_LOGITS_TOL, DECODE_TOL, F32_TOL, _f,
                               _pair, _tensor)

torch.set_num_threads(1)

ARCH = "qwen2-vl-7b"
MROPE_TOL = 2e-6
BF16_H_TOL = dict(rtol=2.5e-2, atol=5e-2)


def mrope_positions(B, T, text=10, h=4, w=5):
    """[3, B, T] int32: ``text`` text tokens, an h x w image, text."""
    pos = np.zeros((3, T), np.int32)
    pos[:, :text] = np.arange(text)
    n_img = min(h * w, T - text)
    r, c = np.divmod(np.arange(n_img), w)
    pos[0, text:text + n_img] = text
    pos[1, text:text + n_img] = text + r
    pos[2, text:text + n_img] = text + c
    rest = T - text - n_img
    nxt = text + max(h, w)
    pos[:, text + n_img:] = nxt + np.arange(rest)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, T)))


def _embeds(cfg, B=2, T=40, f32=True, seed=0):
    x = np.random.default_rng(seed).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)
    if not f32:
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return x


def test_reduced_config_matches_reference():
    assert dc.asdict(get_config(ARCH).reduced()) == \
        dc.asdict(jget_config(ARCH).reduced())
    assert dc.asdict(get_config(ARCH)) == dc.asdict(jget_config(ARCH))


@pytest.mark.parametrize("sections,Dh,theta", [
    ((2, 3, 3), 16, 1e6),          # the reduced config's
    ((16, 24, 24), 128, 1e6),      # qwen2-vl-7b's
])
def test_apply_mrope_matches_reference(sections, Dh, theta):
    B, T, H = 2, 40, 3
    x = np.random.default_rng(1).normal(size=(B, T, H, Dh)).astype(
        np.float32)
    pos = mrope_positions(B, T)
    want = japply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections,
                      theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MROPE_TOL, atol=MROPE_TOL)
    # with all three rows equal it is the plain RoPE's rotation
    same = np.broadcast_to(pos[0:1], pos.shape).copy()
    torch.testing.assert_close(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same), sections,
                    theta),
        apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), theta),
        rtol=0, atol=0)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_forward_and_prefill_match_reference(precision):
    """``hidden_states(embeds=, positions=)``, ``logits`` and
    ``prefill_step`` on the same embeddings and 3-row positions."""
    f32 = precision == "f32"
    jm, jp, tm, tp = _pair(ARCH, f32=f32)
    emb = _embeds(tm.cfg, f32=f32)
    pos = mrope_positions(2, 40)
    jh = jm.hidden_states(jp, embeds=jnp.asarray(emb),
                          positions=jnp.asarray(pos), remat=False)
    jlog = jm.logits(jp, jh)
    before = dict(counts)
    batch = {"embeds": _tensor(emb), "positions": torch.from_numpy(pos)}
    th = tm.hidden_states(tp, **batch)
    tpre = tserve.prefill_step(tm, tp, batch)
    assert counts == before
    assert th.dtype == (torch.float32 if f32 else torch.bfloat16)
    assert tuple(tpre.shape) == (2, 1, tm.cfg.vocab)
    if f32:
        h_tol = l_tol = dict(rtol=F32_TOL, atol=F32_TOL)
    else:
        h_tol = BF16_H_TOL
        l_tol = dict(rtol=BF16_LOGITS_TOL, atol=BF16_LOGITS_TOL)
    np.testing.assert_allclose(_f(th), _f(jh), **h_tol)
    np.testing.assert_allclose(_f(tpre), _f(jlog[:, -1:]), **l_tol)


def test_default_positions_are_the_reference_broadcast():
    """Without ``positions`` both programs number the tokens 0..T-1 in
    every row: the same hidden states as those positions given."""
    jm, jp, tm, tp = _pair(ARCH, f32=True)
    emb = _embeds(tm.cfg, T=24)
    jh = jm.hidden_states(jp, embeds=jnp.asarray(emb), remat=False)
    th = tm.hidden_states(tp, embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(_f(th), _f(jh), rtol=F32_TOL, atol=F32_TOL)
    pos = torch.arange(24, dtype=torch.int32).expand(3, 2, 24)
    torch.testing.assert_close(th, tm.hidden_states(
        tp, embeds=torch.from_numpy(emb), positions=pos), rtol=0, atol=0)


def test_decode_steps_match_reference_bf16():
    """Decode through the embedding table, M-RoPE at ``[3, B, 1]``
    positions ``pos``."""
    jm, jp, tm, tp = _pair(ARCH, f32=False)
    B, T = 2, 20
    tok = np.random.default_rng(2).integers(0, tm.cfg.vocab, (B, T)) \
        .astype(np.int32)
    js = jm.init_decode_state(B, T + 4)
    ts = tm.init_decode_state(B, T + 4, device="cpu")
    step = jax.jit(jm.decode_step)
    for t in range(T):
        jl, js = step(jp, jnp.asarray(tok[:, t:t + 1]), js)
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok[:, t:t + 1])
                                .long(), ts)
        assert int(ts.pos) == t + 1
        np.testing.assert_allclose(_f(tl), _f(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {t}")


def test_serve_waves_match_reference_greedy(monkeypatch):
    serve_waves_against_reference(ARCH, monkeypatch)
