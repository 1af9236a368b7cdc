"""The port's hybrid family (``repro_torch.models.hybrid``, jamba-1.5-large
at its ``reduced()`` size: one period of 4 layers, attention then three
Mamba-2 layers, MoE with 8 experts on the odd layers) on the CPU against
the JAX package, with the reference's parameters and decode state carried
across by ``models.convert``.  The reference's Mamba layers run their SSD
Pallas kernel in interpret mode, its attention its jnp version.

Tolerances (max abs error):
  * float32 (the reference's parameters cast to float32 on both sides):
    hidden states, logits and the prefill's logits within 1e-5 (measured
    7e-6: sums in another order);
  * bfloat16 as shipped: each layer's output within one bf16 step of the
    reference's (measured: attention 0, FFN and MoE up to 0.0195 at
    magnitude ~3, Mamba 0.031 at ~5), and the residual stream they are
    added to reaches ~9 before the final norm, where a bf16 step is
    0.0625: hidden states within ``HIDDEN_TOL`` (2.5e-2 relative + 0.1
    absolute; measured 0.070 at magnitude ~3.4), logits (float32 from
    them, magnitude ~2) within ``LOGITS_TOL`` (2e-2 relative + 5e-2
    absolute; measured 0.046 in prefill, 0.037 in decode);
  * routing: the two programs' router probabilities differ by up to
    ``ROUTE_DIFF`` where their inputs agree, so a token whose K-th and
    (K+1)-th probability lie within ``ROUTE_TIE`` = 2 x that may route
    otherwise.  Where one does, the hidden states are held before the
    first such token (in the flattened order, which also orders the
    experts' capacity), and a decode step's logits where both route
    every token alike;
  * the port's decode against its own forward (float32 weights, no
    assignment dropped): each step's logits within 2e-2 (measured 0.0144,
    0.0044 at the first step: the KV cache and the convolution state
    round K, V and the convolution's inputs to bf16).
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.hybrid as jhybrid
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model

import repro_torch.models.hybrid as thybrid
from repro_torch.configs import get_config
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.convert import (decode_state_from_numpy,
                                        params_from_numpy)
from repro_torch.models.moe import route
from repro_torch.tree import tree_leaves, tree_map

from test_torch_models import F32_TOL, _f, _tokens

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"
HIDDEN_TOL = dict(rtol=2.5e-2, atol=1e-1)
LOGITS_TOL = dict(rtol=2e-2, atol=5e-2)
# measured: the two programs' router probabilities of tokens whose
# inputs agree differ by up to 1.09e-3 (prefill, bf16, six seeds); the
# reduced router (weights ~N(0, 0.02²)) gives probabilities near 1/8, so
# gaps that small are common: the first token routed otherwise was at
# flat index 6 to 33 of 80 in those six prefills
ROUTE_DIFF = 1.1e-3
ROUTE_TIE = 2 * ROUTE_DIFF


def _pair(f32: bool):
    """(reference model, its params, port model, the same params)."""
    jcfg = jget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jm, tm = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    if f32:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


class _Routing:
    """Within the block, each call of the hybrid's ``moe_apply``, on the
    port and in the reference (also under ``jax.jit``), appends its
    tokens' top-K expert sets (sorted) and its router probabilities."""

    def __init__(self, monkeypatch):
        self.port, self.ref, self.port_p, self.ref_p = [], [], [], []
        t_inner, j_inner = thybrid.moe_apply, jhybrid.moe_apply

        def t_recorded(p, x, cfg):
            xf = x.reshape(-1, x.shape[-1])
            self.port_p.append(torch.softmax(xf.float() @ p["router"],
                                             dim=-1).numpy())
            self.port.append(np.sort(route(p, xf, cfg)[1].numpy(), -1))
            return t_inner(p, x, cfg)

        def j_recorded(p, x, cfg):
            probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
                jnp.float32) @ p["router"], axis=-1)
            jax.debug.callback(
                lambda pr, e: (self.ref_p.append(np.asarray(pr)),
                               self.ref.append(np.sort(np.asarray(e), -1))),
                probs, jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
            return j_inner(p, x, cfg)
        monkeypatch.setattr(thybrid, "moe_apply", t_recorded)
        monkeypatch.setattr(jhybrid, "moe_apply", j_recorded)

    def clear(self):
        for r in (self.port, self.ref, self.port_p, self.ref_p):
            r.clear()

    def gap(self, layer, tok, K):
        s = np.sort(self.port_p[layer][tok])[::-1]
        return float(s[K - 1] - s[K])

    def first_difference(self, K):
        """The least flat token index whose expert set differs in some
        layer (the number of tokens when none does); each differing
        choice there is a near-tie on the port's side, and the
        probabilities of the tokens before it differ by at most
        ``ROUTE_DIFF``."""
        n = self.port[0].shape[0]
        first = n
        for a, b in zip(self.port, self.ref):
            bad = np.nonzero((a != b).any(-1))[0]
            if bad.size:
                first = min(first, int(bad[0]))
        for layer, (a, b) in enumerate(zip(self.port, self.ref)):
            if first < n and (a[first] != b[first]).any():
                # its first differing layer (the later ones follow)
                assert self.gap(layer, first, K) <= ROUTE_TIE, (layer, first)
                break
        for a, b in zip(self.port_p, self.ref_p):
            assert np.abs(a[:first] - b[:first]).max(initial=0.0) \
                <= ROUTE_DIFF
        return first


def test_configs_and_schema_are_the_references():
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert dc.asdict(full) == dc.asdict(jfull)
    assert dc.asdict(full.reduced()) == dc.asdict(jfull.reduced())
    red = get_config(ARCH).reduced()
    assert (red.n_layers, red.attn_period, red.moe.n_experts,
            red.mamba.headdim, red.mamba.d_state) == (4, 4, 8, 16, 16)
    _, jp, tm, tp = _pair(f32=False)
    own = tm.init_params(torch.Generator().manual_seed(0), "cpu")
    flat = lambda t, pre="": sum(
        (flat(v, pre + k + ".") if isinstance(v, dict) else
         [(pre + k, tuple(v.shape), v.dtype)] for k, v in t.items()), [])
    assert sorted(flat(own)) == sorted(flat(tp))
    assert tp["periods"]["moe"]["gate"].shape == (1, 2, 8, 64, 32)
    assert tp["periods"]["mamba"]["in_proj"].shape[:2] == (1, 3)


def test_forward_and_prefill_match_reference_f32():
    """``hidden_states``, ``logits`` and ``prefill_step`` in float32: the
    routing is the reference's for every token."""
    jm, jp, tm, tp = _pair(f32=True)
    tok = _tokens(tm.cfg.vocab)
    jh = jm.hidden_states(jp, tokens=jnp.asarray(tok), remat=False,
                          interpret=True)
    jlog = jm.logits(jp, jh)
    before = dict(counts)
    th = tm.hidden_states(tp, tokens=torch.from_numpy(tok).long())
    tlog = tm.logits(tp, th)
    tpre = tserve.prefill_step(tm, tp, {"tokens": torch.from_numpy(tok)
                                        .long()})
    assert counts == before           # the CPU path launches no kernel
    assert th.dtype == torch.float32 and tlog.dtype == torch.float32
    assert tuple(tpre.shape) == (2, 1, tm.cfg.vocab)
    tol = dict(rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_f(th), _f(jh), **tol)
    np.testing.assert_allclose(_f(tlog), _f(jlog), **tol)
    np.testing.assert_allclose(_f(tpre), _f(jlog[:, -1:]), **tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_reference_bf16(seed, monkeypatch):
    """bf16 as shipped: hidden states and logits of every token before the
    first one routed otherwise (all of them where none is), and the
    prefill's last logits where no token is."""
    jm, jp, tm, tp = _pair(f32=False)
    rec = _Routing(monkeypatch)
    tok = _tokens(tm.cfg.vocab, seed=seed)
    jh = jm.hidden_states(jp, tokens=jnp.asarray(tok), remat=False,
                          interpret=True)
    jlog = jm.logits(jp, jh)
    jax.effects_barrier()
    th = tm.hidden_states(tp, tokens=torch.from_numpy(tok).long())
    tlog = tm.logits(tp, th)
    assert th.dtype == torch.bfloat16
    assert len(rec.port) == len(rec.ref) == 2
    B, T = tok.shape
    first = rec.first_difference(tm.cfg.moe.top_k)
    assert first > 0
    flat = lambda a: _f(a).reshape(B * T, -1)[:first]
    np.testing.assert_allclose(flat(th), flat(jh), **HIDDEN_TOL)
    np.testing.assert_allclose(flat(tlog), flat(jlog), **LOGITS_TOL)
    if first == B * T:
        rec.clear()
        tpre = tserve.prefill_step(tm, tp, {"tokens": torch.from_numpy(tok)
                                            .long()})
        np.testing.assert_allclose(_f(tpre), _f(jlog[:, -1:]), **LOGITS_TOL)


def _decode_both(jm, jp, tm, tp, js, ts, tok, rec):
    """Decode ``tok`` step by step on both sides; each step where both
    route every token alike is held to ``LOGITS_TOL``, until a step whose
    differing choice (a near-tie) went into the caches.  Returns the
    number of steps held and the states."""
    step = jax.jit(jm.decode_step)
    L = jm.n_moe * jm.n_periods
    held = 0
    for t in range(tok.shape[1]):
        rec.clear()
        jl, js = step(jp, jnp.asarray(tok[:, t:t + 1]), js)
        jax.effects_barrier()
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok[:, t:t + 1])
                                .long(), ts)
        assert len(rec.port) == len(rec.ref) == L
        verdict = "same"
        for layer, (a, b) in enumerate(zip(rec.port, rec.ref)):
            for i in np.nonzero((a != b).any(-1))[0]:
                assert rec.gap(layer, i, tm.cfg.moe.top_k) <= ROUTE_TIE
                verdict = "last" if layer == L - 1 else "stop"
        if verdict == "stop":
            break
        if verdict == "same":
            np.testing.assert_allclose(_f(tl), _f(jl), **LOGITS_TOL,
                                       err_msg=f"step {t}")
            held += 1
    return held, js, ts


def test_decode_steps_match_reference_bf16(monkeypatch):
    """8 decode steps of 3 slots from the zero state: the KV cache, the
    Mamba states and ``pos`` written in place."""
    jm, jp, tm, tp = _pair(f32=False)
    rec = _Routing(monkeypatch)
    B, T = 3, 8
    tok = _tokens(tm.cfg.vocab, B, T, seed=5)
    js = jm.init_decode_state(B, T + 4)
    ts = tm.init_decode_state(B, T + 4, device="cpu")
    assert len(ts.layers) == 1 and len(ts.layers[0]["mamba"]) == 3
    held, _, ts = _decode_both(jm, jp, tm, tp, js, ts, tok, rec)
    assert held >= 4


def test_decode_from_a_carried_state(monkeypatch):
    """The reference decodes 5 steps; its state, carried across by
    ``decode_state_from_numpy``, equals the port's own after the same
    steps where both routed alike, and both decode 4 more from it."""
    jm, jp, tm, tp = _pair(f32=False)
    rec = _Routing(monkeypatch)
    B = 3
    tok = _tokens(tm.cfg.vocab, B, 9, seed=6)
    js = jm.init_decode_state(B, 16)
    step = jax.jit(jm.decode_step)
    for t in range(5):
        _, js = step(jp, jnp.asarray(tok[:, t:t + 1]), js)
    ts = decode_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                 "cpu")
    assert int(ts.pos) == 5
    kv = ts.layers[0]["kv"]
    np.testing.assert_array_equal(kv.k.view(torch.int16).numpy(),
                                  np.asarray(js.layers["kv"].k[0])
                                  .view(np.int16))
    np.testing.assert_array_equal(ts.layers[0]["mamba"][2].h.numpy(),
                                  np.asarray(js.layers["mamba"].h[0, 2]))
    held, _, ts = _decode_both(jm, jp, tm, tp, js, ts, tok[:, 5:], rec)
    assert held >= 2


def test_decode_matches_forward_on_the_port_f32():
    """The decode wiring on the port alone: float32 weights and a
    capacity factor of 8, so that no assignment is dropped in the
    prefill or in a decode step; each step's logits against the
    forward's."""
    red = get_config(ARCH).reduced()
    cfg = dc.replace(red, moe=dc.replace(red.moe, capacity_factor=8.0))
    model = build_model(cfg)
    params = tree_map(lambda t: t.float(), model.init_params(
        torch.Generator().manual_seed(0), "cpu"))
    B, T = 2, 12
    tok = torch.from_numpy(_tokens(cfg.vocab, B, T, seed=7)).long()
    fwd = model.logits(params, model.hidden_states(params, tokens=tok))
    state = model.init_decode_state(B, T + 2, device="cpu")
    for t in range(T):
        lg, state = model.decode_step(params, tok[:, t:t + 1], state)
        np.testing.assert_allclose(lg[:, 0].numpy(), fwd[:, t].numpy(),
                                   rtol=0, atol=2e-2, err_msg=f"step {t}")
    assert int(state.pos) == T


def test_remat_gives_the_same_hidden_states_and_loss_raises():
    """Remat recomputes each period in the backward and changes no value:
    the hidden states and the loss (under grad, as training takes it)
    equal the plain forward's bit for bit."""
    cfg = get_config(ARCH).reduced()
    m = build_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(_tokens(cfg.vocab, 1, 20)).long()
    assert torch.equal(m.hidden_states(params, tokens=tok, remat=True),
                       m.hidden_states(params, tokens=tok))
    batch = {"tokens": tok, "labels": tok}
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        remat = m.loss_fn(ps, batch, remat=True)
    assert remat.requires_grad and remat.shape == ()
    assert torch.equal(remat.detach(), m.loss_fn(params, batch, remat=False))


def test_serve_main_runs_the_reduced_hybrid_on_cpu():
    """``serve.main`` with a variant config: the hybrid's waves on the
    CPU (its decode state reset per wave)."""
    cfg = get_config(ARCH).reduced()
    out = tserve.main(["--requests", "3", "--batch-slots", "2",
                       "--prompt-len", "4", "--gen-len", "5", "--max-seq",
                       "12", "--device", "cpu"], cfg=cfg)
    assert [len(o) for o in out] == [5, 5, 5]
    assert all(0 <= t < cfg.vocab for o in out for t in o)
    state = build_model(cfg).init_decode_state(2, 12, device="cpu")
    assert all(not bool(t.any()) for t in tree_leaves(state))
