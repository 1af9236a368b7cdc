"""The port's MoE layer (``repro_torch.models.moe``) and the ``moe`` family
of its LM (qwen3-moe-30b-a3b, qwen2-moe-a2.7b at their ``reduced()``
sizes) on the CPU against the JAX package, with the reference's
parameters carried across by ``models.convert``.

Tolerances (max abs error; the model-level ones are
``test_torch_models``'s and hold for the same reasons):
  * the routing and dispatch tables (``top_e``, ``order``, ``keep``,
    ``slot``, ``tok_of_slot``, ``live``): exact, against ``lax.top_k`` and
    a numpy emulation of the reference's dispatch;
  * ``moe_apply`` in float32 (parameters and input float32 on both
    sides): 1e-5 (the sums of the products in another order);
  * ``moe_apply`` in bfloat16 as shipped: 2.5e-2 relative + 5e-2
    absolute, the bf16 hidden-state tolerance (a bf16 rounding of the
    experts' products, which XLA and PyTorch may round at other points);
  * the dense-mixture oracle (capacity factor 8, nothing dropped): 1e-5;
  * the reduced LMs' forward, ``prefill_step``, 8 decode steps and the
    serve waves: F32 1e-5, bf16 hidden 2.5e-2 / 5e-2, logits and decode
    2e-2.  In bf16 decode a routing choice may differ between the two
    programs only at a near-tie (``ROUTE_TIE``); the logits are held
    wherever both route every token alike, and greedy tokens wherever
    the top-2 margin exceeds twice the tolerance.
"""
import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jt
from repro.models.common import initialize as jinitialize
from repro.models.moe import MoECfg as JMoECfg
from repro.models.moe import moe_apply as jmoe_apply
from repro.models.moe import moe_schema as jmoe_schema

from repro_torch.configs import get_config
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import transformer as tt
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.moe import (MoECfg, capacity, dispatch, moe_apply,
                                    moe_schema, route)

from test_torch_models import (BF16_LOGITS_TOL, DECODE_TOL, F32_TOL, _f,
                               _pair, _tensor, _tokens)

torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"]
BF16_TOL = dict(rtol=2.5e-2, atol=5e-2)
# a near-tie: a gap between a token's K-th and (K+1)-th router
# probability that the two programs' bf16 hidden states (a bf16 rounding
# apart here and there) may close.  Measured on the reduced models'
# decode: the two programs' router probabilities differ by up to 2.6e-4,
# so a gap up to twice that may flip
ROUTE_TIE = 5.2e-4
D, F_EXPERT = 32, 16


def _layer(cfg: MoECfg, f32: bool, seed=0, d=D):
    """(reference params, port params) of one MoE layer."""
    jcfg = JMoECfg(**dc.asdict(cfg))
    jp = jinitialize(jmoe_schema(d, jcfg), jax.random.PRNGKey(seed))
    if f32:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    return jcfg, jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _x(shape, f32: bool, seed=1):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if not f32:
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return x


def _both(jp, tp, jcfg, cfg, x):
    want = jmoe_apply(jp, jnp.asarray(x), jcfg)
    got = moe_apply(tp, _tensor(x), cfg)
    assert got.dtype == _tensor(x).dtype and got.shape == x.shape
    return _f(got), _f(want)


def _emulate(top_e: np.ndarray, cap: int, E: int):
    """numpy's reading of the reference's dispatch (``moe.py:64-87``)."""
    n_tok, K = top_e.shape
    flat_e = top_e.reshape(-1)
    flat_t = np.repeat(np.arange(n_tok), K)
    order = np.argsort(flat_e, kind="stable")
    se, st = flat_e[order], flat_t[order]
    counts = np.bincount(se, minlength=E)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_in_e = np.arange(n_tok * K) - offsets[se]
    keep = pos_in_e < cap
    slot = np.where(keep, se * cap + pos_in_e, E * cap)
    tok_of_slot = np.zeros(E * cap + 1, np.int64)
    live = np.zeros(E * cap + 1, bool)
    for i in range(n_tok * K):     # .at[slot].set: the sentinel row drops
        tok_of_slot[slot[i]] = st[i]
        live[slot[i]] = keep[i]
    return order, keep, slot, tok_of_slot[:-1], live[:-1]


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_moe_apply_matches_reference(precision, norm, shared):
    """Capacity factor 1.25 at 48 tokens: some assignments drop."""
    f32 = precision == "f32"
    cfg = MoECfg(n_experts=8, top_k=2, d_expert=F_EXPERT, norm_topk=norm,
                 n_shared=int(shared), d_shared=64 if shared else 0)
    jcfg, jp, tp = _layer(cfg, f32)
    x = _x((2, 24, D), f32)
    got, want = _both(jp, tp, jcfg, cfg, x)
    tol = dict(rtol=F32_TOL, atol=F32_TOL) if f32 else BF16_TOL
    np.testing.assert_allclose(got, want, **tol)
    # the same routing on both sides
    xf = _tensor(x).reshape(-1, D)
    _, top_e = route(tp, xf, cfg)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, D).astype(jnp.float32)
                           @ jp["router"], axis=-1)
    np.testing.assert_array_equal(
        top_e.numpy(), np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]))


def _oracle(p, x: torch.Tensor, cfg: MoECfg) -> torch.Tensor:
    """Dense mixture: every expert on every token, the top k combined."""
    xf = x.reshape(-1, x.shape[-1])
    top_p, top_e = route(p, xf, cfg)
    h = torch.nn.functional.silu(torch.einsum("nd,edf->enf", xf, p["gate"])) \
        * torch.einsum("nd,edf->enf", xf, p["up"])
    ye = torch.einsum("enf,efd->end", h, p["down"])
    out = torch.zeros_like(xf, dtype=torch.float32)
    for k in range(cfg.top_k):
        sel = ye[top_e[:, k], torch.arange(xf.shape[0])]
        out = out + top_p[:, k, None] * sel.float()
    return out.reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("E,K,norm", [(8, 2, True), (16, 4, False)])
def test_moe_without_drops_is_the_dense_mixture(E, K, norm):
    cfg = MoECfg(n_experts=E, top_k=K, d_expert=64, capacity_factor=8.0,
                 norm_topk=norm)
    jcfg, jp, tp = _layer(cfg, f32=True)
    x = _x((2, 24, D), True, seed=2)
    n_tok = 48
    _, top_e = route(tp, _tensor(x).reshape(-1, D), cfg)
    _, keep, _, _, _ = dispatch(top_e, capacity(n_tok, cfg), E)
    assert bool(keep.all())
    got = moe_apply(tp, _tensor(x), cfg)
    np.testing.assert_allclose(_f(got), _f(_oracle(tp, _tensor(x), cfg)),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(_f(got), _f(jmoe_apply(jp, jnp.asarray(x),
                                                      jcfg)),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_skewed_router_drops_as_the_reference(precision):
    """A router that sends most tokens to experts 0 and 1: far more
    assignments than their capacity, so most drop, in the reference's
    order (the later tokens of each expert's segment)."""
    f32 = precision == "f32"
    cfg = MoECfg(n_experts=8, top_k=2, d_expert=F_EXPERT, n_shared=1,
                 d_shared=64)
    jcfg, jp, tp = _layer(cfg, f32)
    bias = np.zeros((D, 8), np.float32)
    bias[:, :2] = 0.5
    jp = dict(jp, router=jp["router"] + jnp.asarray(bias))
    tp = dict(tp, router=tp["router"] + torch.from_numpy(bias))
    x = np.abs(_x((1, 64, D), f32, seed=3))      # positive: the bias wins
    _, top_e = route(tp, _tensor(x).reshape(-1, D), cfg)
    cap = capacity(64, cfg)
    _, keep, _, _, live = dispatch(top_e, cap, 8)
    assert int(keep.sum()) < 64 * 2 // 2 and int(live.sum()) == \
        int(keep.sum())
    got, want = _both(jp, tp, jcfg, cfg, x)
    tol = dict(rtol=F32_TOL, atol=F32_TOL) if f32 else BF16_TOL
    np.testing.assert_allclose(got, want, **tol)


def test_zero_router_takes_the_lowest_indices():
    """All probabilities equal: ``lax.top_k`` takes experts 0..K-1 for
    every token, and so must the port."""
    cfg = MoECfg(n_experts=16, top_k=4, d_expert=F_EXPERT, norm_topk=False)
    jcfg, jp, tp = _layer(cfg, f32=True)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x((2, 10, D), True, seed=4)
    top_p, top_e = route(tp, _tensor(x).reshape(-1, D), cfg)
    want_e = np.broadcast_to(np.arange(4), (20, 4))
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(jnp.full((20, 16), 1 / 16), 4)[1]), want_e)
    np.testing.assert_array_equal(top_p.numpy(), np.full((20, 4), 1 / 16,
                                                         np.float32))
    got, want = _both(jp, tp, jcfg, cfg, x)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("n_tok,E,K,cf", [
    (4, 128, 8, 1.25),        # qwen3-moe decode: cap 1, most collide
    (4, 60, 4, 1.25),         # qwen2-moe decode
    (300, 128, 8, 1.25),      # prefill-like
    (48, 8, 2, 0.25),         # tight
    (48, 8, 2, 8.0),          # loose
])
def test_dispatch_tables_are_the_emulation(n_tok, E, K, cf):
    cfg = MoECfg(n_experts=E, top_k=K, d_expert=8, capacity_factor=cf)
    r = np.random.default_rng(n_tok + E)
    # routed by a skewed random router, so the segments differ in length
    probs = r.dirichlet(np.linspace(0.2, 2.0, E), size=n_tok).astype(
        np.float32)
    top_e = torch.sort(torch.from_numpy(probs), dim=-1, descending=True,
                       stable=True)[1][:, :K]
    np.testing.assert_array_equal(
        top_e.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(probs), K)[1]))
    cap = capacity(n_tok, cfg)
    assert cap == int(max(1, -(-n_tok * K * cf // E)))
    got = dispatch(top_e, cap, E)
    want = _emulate(top_e.numpy(), cap, E)
    for name, g, w in zip(("order", "keep", "slot", "tok_of_slot", "live"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if cf < 1.25 or E == 128:
        assert not bool(got[1].all())      # the case drops something


def test_schema_is_the_references():
    cfg = MoECfg(n_experts=8, top_k=2, d_expert=F_EXPERT, n_shared=1,
                 d_shared=64)
    _, jp, tp = _layer(cfg, f32=False)
    own = moe_schema(D, cfg)
    for k in ("router", "gate", "up", "down", "shared_gate"):
        assert own[k].shape == tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert own[k].dtype == tp[k].dtype, k
    assert tp["router"].dtype == tp["shared_gate"].dtype == torch.float32
    assert tp["gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the moe family of the LM
# ---------------------------------------------------------------------------

def test_configs_are_the_references():
    for arch in ARCHS:
        assert dc.asdict(get_config(arch)) == dc.asdict(jget_config(arch))
        assert dc.asdict(get_config(arch).reduced()) == \
            dc.asdict(jget_config(arch).reduced())


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, precision):
    f32 = precision == "f32"
    jm, jp, tm, tp = _pair(arch, f32=f32)
    tok = _tokens(tm.cfg.vocab)
    jh = jm.hidden_states(jp, tokens=jnp.asarray(tok), remat=False)
    jlog = jm.logits(jp, jh)
    before = dict(counts)
    th = tm.hidden_states(tp, tokens=torch.from_numpy(tok).long())
    tlog = tm.logits(tp, th)
    tpre = tserve.prefill_step(tm, tp, {"tokens": torch.from_numpy(tok)
                                        .long()})
    assert counts == before
    assert tuple(tpre.shape) == (2, 1, tm.cfg.vocab)
    if f32:
        h_tol = l_tol = dict(rtol=F32_TOL, atol=F32_TOL)
    else:
        h_tol = BF16_TOL
        l_tol = dict(rtol=BF16_LOGITS_TOL, atol=BF16_LOGITS_TOL)
    np.testing.assert_allclose(_f(th), _f(jh), **h_tol)
    np.testing.assert_allclose(_f(tlog), _f(jlog), **l_tol)
    np.testing.assert_allclose(_f(tpre), _f(jlog[:, -1:]), **l_tol)


def _record_routing(monkeypatch):
    """From now on each call of the LM's ``moe_apply``, on the port and in
    the reference (also inside ``jax.jit``), appends its tokens' top-K
    experts to a list; the port's calls also append their least gap
    between a token's K-th and (K+1)-th router probability."""
    port, gaps, ref = [], [], []
    t_inner, j_inner = tt.moe_apply, jt.moe_apply

    def t_recorded(p, x, cfg):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"], dim=-1)
        s = torch.sort(probs, dim=-1, descending=True).values
        gaps.append(float((s[:, cfg.top_k - 1] - s[:, cfg.top_k]).min()))
        port.append(route(p, x.reshape(-1, x.shape[-1]), cfg)[1].numpy())
        return t_inner(p, x, cfg)

    def j_recorded(p, x, cfg):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
            jnp.float32) @ p["router"], axis=-1)
        jax.debug.callback(lambda e: ref.append(np.asarray(e)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return j_inner(p, x, cfg)
    monkeypatch.setattr(tt, "moe_apply", t_recorded)
    monkeypatch.setattr(jt, "moe_apply", j_recorded)
    return port, gaps, ref


def _step_routing_agrees(port, gaps, ref, i, L):
    """Step ``i``'s routing (layers ``i*L .. i*L+L-1`` of the records):
    "same" where the port and the reference route every token to the
    same experts,
    else "last" where only the last layer differs (that step's logits
    differ, the caches do not), else "stop" (an earlier layer's output
    went into the caches).  Every differing choice must be a near-tie
    on the port's side."""
    verdict = "same"
    for layer in range(L):
        # the order of a token's K experts changes nothing but the
        # rounding of the norm_topk sum: the sets are compared
        a, b = (np.sort(r[i * L + layer], axis=-1) for r in (port, ref))
        if not np.array_equal(a, b):
            assert gaps[i * L + layer] <= ROUTE_TIE, (i, layer, a, b)
            verdict = "last" if layer == L - 1 else "stop"
            if verdict == "stop":
                break
    return verdict


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_bf16(arch, monkeypatch):
    """8 decode steps of 3 slots: capacity is 1 slot an expert, as in
    the full models' decode, so colliding choices drop, as in the
    reference.  Each step where both route every token alike is held
    to the tolerance; a choice may differ only at a near-tie."""
    jm, jp, tm, tp = _pair(arch, f32=False)
    B, T, L = 3, 8, tm.cfg.n_layers
    tok = _tokens(tm.cfg.vocab, B, T, seed=5)
    assert capacity(B, tm.cfg.moe) == 1
    js = jm.init_decode_state(B, T + 4)
    ts = tm.init_decode_state(B, T + 4, device="cpu")
    port, gaps, ref = _record_routing(monkeypatch)
    step = jax.jit(jm.decode_step)
    checked = 0
    for t in range(T):
        jl, js = step(jp, jnp.asarray(tok[:, t:t + 1]), js)
        jax.effects_barrier()
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok[:, t:t + 1])
                                .long(), ts)
        assert ts.pos == t + 1 and len(port) == len(ref) == (t + 1) * L
        verdict = _step_routing_agrees(port, gaps, ref, t, L)
        if verdict == "stop":
            break
        if verdict == "same":
            np.testing.assert_allclose(_f(tl), _f(jl), rtol=DECODE_TOL,
                                       atol=DECODE_TOL, err_msg=f"step {t}")
            checked += 1
    assert checked >= 1


def _reference_waves(jm, jp, prompts, B, prompt_len, gen_len, max_seq):
    """The reference's ``serve.main`` loop (greedy) on a given model."""
    decode = jax.jit(jm.decode_step)
    outputs = []
    for w0 in range(0, len(prompts), B):
        wave = prompts[w0:w0 + B]
        state = jm.init_decode_state(B, max_seq)
        cur = np.zeros((B, 1), np.int32)
        cur[:len(wave), 0] = [p[0] for p in wave]
        gen = [[] for _ in wave]
        for t in range(1, prompt_len + gen_len):
            logits, state = decode(jp, jnp.asarray(cur), state)
            nxt = np.asarray(jnp.argmax(logits[:, 0], -1), np.int32)
            for s in range(len(wave)):
                cur[s, 0] = wave[s][t] if t < prompt_len else nxt[s]
                if t >= prompt_len:
                    gen[s].append(int(nxt[s]))
        outputs.extend(gen)
    return outputs


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_waves_match_reference_greedy(arch, monkeypatch):
    """Two waves of 4 slots (one part-filled).  The reference, fed the
    port's tokens, gives the port's logits at each step where both route
    alike (a choice may differ only at a near-tie) and, wherever its
    top-2 margin exceeds twice the tolerance, the port's greedy token.
    The reference's own greedy run gives the port's tokens up to the
    first step where some slot's margin is that narrow or the routing
    differs (the slots share the experts' capacity: one slot's flip
    changes the others' batch)."""
    jm, jp, tm, tp = _pair(arch, f32=False)
    P, G, S, B, L = 6, 8, 16, 4, tm.cfg.n_layers
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, P).astype(np.int32)
               for _ in range(6)]
    want = _reference_waves(jm, jp, prompts, B, P, G, S)
    port, gaps, ref = _record_routing(monkeypatch)
    record = []
    got, n_tok = tserve.serve_waves(tm, tp, prompts, batch_slots=B,
                                    prompt_len=P, gen_len=G, max_seq=S,
                                    device="cpu", record=record)
    assert n_tok == 4 * 13 + 2 * 13 and len(port) == 26 * L
    step = jax.jit(jm.decode_step)
    checked = 0
    for w in range(2):
        n = len(prompts[4 * w:4 * w + 4])
        seq = np.zeros((4, P + G), np.int32)
        for s in range(n):
            seq[s, :P] = prompts[4 * w + s]
            seq[s, P:] = got[4 * w + s]
        js = jm.init_decode_state(4, S)
        free_running = True
        for t in range(13):
            i = 13 * w + t
            lg, js = step(jp, jnp.asarray(seq[:, t:t + 1]), js)
            jax.effects_barrier()
            verdict = _step_routing_agrees(port, gaps, ref, i, L)
            free_running = free_running and verdict == "same"
            if verdict == "stop":
                break
            if verdict == "last":
                continue
            lg = np.asarray(lg[:, 0])
            np.testing.assert_allclose(_f(record[i]), lg, rtol=DECODE_TOL,
                                       atol=DECODE_TOL)
            if t < P - 1:
                continue
            wide = [np.diff(np.sort(lg[s])[-2:])[0] > 2 * DECODE_TOL
                    for s in range(n)]
            for s in range(n):
                if wide[s]:
                    assert got[4 * w + s][t - P + 1] == int(lg[s].argmax())
                    checked += 1
            free_running = free_running and all(wide)
            if free_running:
                assert [got[4 * w + s][t - P + 1] for s in range(n)] == \
                    [want[4 * w + s][t - P + 1] for s in range(n)]
    assert checked > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_on_the_port(arch):
    """The twin of ``test_model_semantics.test_decode_matches_forward``
    for the moe family (capacity factor 8, so nothing drops in either
    program), on the port alone, with its bounds."""
    cfg = get_config(arch).reduced()
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    B, T = 1, 12
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, T)))
    fwd = model.logits(params, model.hidden_states(params, tokens=tokens))
    state = model.init_decode_state(B, T + 2, device="cpu")
    dec = []
    for t in range(T):
        lg, state = model.decode_step(params, tokens[:, t:t + 1], state)
        dec.append(lg[:, 0])
    a = torch.softmax(torch.stack(dec, 1), -1).numpy()
    b = torch.softmax(fwd, -1).numpy()
    assert np.abs(a - b).max() < 2e-2
    assert (a.argmax(-1) == b.argmax(-1)).mean() == 1.0
