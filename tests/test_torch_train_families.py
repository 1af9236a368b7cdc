"""Training of the moe, vlm, encdec and hybrid families on the CPU against
the JAX package: the bfloat16 ``random.normal_bf16`` and ``batch_for``
bit for bit; the loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn`` on the ``reduced()``
configs of qwen2-moe-a2.7b, qwen3-moe-30b-a3b, qwen2-vl-7b (its
``batch_for`` batch of ``embeds`` and ``positions``, and the tokens-only
batch the reference's driver gives it), whisper-base and jamba, with the
reference's parameters carried across (``models.convert``); remat on and
off; the zero gradient of a leaf the loss does not read; the MoE
backward's fold order; every architecture's train step on the CPU.

Tolerances are ``test_torch_train_step``'s, for the same reasons: float32
loss within 1e-5 and each gradient leaf within 1e-5 of its own max |grad|
(measured up to 1.7e-6; jamba's ``A_log``, whose gradient cancels as
mamba2-130m's does, within ``F32_CANCEL_TOL`` = 4e-5, measured 2.0e-5);
bfloat16 as shipped loss within 2e-3 (measured up to 4.6e-4) and each
leaf within 2^-4 of its own max |grad| (measured up to 0.049).

The reference's ``encode`` refuses float32 parameters
(``test_torch_encdec.py``), so whisper-base's float32 loss unrolls its
encoder from the reference's own functions (``_jencode``) and runs its
``decode_train`` and cross entropy as its ``loss_fn`` composes them.
That case runs the reference op by op, not jitted: under ``jax.jit`` XLA
keeps the encoder input's bfloat16 sum of frames and positions in
float32 (its excess precision), which moves the float32 loss by 2.2e-5;
op by op the reference rounds it as its code says, and so does the port
(the losses then agree to the last bit).

Routing in bfloat16: the reduced routers give probabilities near 1/E,
and the two programs' bf16 activations differ by a rounding step, so a
few tokens take another expert at a near-tie (``test_torch_hybrid.py``
shows each is one: 3 to 4 of jamba's 64 here), and the gradients then
differ by a token's share (up to 1.08 of a leaf's max |grad| in jamba;
qwen3-moe-30b-a3b's loss by 0.012 at the second of three steps).  The
bf16 cases of the MoE-bearing configs therefore run the reference with
the port's expert choices (``_GivenRouting``: its ``jax.lax.top_k``
returns the port's experts and the reference's own probabilities at
them), so the gradients are held with the routing alike.  The float32
cases route on their own (their probabilities agree to ~1e-7).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.data.synthetic import batch_for as jbatch_for
from repro.models import build_model as jbuild_model
from repro.models.common import unembed as junembed

from repro_torch import random as trandom
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.data import SyntheticLM, batch_for
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import AdamWCfg, adamw_init, make_train_step
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import tree_leaves

from test_torch_encdec import _jencode
from test_torch_train_step import (F32_CANCEL_TOL, GRAD_TOL, LOSS_TOL,
                                   _leaves_close, tensor_dtype)

torch.set_num_threads(1)

SEQ, BATCH = 32, 2
# (arch, batch): "batch_for" is the reference's batch_for (the vlm
# family's embeds, whisper's frames), "tokens" SyntheticLM's tokens
CASES = [("qwen2-moe-a2.7b", "tokens"), ("qwen3-moe-30b-a3b", "tokens"),
         ("qwen2-vl-7b", "batch_for"), ("qwen2-vl-7b", "tokens"),
         ("whisper-base", "batch_for"), ("jamba-1.5-large-398b", "tokens")]
IDS = [f"{a}-{b}" for a, b in CASES]


def _shape(step_seq=SEQ, batch=BATCH):
    return (JShapeCfg("t", step_seq, batch, "train"),
            ShapeCfg("t", step_seq, batch, "train"))


def _pair(arch, precision):
    """(reference model, its params, port model, the same params)."""
    jm = jbuild_model(jget_config(arch).reduced())
    tm = build_model(get_config(arch).reduced())
    jp = jm.init_params(jax.random.PRNGKey(0))
    if precision == "f32":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _batches(jm, tm, kind, step):
    if kind == "tokens":
        v = tm.cfg.vocab
        return (JSyntheticLM(v, SEQ, BATCH).batch(step),
                SyntheticLM(v, SEQ, BATCH).batch(step, device="cpu"))
    jshape, tshape = _shape()
    return (jbatch_for(jm.cfg, jshape, step),
            batch_for(tm.cfg, tshape, step, device="cpu"))


class _UnrolledEncDec:
    """The reference's whisper ``loss_fn`` with its encoder unrolled from
    its own functions (float32 parameters); ``make_train_step`` takes it
    as the model."""

    def __init__(self, jm):
        self.jm = jm

    def loss_fn(self, p, batch, impl=None, remat=True, unroll=False):
        enc = _jencode(self.jm, p, batch["frames"], f32=True)
        h = self.jm.decode_train(p, batch["tokens"], enc, remat=remat)
        logits = junembed(h, p["embed"].T)
        labels = batch["labels"]
        mask = (labels >= 0).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.maximum(labels, 0)[..., None],
                                   axis=-1)[..., 0]
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)


def _jmodel(jm, precision):
    """(the reference's model, or its unrolled whisper, and the jit its
    step runs under: none for the unrolled whisper, see the module doc)."""
    if jm.cfg.family == "encdec" and precision == "f32":
        return _UnrolledEncDec(jm), lambda f: f
    return jm, jax.jit


class _GivenRouting:
    """The reference's ``jax.lax.top_k``, within ``patched()``, gives the
    experts the port's MoE layers chose on the parameters and batch of
    the last ``record()`` (a forward without remat), and the reference's
    own probabilities at them.  Each call, at run time (a host callback,
    so the forward, the remat recompute and every layer of a scan take
    their own), finds its layer as the recorded one whose probabilities
    lie nearest its own (within ``ROUTE_MATCH``; the layers' differ by
    far more)."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.layers = []
        self.calls = 0

    def record(self, tm, tp, tb):
        self.layers.clear()
        inner = tmoe.route

        def recorded(p, xf, cfg):
            probs = torch.softmax(xf.float() @ p["router"], dim=-1)
            out = inner(p, xf, cfg)
            self.layers.append((probs.numpy(),
                                out[1].numpy().astype(np.int32)))
            return out
        self.mp.setattr(tmoe, "route", recorded)
        with torch.no_grad():
            tm.loss_fn(tp, tb, remat=False)
        self.mp.setattr(tmoe, "route", inner)

    def _choices(self, probs):
        probs = np.asarray(probs)
        dist = [float(np.abs(probs - p).max()) for p, _ in self.layers]
        i = int(np.argmin(dist))
        assert dist[i] <= ROUTE_MATCH, dist
        self.calls += 1
        return self.layers[i][1]

    @contextlib.contextmanager
    def patched(self):
        def given(operand, k):
            e = jax.pure_callback(
                self._choices,
                jax.ShapeDtypeStruct((operand.shape[0], k), jnp.int32),
                jax.lax.stop_gradient(operand))
            return jnp.take_along_axis(operand, e, axis=-1), e
        with self.mp.context() as m:
            m.setattr(jax.lax, "top_k", given)
            yield


# a reference call's router probabilities against the port's of its own
# layer: within a few bf16 steps of the activations (measured 1.1e-3 in
# test_torch_hybrid.py); another layer's lie 0.1 or more away
ROUTE_MATCH = 2e-2


def _needs_given(tm, precision):
    return tm.cfg.moe is not None and precision == "bf16"


# ---------------------------------------------------------------------------
# the bfloat16 normal draw and batch_for
# ---------------------------------------------------------------------------

def _jax_bf16_chain(byte):
    """The reference's bf16 ``normal`` from the random byte, as
    ``jax.make_jaxpr(jax.random.normal(key, shape, jnp.bfloat16))``
    spells it (``_uniform``, ``erf_inv``, the product by sqrt(2))."""
    j = byte.astype(jnp.uint16)
    m = jax.lax.bitcast_convert_type((j >> 1) | jnp.uint16(0x3F80),
                                     jnp.bfloat16) - jnp.bfloat16(1)
    lo, hi = jnp.bfloat16(-0.99609375), jnp.bfloat16(1.0)
    u = jnp.maximum(lo, m * (hi - lo) + lo)
    return jnp.bfloat16(1.4140625) * jax.lax.erf_inv(u)


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_normal_bf16_table_is_the_references_for_every_byte():
    """All 256 values of the random byte through the reference's chain
    (jitted, as its draw runs) against the port's table, bit for bit."""
    want = np.asarray(jax.jit(_jax_bf16_chain)(
        np.arange(256, dtype=np.uint8))).view(np.uint16)
    got = _u16(trandom._bf16_normal_table("cpu"))
    np.testing.assert_array_equal(got, want)
    vals = np.unique(got.view(jnp.bfloat16).astype(np.float32))
    assert len(vals) == 128 and vals[0] == -2.890625 and vals[-1] == 2.515625


@pytest.mark.parametrize("seed,step,shape", [(0, 0, (4, 4096)),
                                             (7, 3, (3, 5, 77))])
def test_normal_bf16_draw_is_the_references(seed, step, shape):
    """A seeded draw, bit for bit with ``jax.random.normal(key, shape,
    jnp.bfloat16)`` (JAX's default, partitionable threefry)."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    want = np.asarray(jax.random.normal(jkey, shape, jnp.bfloat16))
    key = trandom.fold_in(trandom.PRNGKey(seed), step)
    got = trandom.normal_bf16(key, shape, device="cpu")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_u16(got), want.view(np.uint16))


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-base"])
def test_batch_for_is_the_references(arch, step):
    jshape, tshape = _shape(24, 3)
    want = jbatch_for(jget_config(arch).reduced(), jshape, step, seed=11)
    got = batch_for(get_config(arch).reduced(), tshape, step, seed=11,
                    device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_u16(g), w.view(np.uint16),
                                          err_msg=k)
        else:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_loss_and_gradients_match_reference(arch, kind, precision,
                                            monkeypatch):
    jm, jp, tm, tp = _pair(arch, precision)
    jb, tb = _batches(jm, tm, kind, 0)
    jmod, jit = _jmodel(jm, precision)
    if _needs_given(tm, precision):
        given = _GivenRouting(monkeypatch)
        given.record(tm, tp, tb)
        with given.patched():
            jl, jg = jit(jax.value_and_grad(
                lambda p: jmod.loss_fn(p, jb)))(jp)
        assert given.calls >= tm.cfg.n_layers // 2
    else:
        jl, jg = jit(jax.value_and_grad(lambda p: jmod.loss_fn(p, jb)))(jp)
    tl, tg = value_and_grad(tm, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl) - float(jl)) <= LOSS_TOL[precision]
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tg)):
        assert b.dtype == tensor_dtype(a)
    _leaves_close(jg, tg, GRAD_TOL[precision],
                  per_leaf=F32_CANCEL_TOL if precision == "f32" else None)


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_remat_gives_the_same_gradients(arch, kind):
    jm, _, tm, tp = _pair(arch, "bf16")
    _, tb = _batches(jm, tm, kind, 1)
    la, ga = value_and_grad(tm, tp, tb, remat=True)
    lb, gb = value_and_grad(tm, tp, tb, remat=False)
    assert torch.equal(la, lb)
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        assert torch.equal(a, b)


def test_unused_leaf_gets_a_zero_gradient_and_weight_decay():
    """The vlm family fed ``embeds`` reads its embedding table's type
    only: its gradient is zero, as ``jax.grad`` gives it, and the step
    moves it by AdamW's weight decay alone, to the reference's bits."""
    jm, jp, tm, tp = _pair("qwen2-vl-7b", "f32")
    jb, tb = _batches(jm, tm, "batch_for", 0)
    _, tg = value_and_grad(tm, tp, tb)
    assert torch.equal(tg["embed"], torch.zeros_like(tp["embed"]))
    from repro.train.optimizer import AdamWCfg as JAdamWCfg
    from repro.train.optimizer import adamw_init as jadamw_init
    from repro.train.train_step import make_train_step as jmake_train_step
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jnew, _, _ = jax.jit(jmake_train_step(jm, JAdamWCfg(**cfg)))(
        jp, jadamw_init(jp), jb)
    new, opt, _ = make_train_step(tm, AdamWCfg(**cfg))(
        tp, adamw_init(tp), tb)
    assert not torch.equal(new["embed"], tp["embed"])
    np.testing.assert_array_equal(new["embed"].numpy(),
                                  np.asarray(jnew["embed"]))
    assert not bool(opt.mu["embed"].any()) and not bool(
        opt.nu["embed"].any())


# ---------------------------------------------------------------------------
# the MoE backward's order
# ---------------------------------------------------------------------------

def _dispatch_case(n_tok=40, E=6, K=3, d=5, seed=0):
    """Tables of ``dispatch`` for a routing with drops: tokens prefer the
    low experts, so their segments overflow the capacity."""
    r = np.random.default_rng(seed)
    logits = r.normal(size=(n_tok, E)) - np.arange(E) * 0.7
    top_e = torch.from_numpy(np.argsort(-logits, axis=1, kind="stable")
                             [:, :K].copy())
    cap = tmoe.capacity(n_tok, tmoe.MoECfg(E, K, 8, capacity_factor=0.6))
    order, _, slot, tok_of_slot, live = tmoe.dispatch(top_e, cap, E)
    _, rows, dropped = tmoe.assignment_slots(order, slot, top_e, E * cap)
    return top_e, cap, tok_of_slot, live, rows, dropped, r


def test_moe_gather_backward_folds_in_ascending_expert_order():
    """A float64 mirror: each token's gradient is its kept slots' rows
    added to 0.0 one after another in ascending slot (= expert) order,
    the reference's serial scatter-add; dropped assignments add nothing.
    Held bit for bit (another order moves the float64 sums by an ulp)."""
    top_e, cap, tok_of_slot, live, rows, dropped, r = _dispatch_case()
    n_tok, K = top_e.shape
    E = int(live.numel()) // cap
    assert bool(dropped.any()) and not bool(dropped.all())
    x = torch.from_numpy(r.normal(size=(n_tok, 5))).requires_grad_(True)
    g = torch.from_numpy(r.normal(size=(E * cap, 5)) * 10.0 ** r.integers(
        -6, 6, size=(E * cap, 1)))
    xe = tmoe.gather_tokens(x, tok_of_slot, live, rows, dropped)
    np.testing.assert_array_equal(
        xe.detach().numpy(),
        np.where(live.numpy()[:, None], x.detach().numpy()[
            tok_of_slot.numpy()], 0.0))
    (gx,) = torch.autograd.grad(xe, x, g)
    want = np.zeros((n_tok, 5))
    tos, lv, gn = tok_of_slot.numpy(), live.numpy(), g.numpy()
    for s in range(E * cap):               # ascending slot: ascending expert
        if lv[s]:
            want[tos[s]] = want[tos[s]] + gn[s]
    np.testing.assert_array_equal(gx.numpy(), want)
    # autograd's own gather backward: the same sums up to their order
    x2 = x.detach().clone().requires_grad_(True)
    plain = x2.index_select(0, tok_of_slot) * live[:, None]
    (gp,) = torch.autograd.grad(plain, x2, g)
    np.testing.assert_allclose(gx.numpy(), gp.numpy(), rtol=1e-12,
                               atol=1e-12 * float(np.abs(gn).max()))


def test_moe_dropped_assignments_get_no_gradient():
    """The router weight of a dropped assignment gets a zero gradient
    (the reference's ``mode="drop"``): only the kept assignments' weights
    reach the output."""
    cfg = tmoe.MoECfg(n_experts=4, top_k=2, d_expert=8, capacity_factor=0.5)
    g = torch.Generator().manual_seed(1)
    p = {"router": torch.randn(6, 4, generator=g),
         "gate": torch.randn(4, 6, 8, generator=g),
         "up": torch.randn(4, 6, 8, generator=g),
         "down": torch.randn(4, 8, 6, generator=g)}
    x = torch.randn(1, 20, 6, generator=g)
    xf = x.reshape(20, 6)
    top_p, top_e = tmoe.route(p, xf, cfg)
    cap = tmoe.capacity(20, cfg)
    order, keep, slot, _, _ = tmoe.dispatch(top_e, cap, 4)
    _, _, dropped = tmoe.assignment_slots(order, slot, top_e, 4 * cap)
    assert bool(dropped.any())
    tp = top_p.detach().requires_grad_(True)
    monkey = tmoe.route
    try:
        tmoe.route = lambda *a: (tp, top_e)
        out = tmoe.moe_apply(p, x, cfg)
    finally:
        tmoe.route = monkey
    (gw,) = torch.autograd.grad(out.sum(), tp)
    by_e = torch.argsort(top_e, dim=-1)
    gw_by_e = torch.gather(gw, 1, by_e)
    assert bool((gw_by_e[dropped] == 0).all())
    assert bool((gw_by_e[~dropped] != 0).all())


# ---------------------------------------------------------------------------
# every architecture trains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_trains_on_the_cpu(arch):
    """``loss_fn`` and ``make_train_step`` on each architecture's reduced
    config, on ``batch_for``'s batch: a finite loss and gradient norm,
    every parameter moved or left by a zero gradient, the moments'
    step counted."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    batch = batch_for(cfg, _shape(16, 2)[1], 0, device="cpu")
    step = make_train_step(model, AdamWCfg(lr=1e-3, warmup_steps=1,
                                           total_steps=4))
    new, opt, m = step(params, adamw_init(params), batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert int(opt.step) == 1
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                    tree_leaves(new))]
    assert sum(moved) >= len(moved) - 1
