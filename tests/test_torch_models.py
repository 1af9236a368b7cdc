"""The port's model-zoo serving path (``repro_torch.models``,
``repro_torch.launch.serve``) on the CPU against the JAX package, for the
``dense`` (qwen3-0.6b, granite-20b, phi3-medium-14b, internlm2-1.8b) and
``ssm`` (mamba2-130m) families at their ``reduced()`` sizes (the ``moe``
family: ``test_torch_moe.py``; the hybrid: ``test_torch_hybrid.py``),
with the reference's parameters carried
across by ``models.convert``.  The reference's Mamba forward runs its SSD
Pallas kernel in interpret mode; its attention runs its jnp reference
(as its own model tests do on the CPU).

Tolerances (measured on this path, max abs error over the outputs):
  * float32 (the reference's parameters cast to float32 on both sides, so
    the whole forward stays float32): 1e-5, against measured ~2.4e-6 on
    the hidden states and ~5e-7 on the logits (the sums are taken in
    another order);
  * bfloat16 as shipped: the mixers' outputs (magnitude up to ~5) within
    2e-2 relative + 4e-2 absolute, against measured 0 (attention) and
    0.031 (Mamba: one bf16 step at that magnitude); hidden states
    (magnitude up to ~4 after the final norm) within 2.5e-2 relative +
    5e-2 absolute, against measured 0.039 max abs (one or two bf16
    rounding steps of the residual stream, whose magnitude reaches ~8
    before the norm); the logits (f32 from bf16
    hidden states, magnitude ~0.7) within 2e-2, against measured 0.008;
  * decode in bfloat16: each step's logits within 2e-2 (measured 0.005),
    greedy tokens equal wherever the reference's top-2 margin exceeds
    twice that.
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
from repro.models.common import rmsnorm as jrmsnorm
from repro.models.mamba2 import mamba_apply as jmamba_apply

from repro_torch import random as trnd
from repro_torch.configs import ARCH_IDS, PORTED, get_config
from repro_torch.kernels import counts
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models.attention import attn_apply
from repro_torch.models.common import rmsnorm
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.mamba2 import mamba_apply

torch.set_num_threads(1)

ARCHS = ["qwen3-0.6b", "mamba2-130m", "granite-20b", "phi3-medium-14b",
         "internlm2-1.8b"]
F32_TOL = 1e-5
MIXER_BF16_TOL = dict(rtol=2e-2, atol=4e-2)
BF16_LOGITS_TOL = 2e-2
DECODE_TOL = 2e-2


def _pair(arch, f32: bool):
    """(reference model, its params, port model, the same params)."""
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert dc.asdict(cfg)["mamba"] == dc.asdict(jcfg)["mamba"]
    jm, tm = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    if f32:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def _tokens(vocab, B=2, T=40, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _tensor(a):
    """A numpy array (bfloat16 included) as a CPU tensor."""
    return tensor_from_numpy(a, device="cpu")


def _f(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def test_convert_carries_bf16_bit_for_bit():
    jm, jp, tm, tp = _pair("qwen3-0.6b", f32=False)
    a = np.asarray(jp["embed"])
    assert a.dtype.name == "bfloat16"
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["embed"].view(torch.int16).numpy(),
                                  a.view(np.int16))
    assert tp["layers"]["attn"]["wq"].shape == jp["layers"]["attn"]["wq"]\
        .shape
    # the port's own schema has the same tree, shapes and types
    gen = torch.Generator().manual_seed(0)
    own = tm.init_params(gen, "cpu")
    flat = lambda t, pre="": sum(
        (flat(v, pre + k + ".") if isinstance(v, dict) else
         [(pre + k, tuple(v.shape), v.dtype)] for k, v in t.items()), [])
    assert sorted(flat(own)) == sorted(flat(tp))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixer_matches_reference(arch, precision):
    """``attn_apply`` / ``mamba_apply`` of layer 0 (and the mixer norm)."""
    f32 = precision == "f32"
    jm, jp, tm, tp = _pair(arch, f32=f32)
    cfg = tm.cfg
    x = np.random.default_rng(1).normal(size=(2, 40, cfg.d_model)).astype(
        np.float32)
    if not f32:
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tl = jax.tree_util.tree_map(lambda a: a[0], tp["layers"])
    if arch == "mamba2-130m":
        want = jmamba_apply(jl["mamba"], jnp.asarray(x), jm.cfg.mamba,
                            chunk=cfg.ssd_chunk, interpret=True)
        got = mamba_apply(tl["mamba"], _tensor(x), cfg.mamba,
                          chunk=cfg.ssd_chunk)
    else:
        pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                  head_dim=cfg.head_dim, qk_norm=cfg.qk_norm,
                  rope_theta=cfg.rope_theta)
        want = jattn_apply(jl["attn"], jnp.asarray(x),
                           positions=jnp.asarray(pos), **kw)
        got = attn_apply(tl["attn"], _tensor(x),
                         positions=torch.from_numpy(pos.copy()), **kw)
    tol = dict(rtol=F32_TOL, atol=F32_TOL) if f32 else MIXER_BF16_TOL
    np.testing.assert_allclose(_f(got), _f(want), **tol)
    np.testing.assert_allclose(
        _f(rmsnorm(_tensor(x), tl["mixer_norm"])),
        _f(jrmsnorm(jnp.asarray(x), jl["mixer_norm"])), **tol)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, precision):
    """``hidden_states``, ``logits`` and ``prefill_step`` (the reference's
    prefill program: the forward without remat, the last position's
    logits)."""
    f32 = precision == "f32"
    jm, jp, tm, tp = _pair(arch, f32=f32)
    tok = _tokens(tm.cfg.vocab)
    jh = jm.hidden_states(jp, tokens=jnp.asarray(tok), remat=False,
                          interpret=True)
    jlog = jm.logits(jp, jh)
    before = dict(counts)
    th = tm.hidden_states(tp, tokens=torch.from_numpy(tok).long())
    tlog = tm.logits(tp, th)
    tpre = tserve.prefill_step(tm, tp, {"tokens": torch.from_numpy(tok)
                                        .long()})
    assert counts == before
    assert th.dtype == (torch.float32 if f32 else torch.bfloat16)
    assert tlog.dtype == tpre.dtype == torch.float32
    assert tuple(tpre.shape) == (2, 1, tm.cfg.vocab)
    if f32:
        h_tol = dict(rtol=F32_TOL, atol=F32_TOL)
        l_tol = h_tol
    else:
        h_tol = dict(rtol=2.5e-2, atol=5e-2)
        l_tol = dict(rtol=BF16_LOGITS_TOL, atol=BF16_LOGITS_TOL)
    np.testing.assert_allclose(_f(th), _f(jh), **h_tol)
    np.testing.assert_allclose(_f(tlog), _f(jlog), **l_tol)
    np.testing.assert_allclose(_f(tpre), _f(jlog[:, -1:]), **l_tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_bf16(arch):
    jm, jp, tm, tp = _pair(arch, f32=False)
    B, T = 2, 20
    tok = _tokens(tm.cfg.vocab, B, T, seed=2)
    js = jm.init_decode_state(B, T + 4)
    ts = tm.init_decode_state(B, T + 4, device="cpu")
    step = jax.jit(jm.decode_step)
    for t in range(T):
        jl, js = step(jp, jnp.asarray(tok[:, t:t + 1]), js)
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok[:, t:t + 1])
                                .long(), ts)
        assert ts.pos == t + 1
        np.testing.assert_allclose(_f(tl), _f(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {t}")


def _margin_agree(got_tokens, want_tokens, want_logits, tol):
    """Greedy tokens equal up to the first step whose reference top-2
    margin is within ``tol`` (after it the inputs may differ)."""
    checked = 0
    for g, w, lg in zip(got_tokens, want_tokens, want_logits):
        top2 = np.sort(lg)[-2:]
        if top2[1] - top2[0] <= tol:
            break
        assert g == w
        checked += 1
    return checked


def test_serve_waves_match_reference_greedy():
    """The reference's ``serve.main`` (tiny preset, two waves of 4 slots,
    one part-filled) against the port's waves on the same parameters."""
    argv = ["--preset", "tiny", "--requests", "6", "--batch-slots", "4",
            "--prompt-len", "6", "--gen-len", "8", "--max-seq", "16"]
    want = jserve.main(argv)
    cfg = tserve.PRESETS["tiny"]
    jm = jbuild_model(jserve.PRESETS["tiny"])
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(cfg)
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
    # the reference's logits on the port's inputs: teacher-force both
    step = jax.jit(jm.decode_step)
    checked = 0
    for w0 in (0, 4):
        wave = prompts[w0:w0 + 4]
        n = len(wave)
        seq = np.zeros((4, 14), np.int32)
        for s in range(n):
            seq[s, :6] = wave[s]
            seq[s, 6:] = got[w0 + s][:8]
        js = jm.init_decode_state(4, 16)
        jlog = []
        for t in range(13):
            lg, js = step(jp, jnp.asarray(seq[:, t:t + 1]), js)
            jlog.append(np.asarray(lg[:, 0]))
        steps = record[13 * (w0 // 4):13 * (w0 // 4 + 1)]
        for s in range(n):
            # the port's logits on the same inputs agree within tolerance
            for t in range(13):
                np.testing.assert_allclose(_f(steps[t][s]), jlog[t][s],
                                           rtol=DECODE_TOL,
                                           atol=DECODE_TOL)
            checked += _margin_agree(got[w0 + s], want[w0 + s],
                                     [jlog[t][s] for t in range(5, 13)],
                                     2 * DECODE_TOL)
    assert checked > 0


def test_gumbel_noise_matches_reference():
    """``--temperature`` sampling: the reference's key schedule and
    ``jax.random.gumbel`` noise (``repro_torch.random`` is the
    non-partitionable threefry derivation)."""
    with jax.threefry_partitionable(False):
        _gumbel_case()


def _gumbel_case():
    key = jax.random.PRNGKey(1)
    tkey = trnd.PRNGKey(1)
    for _ in range(3):
        key, sub = jax.random.split(key)
        tkey, tsub = trnd.split(tkey)
        np.testing.assert_array_equal(tsub.numpy().astype(np.uint32),
                                      np.asarray(jax.random.key_data(sub)))
    want = np.asarray(jax.random.gumbel(sub, (3, 257), jnp.float32))
    got = tserve.gumbel(tsub, (3, 257), torch.device("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    logits = np.random.default_rng(3).normal(size=(3, 257)).astype(
        np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(sub, jnp.asarray(logits) / 0.7)),
        np.argmax(got + logits / 0.7, axis=-1))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_decode_matches_forward_on_the_port(arch):
    """The twin of ``test_model_semantics.test_decode_matches_forward`` on
    the port alone, with its bounds, for its dense and ssm archs (the moe
    one: ``test_torch_moe.py``)."""
    cfg = get_config(arch).reduced()
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
    ssm = cfg.family == "ssm"
    assert np.abs(a - b).max() < (5e-2 if ssm else 2e-2)
    agree = (a.argmax(-1) == b.argmax(-1)).mean()
    assert agree >= (0.8 if ssm else 1.0)


def test_unported_parts_raise():
    """Every architecture builds: the dense and ssm ones of ``ARCHS``, the
    moe pair, whisper-base's encdec, qwen2-vl-7b's vlm and, since the
    hybrid slice, jamba-1.5-large's hybrid (its ``reduced()`` config
    too).  What still raises: an unknown arch, the decoder-only ``LM``
    given the hybrid family, a hybrid whose period does not divide its
    layers.  The int8 cache, the flat formulations and remat, unported
    before, now build and run."""
    assert set(PORTED) == set(ARCH_IDS) == set(ARCHS) | {
        "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "whisper-base",
        "qwen2-vl-7b", "jamba-1.5-large-398b"}
    for name in PORTED:
        assert get_config(name).name == name
        assert build_model(get_config(name)).cfg.name == name
        assert build_model(get_config(name).reduced()).cfg.family == \
            get_config(name).family
    assert type(build_model(get_config("jamba-1.5-large-398b"))).__name__ \
        == "HybridLM"
    with pytest.raises(KeyError):
        get_config("gpt-2")
    base = get_config("qwen3-0.6b").reduced()
    from repro_torch.models.transformer import LM
    with pytest.raises(NotImplementedError, match="hybrid"):
        LM(dc.replace(base, family="hybrid"))
    with pytest.raises(ValueError, match="attn_period"):
        build_model(dc.replace(get_config("jamba-1.5-large-398b").reduced(),
                               n_layers=6))
    assert type(build_model(get_config("whisper-base"))).__name__ == "EncDec"
    assert build_model(get_config("qwen2-vl-7b")).cfg.mrope_sections == \
        (16, 24, 24)
    moe = get_config("qwen3-moe-30b-a3b").reduced()
    assert build_model(moe).is_moe
    for cfg in (dc.replace(base, kv_dtype="int8"),
                dc.replace(moe, kv_dtype="int8"),
                dc.replace(base, attn_impl="flat"),
                dc.replace(base, attn_impl="flat_seqshard")):
        m = build_model(cfg)
        params = m.init_params(torch.Generator().manual_seed(0), "cpu")
        h = m.hidden_states(params, tokens=torch.zeros((1, 4),
                                                       dtype=torch.long))
        assert bool(torch.isfinite(h).all())
        lg, _ = m.decode_step(params, torch.zeros((1, 1), dtype=torch.long),
                              m.init_decode_state(1, 4, device="cpu"))
        assert bool(torch.isfinite(lg).all())
    # remat, unported before, now runs: the same hidden states
    m = build_model(base)
    params = m.init_params(torch.Generator().manual_seed(0), "cpu")
    tok = torch.zeros((1, 4), dtype=torch.long)
    assert torch.equal(m.hidden_states(params, tokens=tok, remat=True),
                       m.hidden_states(params, tokens=tok))


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    model = build_model(get_config("mamba2-130m").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_decode_state(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--preset", "tiny", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2, np.float32)})
