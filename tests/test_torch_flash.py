"""The port's attention (``repro_torch.kernels.flash_attention``) on the
CPU, where ``ops.attention`` runs its plain version, against the
reference's Pallas kernel in interpret mode and its ``ref.attention``, on
the same numpy-seeded inputs.

Tolerances: float32 inputs within 2e-5 (abs and rel; the sums are taken
in another order), bfloat16 inputs within the reference's own kernel-test
bound, 2e-2 (the output rounds to bfloat16).  Rows with no visible key
(causal, Tq > Tk) are held against the interpret-mode Pallas kernel only,
which defines them (``ref.attention`` gives NaN there).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention as jattention
from repro.kernels.flash_attention import attention_ref as jref
from repro.kernels.flash_attention.kernel import flash_attention_pallas

from repro_torch.kernels import counts
from repro_torch.kernels.flash_attention import attention, attention_ref
from repro_torch.kernels.flash_attention import ops as tflash

torch.set_num_threads(1)


def _mk(seed, B, Hq, Hkv, Tq, Tk, D):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Hq, Tq, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Tk, D)).astype(np.float32),
            r.normal(size=(B, Hkv, Tk, D)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _np(t):
    return t.float().numpy()


SHAPES = [                                  # B, Hq, Hkv, Tq, Tk, D
    (1, 2, 2, 128, 128, 32),                # MHA square
    (1, 4, 2, 96, 96, 16),                  # GQA group 2, ragged
    (2, 8, 1, 64, 160, 32),                 # MQA, Tq < Tk, ragged Tk
    (1, 4, 2, 77, 200, 16),                 # GQA, Tq < Tk, both ragged
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_f32_matches_pallas_and_ref(shape):
    q, k, v = _mk(1, *shape)
    before = dict(counts)
    got = _np(attention(_t(q), _t(k), _t(v), causal=True))
    assert counts == before          # the CPU path launches no kernel
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), impl="flash",
                                 interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    want_ref = np.asarray(jref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True))
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_bf16_matches_pallas(causal):
    q, k, v = _mk(2, 1, 4, 2, 128, 128, 32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [_t(a, torch.bfloat16) for a in (q, k, v)]
    got = attention(*tb, causal=causal)
    assert got.dtype == torch.bfloat16
    want = flash_attention_pallas(*jb, causal=causal, bq=64, bk=64,
                                  interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_attention_non_causal_f32():
    q, k, v = _mk(3, 2, 4, 2, 50, 90, 16)
    got = _np(attention(_t(q), _t(k), _t(v), causal=False))
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False,
                                 impl="flash", interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Tq,Tk", [(256, 128), (200, 70)])
def test_fully_masked_rows_match_interpret_pallas(Tq, Tk):
    """Tq > Tk: the first Tq - Tk rows see no key.  The Pallas kernel
    (through its ops' 128-key blocks) gives ΣV / (Tk rounded up to 128)
    there; the port's plain version gives the same, and the rows that do
    see keys agree as everywhere else."""
    q, k, v = _mk(4, 1, 2, 2, Tq, Tk, 32)
    got = _np(attention_ref(_t(q), _t(k), _t(v), causal=True))
    want = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), impl="flash",
                                 interpret=True))
    dead = Tq - Tk
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    mean = v.sum(axis=2) / (-(-Tk // 128) * 128)
    np.testing.assert_allclose(got[:, :, :dead],
                               np.broadcast_to(mean[:, :, None],
                                               got[:, :, :dead].shape),
                               rtol=2e-5, atol=2e-6)


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_route_sends_bf16_at_64_and_128_to_the_tensor_cores(dtype, D):
    """bfloat16 at head width 64 or 128 takes ``flash_fwd_sm90``; float32
    (whose 2e-5 tolerance TF32 would break) and bf16 at 16 or 32 take the
    CUDA-core ``flash_fwd``.  The C entry point applies the same rule."""
    want = (tflash.TENSOR_CORES if dtype == torch.bfloat16 and D >= 64
            else tflash.CUDA_CORES)
    assert tflash.route(dtype, D) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", tflash.HEAD_DIMS)
def test_route_bwd_sends_bf16_at_64_and_128_to_the_tensor_cores(dtype, D):
    """The backward's rule: bfloat16 at head width 64 or 128 takes
    ``flash_bwd_dq_sm90`` and ``flash_bwd_dkdv_sm90``; float32 and bf16 at
    16 or 32 take the CUDA-core ``flash_bwd_dq`` and ``flash_bwd_dkdv``.
    The C entry point applies the same rule."""
    want = (tflash.TENSOR_CORES if dtype == torch.bfloat16 and D in (64, 128)
            else tflash.CUDA_CORES)
    assert tflash.route_bwd(dtype, D) == want


def test_launch_runs_only_on_the_card():
    q, k, v = (_t(a, torch.bfloat16) for a in _mk(0, 1, 2, 1, 8, 8, 64))
    with pytest.raises(ValueError, match="cuda"):
        tflash.launch(q, k, v, True, None)
