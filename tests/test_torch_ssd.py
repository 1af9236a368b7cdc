"""The port's SSD layer (``repro_torch.kernels.ssd_scan``) on the CPU,
where ``ops.ssd_chunk`` runs its plain version, against the reference's
Pallas kernel in interpret mode, its chunked and sequential oracles, and
its decode step, on the same numpy-seeded inputs.

Tolerances: the intra-chunk outputs within 2e-5 of the interpret-mode
kernel (float32, sums in another order), the whole layer within the
reference's own kernel-test bound 2e-4 of its chunked and sequential
oracles (the chunk decay exp(cum_i - cum_j) amplifies the cumsum's
rounding), the decode steps within 2e-4 of the scan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as jref
from repro.kernels.ssd_scan import ssd as jssd
from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas

from repro_torch.kernels import counts
from repro_torch.kernels.ssd_scan import ops, ref

torch.set_num_threads(1)


def _mk(seed, B, T, H, P, G, N):
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, T, H, P)).astype(np.float32)
    dt = r.uniform(0.05, 0.3, size=(B, T, H)).astype(np.float32)
    A = -r.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = (r.normal(size=(B, T, G, N)) / np.sqrt(N)).astype(np.float32)
    Cm = (r.normal(size=(B, T, G, N)) / np.sqrt(N)).astype(np.float32)
    D = r.normal(size=(H,)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _chunk_inputs(seed, M, K, L, P, N, group=1):
    r = np.random.default_rng(seed)
    x = r.normal(size=(M, K, L, P)).astype(np.float32)
    dt = r.uniform(0.05, 0.3, size=(M, K, L, 1)).astype(np.float32)
    la = (dt * -r.uniform(0.5, 2.0, size=(M, 1, 1, 1))).astype(np.float32)
    b = (r.normal(size=(M // group, K, L, N)) / np.sqrt(N)).astype(
        np.float32)
    c = (r.normal(size=(M // group, K, L, N)) / np.sqrt(N)).astype(
        np.float32)
    return x, dt, la, b, c


T_ = torch.from_numpy


@pytest.mark.parametrize("M,K,L,P,N", [(3, 2, 16, 8, 16), (2, 3, 32, 16, 8),
                                       (1, 1, 64, 32, 64)])
def test_ssd_chunk_matches_interpret_pallas(M, K, L, P, N):
    args = _chunk_inputs(5, M, K, L, P, N)
    before = dict(counts)
    got = ops.ssd_chunk(*map(T_, args))
    assert counts == before          # the CPU path launches no kernel
    want = ssd_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    for g, w, name in zip(got, want, ("y", "state", "in_decay", "total")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def test_ssd_chunk_groups_read_in_place():
    """B/C given per group (M / group rows) equal the per-head copy."""
    x, dt, la, b, c = _chunk_inputs(6, 6, 2, 16, 8, 16, group=3)
    got = ops.ssd_chunk(*map(T_, (x, dt, la, b, c)), group=3)
    rep = lambda a: np.repeat(a, 3, axis=0)
    want = ssd_chunk_pallas(*map(jnp.asarray, (x, dt, la, rep(b), rep(c))),
                            interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


def test_chunk_intra_matches_reference_per_chunk():
    x, dt, la, b, c = _chunk_inputs(7, 1, 1, 16, 8, 16)
    got = ref.chunk_intra(*(T_(a[0, 0]) for a in (x, dt[..., 0], la[..., 0],
                                                  b, c)))
    want = jref.chunk_intra(*(jnp.asarray(a[0, 0]) for a in
                              (x, dt[..., 0], la[..., 0], b, c)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 96, 4, 8, 2, 16, 32),      # G > 1
    (1, 50, 3, 8, 3, 16, 16),      # ragged T (zero-Δ pad), H == G
    (2, 37, 4, 8, 1, 8, 32),       # ragged T, one group for four heads
])
def test_ssd_matches_reference_kernel_and_oracles(B, T, H, P, G, N, chunk):
    a = _mk(8, B, T, H, P, G, N)
    got = ops.ssd(*map(T_, a), chunk=chunk).numpy()
    ja = tuple(map(jnp.asarray, a))
    want = np.asarray(jssd(*ja, chunk=chunk, impl="kernel", interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jref.ssd_ref(*ja)),
                               rtol=2e-4, atol=2e-4)
    if T % chunk == 0:
        np.testing.assert_allclose(
            ref.ssd_chunked_ref(*map(T_, a), chunk=chunk).numpy(),
            np.asarray(jref.ssd_chunked_ref(*ja, chunk=chunk)),
            rtol=2e-5, atol=2e-5)


def test_sequential_ref_matches_reference():
    a = _mk(9, 1, 24, 2, 8, 1, 8)
    np.testing.assert_allclose(
        ref.ssd_ref(*map(T_, a)).numpy(),
        np.asarray(jref.ssd_ref(*map(jnp.asarray, a))), rtol=2e-5,
        atol=2e-5)


def test_decode_steps_match_scan_suffix():
    """T decode steps of the port equal the scan (the port's and the
    reference's) and the reference's decode steps."""
    B, T, H, P, G, N = 1, 16, 2, 8, 1, 8
    x, dt, A, Bm, Cm, D = _mk(10, B, T, H, P, G, N)
    want = np.asarray(jref.ssd_ref(*map(jnp.asarray,
                                        (x, dt, A, Bm, Cm, D))))
    h = torch.zeros((B, H, N, P))
    jh = jnp.zeros((B, H, N, P), jnp.float32)
    outs = []
    for t in range(T):
        h, y = ops.ssd_decode_step(h, T_(x[:, t]), T_(dt[:, t]), T_(A),
                                   T_(Bm[:, t]), T_(Cm[:, t]), T_(D))
        jh, _ = jref.ssd_decode_step(jh, x[:, t], dt[:, t], A, Bm[:, t],
                                     Cm[:, t], D)
        outs.append(y)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2e-5,
                               atol=2e-5)


def test_wrapper_refuses_other_devices():
    x = torch.zeros((1, 1, 4, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ssd_chunk(x, x, x, x, x)


@pytest.mark.parametrize("L,N,P,want", [
    (128, 128, 64, ops.TENSOR_CORES),     # mamba2-130m's prefill chunk
    (64, 128, 64, ops.TENSOR_CORES),      # ssd()'s default chunk of 64
    (128, 64, 64, ops.TENSOR_CORES),
    (64, 64, 64, ops.TENSOR_CORES),
    (16, 128, 64, ops.CUDA_CORES),        # reduced configs' chunk of 16
    (100, 64, 32, ops.CUDA_CORES),        # a ragged chunk
    (128, 128, 32, ops.CUDA_CORES),       # another head width
    (128, 16, 64, ops.CUDA_CORES),        # a small state
    (128, 256, 64, ops.CUDA_CORES),       # a state past 128
])
def test_route_sends_mamba2_chunks_to_the_tensor_cores(L, N, P, want):
    """Chunks of 64 or 128 at state width 64 or 128 and head width 64
    take ``ssd_chunk_sm90``; every other shape the CUDA-core
    ``ssd_chunk_kernel``.  The C entry point applies the same rule."""
    assert ops.route(L, N, P) == want


def test_route_takes_mamba2_130m_but_not_its_reduced_chunk():
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-130m")
    dims = cfg.mamba
    assert ops.route(cfg.ssd_chunk, dims.d_state, dims.headdim) \
        == ops.TENSOR_CORES
    red = cfg.reduced()
    assert ops.route(red.ssd_chunk, red.mamba.d_state,
                     red.mamba.headdim) == ops.CUDA_CORES


@pytest.mark.parametrize("K,groups,heads,sms,want", [
    (256, 1, 24, 132, 24),     # mamba2-130m prefill_32k: 256 blocks
    (32, 1, 24, 132, 6),       # T = 4096: 128 blocks in one wave
    (8, 2, 24, 132, 3),        # two groups: 128 blocks
    (1, 4, 24, 132, 1),        # a batch of four, one chunk each
    (1024, 1, 24, 132, 24),
    (3, 1, 1, 132, 1),
])
def test_heads_per_block_fills_the_card(K, groups, heads, sms, want):
    """The slice of a group's heads one block of ``ssd_chunk_sm90``
    takes: fewest waves × (heads + 1), the larger slice on a tie."""
    assert ops.heads_per_block(K, groups, heads, sms) == want
