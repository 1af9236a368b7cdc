"""The port's SSD layer (``repro_torch.kernels.ssd_scan``) on the CPU,
where ``ops.ssd_chunk`` runs its plain version, against the reference's
Pallas kernel in interpret mode, its chunked and sequential oracles, and
its decode step, on the same numpy-seeded inputs.

Tolerances: the intra-chunk outputs within 2e-5 of the interpret-mode
kernel (float32, sums in another order), the whole layer within the
reference's own kernel-test bound 2e-4 of its chunked and sequential
oracles (the chunk decay exp(cum_i - cum_j) amplifies the cumsum's
rounding), the decode steps within 2e-4 of the scan.  Gradients: the
layer's against ``jax.vjp`` of the reference's within 2e-5 of each one's
max |value|; the plain backward (``ref.ssd_chunk_bwd``) against the
backward kernels' formulas and order of sums (the CUDA-core pair's and
the tensor-core kernels'), both in float64, within 1e-10 of it; the
autograd Function's wiring exactly.
"""
import jax
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
    (128, 128, 128, ops.TENSOR_CORES),    # jamba-1.5-large's head width
    (64, 64, 128, ops.TENSOR_CORES),
    (16, 128, 64, ops.CUDA_CORES),        # reduced configs' chunk of 16
    (100, 64, 32, ops.CUDA_CORES),        # a ragged chunk
    (100, 128, 128, ops.CUDA_CORES),      # a ragged chunk at width 128
    (128, 128, 32, ops.CUDA_CORES),       # another head width
    (128, 128, 256, ops.CUDA_CORES),      # a head width past 128
    (128, 16, 64, ops.CUDA_CORES),        # a small state
    (128, 256, 64, ops.CUDA_CORES),       # a state past 128
])
def test_route_sends_mamba2_chunks_to_the_tensor_cores(L, N, P, want):
    """Chunks of 64 or 128 at state width 64 or 128 and head width 64 or
    128 take ``ssd_chunk_sm90``; every other shape the CUDA-core
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


@pytest.mark.parametrize("K,groups,heads,sms,halves,want", [
    (256, 1, 24, 132, 1, 24),     # mamba2-130m prefill_32k: 256 blocks
    (32, 1, 24, 132, 1, 6),       # T = 4096: 128 blocks in one wave
    (8, 2, 24, 132, 1, 3),        # two groups: 128 blocks
    (1, 4, 24, 132, 1, 1),        # a batch of four, one chunk each
    (1024, 1, 24, 132, 1, 24),
    (3, 1, 1, 132, 1, 1),
    (32, 8, 24, 132, 1, 24),      # mamba2-130m train_4k, B 8: 256 blocks
    (256, 1, 128, 132, 2, 128),   # jamba prefill_32k: heads of 2 passes
    (32, 1, 128, 132, 2, 32),     # jamba train_4k, B 1: four slices
    (4, 2, 16, 132, 1, 1),        # few chunks: a head a block
])
def test_heads_per_block_fills_the_card(K, groups, heads, sms, halves,
                                        want):
    """The slice of a group's heads one block of a tensor-core kernel
    (``ssd_chunk_sm90``, ``ssd_bwd_ds``, ``ssd_bwd_dx``) takes: fewest
    waves × (heads × halves + 1), the larger slice on a tie."""
    assert ops.heads_per_block(K, groups, heads, sms, halves) == want


# ---------------------------------------------------------------------------
# gradients: the plain backward, the autograd Function's wiring, the layer
# ---------------------------------------------------------------------------

def _grad_inputs(seed, M, K, L, P, N, group):
    """``ssd_chunk``'s inputs and its four outputs' gradients."""
    x, dt, la, b, c = _chunk_inputs(seed, M, K, L, P, N, group)
    r = np.random.default_rng(seed + 100)
    outs = [r.normal(size=s).astype(np.float32) for s in
            ((M, K, L, P), (M, K, N, P), (M, K, L, 1), (M, K, 1, 1))]
    return (x, dt, la, b, c), outs


def _kernel_math(x, dt, la, b, c, dy, dst, ddec, dtot, group):
    """The backward as ``csrc/ssd_chunk_bwd.cu`` computes it (its header's
    formulas: per head dM, dU, dS, T, R, dw; per B/C row the heads' dS
    and w ⊙ R summed in ascending order, then dC and dB), in numpy."""
    M, K, L, P = x.shape
    tri = np.tril(np.ones((L, L), bool))
    dx, ddt, dla = (np.zeros_like(a) for a in (x, dt, la))
    db, dc = np.zeros_like(b), np.zeros_like(c)
    dS_sum = np.zeros(b.shape[:2] + (L, L), x.dtype)
    wr_sum = np.zeros_like(b)
    for m in range(M):
        g = m // group
        for k in range(K):
            X, D, B, C = x[m, k], dt[m, k, :, 0], b[g, k], c[g, k]
            cum = np.cumsum(la[m, k, :, 0])
            G = np.where(tri, np.exp(np.where(tri, cum[:, None]
                                              - cum[None, :], 0)), 0)
            Mm = (C @ B.T) * G
            e = np.exp(cum[-1] - cum)
            w = e * D
            dM = np.where(tri, (dy[m, k] @ X.T) * D[None, :], 0)
            dU = Mm.T @ dy[m, k]
            T = dM * Mm
            R = X @ dst[m, k].T
            dw = (B * R).sum(1)
            dx[m, k] = D[:, None] * dU + (w[:, None] * B) @ dst[m, k]
            ddt[m, k, :, 0] = (X * dU).sum(1) + dw * e
            dcum = T.sum(1) - T.sum(0) + ddec[m, k, :, 0] * np.exp(cum) \
                - dw * w
            dcum[-1] += (dw * w).sum() + dtot[m, k, 0, 0] * np.exp(cum[-1])
            dla[m, k, :, 0] = np.cumsum(dcum[::-1])[::-1]
            dS_sum[g, k] += dM * G
            wr_sum[g, k] += w[:, None] * R
    for g in range(b.shape[0]):
        for k in range(K):
            dc[g, k] = dS_sum[g, k] @ b[g, k]
            db[g, k] = dS_sum[g, k].T @ c[g, k] + wr_sum[g, k]
    return dx, ddt, dla, db, dc


def _kernel_math_sm90(x, dt, la, b, c, dy, dst, ddec, dtot, group, hpb):
    """The backward as the tensor-core kernels of ``csrc/ssd_chunk_bwd.cu``
    compute it, in their order of sums, in numpy.  ``ssd_bwd_ds``: per
    slice of ``hpb`` heads of a B/C row, dM over the head width in halves
    of 64 columns, Σ dS over the slice's heads in ascending order, T's
    row sums less its column sums.  ``ssd_bwd_dx``: per head, 32 columns
    of the head width a pass, V = B·dstate, dw += Σ_p X ⊙ V, Z = e ⊙ V +
    Mᵀ·dy, dX = Δ ⊙ Z, dΔ += Σ_p X ⊙ Z; dcum and its reverse cumsum.
    ``ssd_bwd_db``: the slices' Σ dS in ascending order, dC = (Σ dS)·B,
    dB = (Σ dS)ᵀ·C, then each head's (w ⊙ X)·dstateᵀ added in ascending
    head order."""
    M, K, L, P = x.shape
    G = b.shape[0]
    tri = np.tril(np.ones((L, L), bool))
    dx, ddt, dla = (np.zeros_like(a) for a in (x, dt, la))
    db, dc = np.zeros_like(b), np.zeros_like(c)
    for g in range(G):
        heads = range(g * group, (g + 1) * group)
        slices = [heads[i:i + hpb] for i in range(0, group, hpb)]
        for k in range(K):
            B, C = b[g, k], c[g, k]
            S = C @ B.T
            parts = []
            for sl in slices:
                part = np.zeros((L, L), x.dtype)
                for m in sl:
                    X, D = x[m, k], dt[m, k, :, 0]
                    cum = np.cumsum(la[m, k, :, 0])
                    G_ = np.where(tri, np.exp(np.where(tri, cum[:, None]
                                                       - cum[None, :], 0)),
                                  0)
                    dM = np.zeros((L, L), x.dtype)
                    for p0 in range(0, P, 64):
                        dM += dy[m, k][:, p0:p0 + 64] @ X[:, p0:p0 + 64].T
                    dS = np.where(tri, dM * D[None, :] * G_, 0)
                    part += dS
                    T = dS * S
                    e = np.exp(cum[-1] - cum)
                    w = e * D
                    Mt = (S * G_).T
                    dw = np.zeros(L, x.dtype)
                    dd = np.zeros(L, x.dtype)
                    for p0 in range(0, P, 32):
                        cols = slice(p0, p0 + 32)
                        V = B @ dst[m, k][:, cols]
                        dw += (X[:, cols] * V).sum(1)
                        Z = e[:, None] * V + Mt @ dy[m, k][:, cols]
                        dx[m, k][:, cols] = D[:, None] * Z
                        dd += (X[:, cols] * Z).sum(1)
                    ddt[m, k, :, 0] = dd
                    dcum = T.sum(1) - T.sum(0) + ddec[m, k, :, 0] \
                        * np.exp(cum) - dw * w
                    dcum[-1] += (dw * w).sum() + dtot[m, k, 0, 0] \
                        * np.exp(cum[-1])
                    dla[m, k, :, 0] = np.cumsum(dcum[::-1])[::-1]
                parts.append(part)
            dS_sum = parts[0].copy()
            for part in parts[1:]:
                dS_sum += part
            dc[g, k] = dS_sum @ B
            acc = dS_sum.T @ C
            for m in heads:
                cum = np.cumsum(la[m, k, :, 0])
                w = np.exp(cum[-1] - cum) * dt[m, k, :, 0]
                acc += (w[:, None] * x[m, k]) @ dst[m, k].T
            db[g, k] = acc
    return dx, ddt, dla, db, dc


@pytest.mark.parametrize("M,K,L,P,N,group,hpb", [
    (4, 2, 64, 64, 64, 4, 4),      # one slice, P 64
    (6, 1, 64, 128, 64, 6, 2),     # P 128 in halves, three slices
    (8, 1, 128, 64, 128, 4, 3),    # two rows, two uneven slices a row
])
def test_plain_backward_is_the_tensor_core_order(M, K, L, P, N, group,
                                                 hpb):
    """``ref.ssd_chunk_bwd`` against the tensor-core kernels' formulas in
    their order (``_kernel_math_sm90``: heads in slices, Σ dS in ascending
    head order within a slice and then in ascending slice order, the head
    width in passes of 64 and 32 columns), both in float64: within 1e-10
    of each output's max |value|."""
    assert ops.route_bwd(L, N, P) == ops.TENSOR_CORES
    ins, outs = _grad_inputs(16, M, K, L, P, N, group)
    ins64 = [a.astype(np.float64) for a in ins]
    outs64 = [a.astype(np.float64) for a in outs]
    got = ref.ssd_chunk_bwd(*map(T_, ins64), *map(T_, outs64), group=group)
    want = _kernel_math_sm90(*ins64, *outs64, group, hpb)
    for g, w, name in zip(got, want, ("dx", "ddt", "dla", "db", "dc")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-10 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("M,K,L,P,N,group", [
    (3, 2, 16, 8, 12, 3),          # one B/C row for three heads
    (4, 2, 16, 16, 16, 1),         # the reduced configs' chunk, per head
    (4, 1, 100, 8, 24, 2),         # a ragged chunk, two groups
])
def test_plain_backward_is_the_kernels_math(M, K, L, P, N, group):
    """``ref.ssd_chunk_bwd`` (autograd through ``ref.ssd_chunk``) and the
    kernel's own formulas, both in float64: within 1e-10 of each output's
    max |value| (the sums in another order)."""
    ins, outs = _grad_inputs(11, M, K, L, P, N, group)
    ins64 = [a.astype(np.float64) for a in ins]
    outs64 = [a.astype(np.float64) for a in outs]
    got = ref.ssd_chunk_bwd(*map(T_, ins64), *map(T_, outs64), group=group)
    want = _kernel_math(*ins64, *outs64, group)
    for g, w, name in zip(got, want, ("dx", "ddt", "dla", "db", "dc")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-10 * np.abs(w).max(),
                                   err_msg=name)


def test_autograd_function_wiring(monkeypatch):
    """``SSDChunk`` on CPU tensors, its launches stood in by the plain
    versions: the backward gets all four gradients contiguous (zeros for
    the unused in_decay output), and each input gets its own gradient,
    as autograd through ``ref.ssd_chunk`` gives it."""
    (x, dt, la, b, c), (gy, _, _, gtot) = _grad_inputs(12, 6, 2, 16, 8, 16,
                                                       3)
    seen = []

    def plain_bwd(*args):
        *ins, dy, dst, ddec, dtot, group = args
        seen.append([t.is_contiguous() for t in (dy, dst, ddec, dtot)])
        seen.append([float(t.abs().max()) for t in (dst, ddec)])
        return ref.ssd_chunk_bwd(*ins, dy, dst, ddec, dtot, group=group)
    monkeypatch.setattr(ops, "launch",
                        lambda *a: ref.ssd_chunk(*a[:5], group=a[5]))
    monkeypatch.setattr(ops, "launch_bwd", plain_bwd)

    def loss(fn, ins):
        y, st, dec, tot = fn(*ins)
        # y through a transposed view: its gradient arrives strided
        return (y.transpose(2, 3) * T_(gy).transpose(2, 3)).sum() \
            + (tot * T_(gtot)).sum() + 0.0 * st.sum()
    ins = [T_(a).requires_grad_(True) for a in (x, dt, la, b, c)]
    got = torch.autograd.grad(
        loss(lambda *a: ops.SSDChunk.apply(*a, 3), ins), ins)
    ins2 = [T_(a).requires_grad_(True) for a in (x, dt, la, b, c)]
    want = torch.autograd.grad(
        loss(lambda *a: ref.ssd_chunk(*a, group=3), ins2), ins2)
    assert seen[0] == [True] * 4
    assert seen[1] == [0.0, 0.0]      # st's gradient is 0·1, dec unused
    for g, w, t in zip(got, want, ins):
        assert g.shape == t.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("L,N,P,want", [
    (128, 128, 64, ops.TENSOR_CORES),   # mamba2-130m's training chunk
    (64, 64, 64, ops.TENSOR_CORES),
    (128, 128, 128, ops.TENSOR_CORES),  # jamba-1.5-large's head width
    (64, 128, 128, ops.TENSOR_CORES),
    (16, 16, 16, ops.CUDA_CORES),       # the reduced configs'
    (100, 24, 8, ops.CUDA_CORES),       # a ragged chunk
    (128, 128, 32, ops.CUDA_CORES),     # a narrow head
    (100, 64, 128, None),               # a ragged chunk at width 128
    (256, 16, 16, None),                # a chunk past 128
    (128, 256, 64, None),               # a state past 128: more shared memory
])
def test_backward_route_takes_the_training_shapes(L, N, P, want):
    """The forward's tensor-core shapes take the tensor-core backward,
    the narrower ones up to 128 / 128 / 64 the CUDA-core pair; the rest
    raise, and take three or two launches a call."""
    if want is None:
        with pytest.raises(ValueError, match="backward"):
            ops.route_bwd(L, N, P)
    else:
        assert ops.route_bwd(L, N, P) == want
        assert ops.bwd_launches(L, N, P) == (
            3 if want == ops.TENSOR_CORES else 2)
    from repro_torch.configs import get_config
    for arch in ("mamba2-130m", "jamba-1.5-large-398b"):
        cfg = get_config(arch)
        assert ops.route_bwd(cfg.ssd_chunk, cfg.mamba.d_state,
                             cfg.mamba.headdim) == ops.TENSOR_CORES


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
@pytest.mark.parametrize("B,T,H,P,G,N,chunk", [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 96, 4, 8, 2, 16, 32),      # G > 1
    (1, 50, 3, 8, 1, 16, 16),      # ragged T (zero-Δ pad), one group
    (1, 256, 2, 64, 1, 128, 128),  # mamba2-130m's chunk and widths
    (1, 256, 2, 128, 1, 128, 128),  # jamba-1.5-large's chunk and widths
])
def test_ssd_gradients_match_reference_vjp(B, T, H, P, G, N, chunk, impl):
    """``ops.ssd``'s gradients in x, dt, A, B, C and D (autograd through
    the plain chunk function, the carry and the carried-state term)
    against ``jax.vjp`` of the reference's ``ssd``, as ``impl="chunked"``
    and through its ``custom_vjp`` with the Pallas kernel in interpret
    mode: each within 2e-5 of its own max |value| (float32, the sums in
    another order; measured 2.3e-6)."""
    a = _mk(13, B, T, H, P, G, N)
    gy = np.random.default_rng(14).normal(size=(B, T, H, P)).astype(
        np.float32)
    kw = dict(impl="kernel", interpret=True) if impl == "kernel" else \
        dict(impl="chunked")
    _, vjp = jax.vjp(lambda *v: jssd(*v, chunk=chunk, **kw),
                     *map(jnp.asarray, a))
    want = vjp(jnp.asarray(gy))
    ins = [T_(v).requires_grad_(True) for v in a]
    out = ops.ssd(*ins, chunk=chunk)
    got = torch.autograd.grad(out, ins, T_(gy))
    for g, w, name in zip(got, want, ("x", "dt", "A", "B", "C", "D")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_p128_forward_matches_reference():
    """jamba-1.5-large's Mamba widths (P = N = 128, chunks of 128, one
    group), which the card runs on the tensor-core kernel in two halves
    of 64 columns: the plain path against the reference's kernel in
    interpret mode (2e-5) and its sequential oracle (2e-4), as the other
    shapes above."""
    from repro_torch.configs import get_config
    dims = get_config("jamba-1.5-large-398b").mamba
    assert (dims.headdim, dims.d_state, dims.n_groups) == (128, 128, 1)
    assert ops.route(128, dims.d_state, dims.headdim) == ops.TENSOR_CORES
    a = _mk(15, 1, 256, 2, dims.headdim, 1, dims.d_state)
    got = ops.ssd(*map(T_, a), chunk=128).numpy()
    ja = tuple(map(jnp.asarray, a))
    want = np.asarray(jssd(*ja, chunk=128, impl="kernel", interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jref.ssd_ref(*ja)),
                               rtol=2e-4, atol=2e-4)
