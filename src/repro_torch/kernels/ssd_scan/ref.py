"""Plain PyTorch Mamba-2 SSD (state-space duality) scan: the CPU path of
``ops.ssd_chunk`` and the yardstick the CUDA kernels (``csrc/ssd_chunk.cu``
and ``csrc/ssd_chunk_bwd.cu``) are held against on the card.

Semantics (per batch b, head h; arXiv:2405.21060 §6):

    h_t = a_t · h_{t-1} + Δ_t · b_t ⊗ x_t        h ∈ R^{N×P}
    y_t = c_t · h_t + D_h · x_t

with a_t = exp(Δ_t · A_h).  ``ssd_ref`` is the sequential scan;
``ssd_chunked_ref`` the chunked form the kernel implements (intra-chunk
quadratic part + inter-chunk state recurrence); ``ssd_chunk`` the
kernel's own function over every (batch·head, chunk); ``ssd_chunk_bwd``
its gradients, the yardstick of the backward kernel
(``csrc/ssd_chunk_bwd.cu``).

Shapes: x [B, T, H, P], dt [B, T, H], A [H], B/C [B, T, G, N] with
H % G == 0, D [H].  Output [B, T, H, P].
"""
from __future__ import annotations

import torch

from ...dist.sharding import on_shards


def _expand_groups(bc: torch.Tensor, h: int) -> torch.Tensor:
    """[B, T, G, N] → [B, T, H, N] by repeating each group H/G times."""
    g = bc.shape[2]
    assert h % g == 0
    return torch.repeat_interleave(bc, h // g, dim=2)


def ssd_ref(x, dt, A, B, C, D=None):
    """Sequential scan — O(T) steps, exact semantics."""
    Bsz, T, H, P = x.shape
    N = B.shape[-1]
    Bh = _expand_groups(B, H).float()
    Ch = _expand_groups(C, H).float()
    xf, dtf = x.float(), dt.float()
    a = torch.exp(dtf * A.float()[None, None, :])             # [B,T,H]
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        h = (a[:, t, :, None, None] * h
             + (dtf[:, t, :, None] * Bh[:, t])[..., :, None]
             * xf[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype)


def chunk_intra(x_c, dt_c, la_c, b_c, c_c):
    """Intra-chunk quadratic part + per-chunk state summary, over any
    leading dims: x_c [..., L, P], dt_c/la_c [..., L], b_c/c_c [..., L, N]
    (float32).  Returns (y_intra [..., L, P], state [..., N, P],
    total_decay [...], in_decay [..., L]) where
      y_intra[i] = Σ_{j≤i} exp(cum[i]-cum[j]) (c_i·b_j) Δ_j x_j
      state      = Σ_j exp(cum[L-1]-cum[j]) Δ_j b_j ⊗ x_j
      in_decay[i]= exp(cum[i])
    """
    L = x_c.shape[-2]
    cum = torch.cumsum(la_c, dim=-1)                         # [..., L]
    seg = cum[..., :, None] - cum[..., None, :]              # [..., L, L]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x_c.device))
    # mask before exp: the upper triangle of seg is large and positive
    gate = torch.exp(torch.where(causal, seg, -1e30))
    scores = (c_c @ b_c.transpose(-1, -2)) * gate
    dx = dt_c[..., :, None] * x_c
    y_intra = scores @ dx
    out_decay = torch.exp(cum[..., -1:] - cum)               # [..., L]
    wb = out_decay[..., :, None] * dt_c[..., :, None] * b_c
    state = wb.transpose(-1, -2) @ x_c                       # [..., N, P]
    return y_intra, state, torch.exp(cum[..., -1]), torch.exp(cum)


def ssd_chunk(x, dt, la, b, c, group: int = 1):
    """The kernel's function (the reference's ``ssd_chunk_pallas``):
    x [M, K, L, P]; dt, la [M, K, L, 1]; b, c [M / group, K, L, N] (row m
    reads B/C row m // group).  Returns (y [M,K,L,P], state [M,K,N,P],
    in_decay [M,K,L,1], total_decay [M,K,1,1]), all float32."""
    if group > 1:
        b = torch.repeat_interleave(b, group, dim=0)
        c = torch.repeat_interleave(c, group, dim=0)
    y, st, tot, dec = chunk_intra(x, dt[..., 0], la[..., 0], b, c)
    return y, st, dec[..., None], tot[..., None, None]


def ssd_chunk_bwd(x, dt, la, b, c, dy, dstate, ddec, dtot, group: int = 1):
    """dx, ddt, dla, db, dc of ``ssd_chunk`` by autograd through it (the
    VJP the reference's ``_bwd`` recomputes), for the gradients dy
    [M,K,L,P], dstate [M,K,N,P], ddec [M,K,L,1] and dtot [M,K,1,1] of its
    four outputs: the yardstick of the backward kernel
    (``csrc/ssd_chunk_bwd.cu``).  db and dc are per B/C row
    ([M / group, K, L, N]), summed over the group's heads."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, la, b, c)]
        outs = ssd_chunk(*ins, group=group)
        return torch.autograd.grad(outs, ins, (dy, dstate, ddec, dtot))


def carry(states, total):
    """The inter-chunk recurrence: the state carried into each chunk,
    h_in[k] = total[k-1] · h_in[k-1] + states[k-1] from zero.  states
    [M, K, N, P], total [M, K] → [M, K, N, P]."""
    h = torch.zeros_like(states[:, 0])
    h_ins = []
    for k in range(states.shape[1]):
        h_ins.append(h)
        h = total[:, k, None, None] * h + states[:, k]
    return torch.stack(h_ins, dim=1)


def ssd_chunked_ref(x, dt, A, B, C, D=None, chunk: int = 64):
    """Chunked SSD — the algorithm the kernel implements (T a multiple of
    ``chunk``)."""
    Bsz, T, H, P = x.shape
    N = B.shape[-1]
    assert T % chunk == 0, (T, chunk)
    K = T // chunk
    Bh = _expand_groups(B, H).float()
    Ch = _expand_groups(C, H).float()
    xf, dtf = x.float(), dt.float()
    la = dtf * A.float()[None, None, :]

    def per(v, d):        # [B, T, H, d] → [B, H, K, L, d]
        return v.reshape(Bsz, K, chunk, H, d).permute(0, 3, 1, 2, 4)

    xr, br, cr = per(xf, P), per(Bh, N), per(Ch, N)
    dtr = per(dtf[..., None], 1)[..., 0]
    lar = per(la[..., None], 1)[..., 0]
    y_intra, states, total, in_decay = chunk_intra(xr, dtr, lar, br, cr)
    h_ins = carry(states.reshape(Bsz * H, K, N, P),
                  total.reshape(Bsz * H, K)).reshape(Bsz, H, K, N, P)
    y_carry = torch.einsum("bhkln,bhkl,bhknp->bhklp", cr, in_decay, h_ins)
    y = (y_intra + y_carry).permute(0, 2, 3, 1, 4).reshape(Bsz, T, H, P)
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_decode_step(h, x_t, dt_t, A, b_t, c_t, D=None):
    """O(1) single-token decode: update the state, emit one output.
    h [B,H,N,P]; x_t [B,H,P]; dt_t [B,H]; b_t/c_t [B,G,N]."""
    H = x_t.shape[1]
    rep = H // b_t.shape[1]
    bh = torch.repeat_interleave(b_t, rep, dim=1).float()
    ch = torch.repeat_interleave(c_t, rep, dim=1).float()
    a_t = torch.exp(dt_t.float() * A.float()[None, :])
    h_new = (a_t[..., None, None] * h
             + (dt_t[..., None].float() * bh)[..., :, None]
             * x_t.float()[..., None, :])
    y = on_shards(lambda hn, c: torch.einsum("bhn,bhnp->bhp", c, hn),
                  (h_new, ch), x_t.shape)
    if y is None:
        y = torch.einsum("bhn,bhnp->bhp", ch, h_new)
    if D is not None:
        y = y + D.float()[None, :, None] * x_t.float()
    return h_new, y.to(x_t.dtype)
