"""Free-slot allocation and drop-mode scatters for fixed-capacity pools.

The r-th new cloudlet goes to the r-th free slot of the active buffer with
two prefix sums and two scatters — O(pool + spawns), no sort.  Overflow is
counted, never silently ignored.

Every function here takes the tick's leading batch axis: a pool is
``[B, C]``, one row per point of a sweep (a solo run is a batch of one).
Prefix sums, ranks and tree sums run along the last axis, per point; a
scatter flattens the batch, point ``b``'s row ``i`` becoming flat row
``b·n + i``, so each point's lanes meet in the order a solo scatter sees
them.

The reference's out-of-range scatter mode (``mode="drop"``) has no torch
counterpart: each scatter here routes the dropped lanes to overflow rows
past the end and slices them off.  Integer prefix sums name their dtype
(``torch.cumsum`` of int32 would give int64).  Float scatter-adds go through
:func:`scatter_add`, which sums in index order on both devices, so a run
gives the same bits every time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..analysis.annotate import check, checked_mode


def scatter_add(out: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``out[idx] += vals`` along dim 0, in place, all ``idx`` in range.
    On CUDA a float sum goes through the sort-based ``index_put_`` (a
    fixed order; ``index_add_`` there uses atomics in no fixed order)."""
    if out.device.type == "cuda" and out.is_floating_point():
        return out.index_put_((idx.long(),), vals, accumulate=True)
    return out.index_add_(0, idx.long(), vals)


def fill(v, shape, dtype, device) -> torch.Tensor:
    """``v`` broadcast to ``shape``: a tensor is cast and expanded, a
    Python scalar filled on the device (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype).expand(shape)
    return torch.full(shape, v, dtype=dtype, device=device)


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx[b, ...]]`` for every point ``b``: a gather along
    dim 1 of ``table`` (``[B, N, *F]``) with ``idx`` (``[B, ...]``, in
    range), shaped ``idx.shape + F``."""
    B = idx.shape[0]
    flat = idx.reshape(B, -1).long()
    feat = tuple(table.shape[2:])
    if feat:
        flat = flat.reshape((B, -1) + (1,) * len(feat)).expand(
            (B, flat.shape[1]) + feat)
    return torch.gather(table, 1, flat).reshape(tuple(idx.shape) + feat)


def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[b, i[b]]`` for a ``[B]`` device index: no read back."""
    return torch.gather(x, 1, i.reshape(-1, 1).long())[:, 0]


# (device, B, n, M) -> (offsets, overflow rows): constant for a shape, so
# kept (built outside a CUDA graph capture; a replayed tick only reads
# them)
_FLAT_ROWS: dict = {}


def _flat_rows(B: int, n: int, M: int, device):
    """``[B, 1]`` offsets ``b·n`` (point ``b``'s rows of a flattened
    ``[B·n]`` table) and ``[B, M]`` overflow rows ``B·n + b·M + m``, one
    for each lane of ``M``."""
    key = (torch.device(device), B, n, M)
    hit = _FLAT_ROWS.get(key)
    if hit is None:
        hit = (torch.arange(0, B * n, n, device=device).reshape(B, 1),
               torch.arange(B * n, B * (n + M), device=device).reshape(B, M))
        if not (key[0].type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _FLAT_ROWS[key] = hit
    return hit


def add_drop(dst: torch.Tensor, ids: torch.Tensor, vals,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """``dst.at[ids].add(vals, mode="drop")`` for each point: ``dst``
    ``[B, n, *F]``, ``ids`` ``[B, M]`` (lanes with ``valid`` False or ids
    out of range are dropped); returns a new tensor.  One flat scatter
    over every point: point ``b``'s row ``i`` is flat row ``b·n + i``, so
    each row's lanes stay in lane order, and every dropped lane gets an
    overflow row of its own (no long run of duplicates to sum)."""
    B, n = dst.shape[:2]
    M = ids.shape[1]
    feat = tuple(dst.shape[2:])
    valid = torch.ones_like(ids, dtype=torch.bool) if valid is None else valid
    ok = valid & (ids >= 0) & (ids < n)
    base, spill = _flat_rows(B, n, M, dst.device)
    idx = torch.where(ok, ids.long() + base, spill)
    ext = torch.cat([dst.reshape((B * n,) + feat),
                     dst.new_zeros((B * M,) + feat)])
    vals = fill(vals, (B, M) + feat, dst.dtype, dst.device)
    out = scatter_add(ext, idx.reshape(-1), vals.reshape((B * M,) + feat))
    return out[:B * n].reshape(dst.shape)


def set_drop(dst: torch.Tensor, ids: torch.Tensor, vals,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """``dst.at[ids].set(vals, mode="drop")`` for each point (``dst``
    ``[B, n, *F]``, ``ids`` ``[B, M]``) for ids that are distinct where
    valid; returns a new tensor."""
    B, n = dst.shape[:2]
    M = ids.shape[1]
    feat = tuple(dst.shape[2:])
    valid = torch.ones_like(ids, dtype=torch.bool) if valid is None else valid
    ok = valid & (ids >= 0) & (ids < n)
    idx = torch.where(ok, ids.long() + _flat_rows(B, n, M, dst.device)[0],
                      B * n)
    ext = torch.cat([dst.reshape((B * n,) + feat),
                     dst.new_zeros((1,) + feat)])
    vals = fill(vals, (B, M) + feat, dst.dtype, dst.device)
    # only the dropped lanes share an index (the overflow row, discarded)
    out = ext.index_copy_(0, idx.reshape(-1),
                          vals.reshape((B * M,) + feat))
    return out[:B * n].reshape(dst.shape)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter-add ``data`` (``[B, M]``) into ``n`` segments per point,
    dropping -1/invalid ids."""
    if valid is None:
        valid = ids >= 0
    return add_drop(data.new_zeros((data.shape[0], n)), ids,
                    torch.where(valid, data, torch.zeros_like(data)), valid)


def tree_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` (0, or 1 below a batch axis) in the order of the
    reference's compiled CPU reductions (XLA's tree-reduction rewrite):
    while more than 32 rows remain, pad with zero rows split evenly
    before and after (one more after) to a multiple of 32, and sum each
    window of 32 rows in order from 0; then sum the last at most 32 rows
    in order from 0.  Gives the same bits on every device (elementwise
    adds only, no atomics), for each point of a batch alike."""
    pre = tuple(x.shape[:dim])
    row = (slice(None),) * dim
    while x.shape[dim] > 32:
        n, rest = x.shape[dim], tuple(x.shape[dim + 1:])
        m = -(-n // 32)
        pad = 32 * m - n
        if pad:
            x = torch.cat([x.new_zeros(pre + (pad // 2,) + rest), x,
                           x.new_zeros(pre + (pad - pad // 2,) + rest)],
                          dim=dim)
        w = x.reshape(pre + (m, 32) + rest)
        acc = x.new_zeros(pre + (m,) + rest)
        for j in range(32):
            acc = acc + w[row + (slice(None), j)]
        x = acc
    acc = x.new_zeros(pre + tuple(x.shape[dim + 1:]))
    for j in range(x.shape[dim]):
        acc = acc + x[row + (j,)]
    return acc


class SlotAssignment(NamedTuple):
    dst: torch.Tensor        # [B, K] i32 destination pool slot for rank r
    src: torch.Tensor        # [B, K] i32 source descriptor index for rank r
    live: torch.Tensor       # [B, K] bool rank is actually assigned
    n_assigned: torch.Tensor  # [B] i32
    n_dropped: torch.Tensor   # [B] i32 (valid descriptors with no slot)


def assign_free_slots(free_mask: torch.Tensor, valid_mask: torch.Tensor,
                      k_static: int | None = None) -> SlotAssignment:
    """Match the r-th valid descriptor to the r-th free pool slot, per
    point (``free_mask`` [B, C], ``valid_mask`` [B, M]; at most
    ``k_static`` per call, default min(C, M))."""
    B, C = free_mask.shape
    M = valid_mask.shape[1]
    K = min(C, M) if k_static is None else min(k_static, C, M)
    i32 = torch.int32
    dev = free_mask.device

    free_rank = torch.cumsum(free_mask, 1, dtype=i32) - 1       # [B, C]
    want_rank = torch.cumsum(valid_mask, 1, dtype=i32) - 1      # [B, M]
    n_free = free_rank[:, -1] + 1
    n_want = want_rank[:, -1] + 1
    n_assigned = torch.clamp_max(torch.minimum(n_free, n_want), K)

    zeros = torch.zeros((B, K), dtype=i32, device=dev)
    slot_of_rank = set_drop(zeros, free_rank,
                            torch.arange(C, dtype=i32, device=dev),
                            free_mask & (free_rank < K))
    src_of_rank = set_drop(zeros, want_rank,
                           torch.arange(M, dtype=i32, device=dev),
                           valid_mask & (want_rank < K))
    live = torch.arange(K, dtype=i32, device=dev) < n_assigned[:, None]
    return SlotAssignment(dst=slot_of_rank, src=src_of_rank, live=live,
                          n_assigned=n_assigned,
                          n_dropped=n_want - n_assigned)


def scatter_pool(cl, asg: SlotAssignment, **cols):
    """Fused spawn writer: one wave of new cloudlets lands in exactly two
    scatters — every int32 column of the stacked [B, C, NI] block in one,
    every float32 column of the [B, C, NF] block in the other.  Columns
    are passed by name (rank-level [B, K] tensors, [B, 1] per-point
    values or scalars); every column of the active layout must be given,
    registered columns outside it are skipped.  Dead ranks go to the
    overflow row.  Returns new blocks."""
    from .types import CL_F_FIELDS, CL_I_FIELDS
    layout = cl.layout
    vocab = set(CL_I_FIELDS) | set(CL_F_FIELDS)
    missing = [n for n in layout.columns if n not in cols]
    unknown = sorted(set(cols) - vocab)
    if missing or unknown:
        raise TypeError(
            f"scatter_pool needs every column of the active layout "
            f"{layout.columns}; missing {sorted(missing)}, "
            f"unknown {unknown}")
    shape = tuple(asg.dst.shape)
    if checked_mode():
        # the disjointness free-slot compaction guarantees (live lanes
        # carry distinct free slots, dead lanes are dropped), checked
        # under REPRO_CHECKED=1 without a read back
        C = cl.ints.shape[1]
        hits = add_drop(torch.zeros((shape[0], C), dtype=torch.int32,
                                    device=asg.dst.device),
                        asg.dst, 1, asg.live)
        check(hits <= 1, "scatter_pool: duplicate destination slot")
        check(~asg.live | ((asg.dst >= 0) & (asg.dst < C)),
              "scatter_pool: live destination out of range")

    def stacked(names, like):
        return torch.stack([fill(cols[n], shape, like.dtype, like.device)
                            for n in names], dim=2)

    return cl.replace(
        ints=set_drop(cl.ints, asg.dst, stacked(layout.i_fields, cl.ints),
                      asg.live),
        flts=set_drop(cl.flts, asg.dst, stacked(layout.f_fields, cl.flts),
                      asg.live))


def segment_rank(keys: torch.Tensor, mask: torch.Tensor,
                 num_segments: int, block: int = 128) -> torch.Tensor:
    """Rank of each masked element within its segment (FCFS by slot order),
    per point (``keys``/``mask`` [B, n]), sort-free: intra-block ranks
    from a strictly-lower-triangular equality count, block offsets from a
    per-segment count matrix cumsummed over blocks.  Unmasked elements get
    rank = n.  Falls back to the sort-based ranking when a point's count
    matrix would pass 64 MB."""
    B, n = keys.shape
    nb = -(-n // max(min(block, n), 1))
    if nb * (num_segments + 1) > (1 << 24):
        return segment_rank_sorted(keys, mask, num_segments)
    i32 = torch.int32
    dev = keys.device
    k = torch.where(mask, keys.to(i32), num_segments)
    L = min(block, n)
    pad = -n % L
    if pad:
        k = torch.cat([k, torch.full((B, pad), num_segments, dtype=i32,
                                     device=dev)], dim=1)
        mask_p = torch.cat([mask, torch.zeros((B, pad), dtype=torch.bool,
                                              device=dev)], dim=1)
    else:
        mask_p = mask
    kb = k.reshape(B, nb, L)
    mb = mask_p.reshape(B, nb, L)
    same = (kb[..., :, None] == kb[..., None, :]) & mb[..., None, :]
    earlier = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev),
                         diagonal=-1)
    intra = torch.sum(same & earlier, dim=3, dtype=i32)       # [B, nb, L]
    cnt = torch.zeros((B * nb, num_segments + 1), dtype=i32, device=dev)
    rows = torch.arange(B * nb, device=dev)[:, None].expand(B * nb, L)
    cnt.index_put_((rows.reshape(-1), kb.reshape(-1).long()),
                   mb.reshape(-1).to(i32), accumulate=True)
    cnt = cnt.reshape(B, nb, num_segments + 1)
    base = torch.cumsum(cnt, 1, dtype=i32) - cnt             # [B, nb, S+1]
    rank = (torch.gather(base, 2, kb.long()) + intra).reshape(B, -1)[:, :n]
    return torch.where(mask, rank, n)


def segment_rank_sorted(keys: torch.Tensor, mask: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """O(n log n) sort-based ranking per point: the oracle for
    :func:`segment_rank` and its O(n)-memory fallback."""
    B, n = keys.shape
    i32 = torch.int32
    dev = keys.device
    k = torch.where(mask, keys.to(i32), num_segments).long()
    order = torch.sort(k, dim=1, stable=True).indices
    pos = torch.empty((B, n), dtype=i32, device=dev).scatter_(
        1, order, torch.arange(n, dtype=i32, device=dev).expand(B, n))
    first = torch.full((B, num_segments + 1), n, dtype=i32, device=dev)
    first = first.scatter_reduce(1, k, pos, "amin")
    rank = pos - torch.gather(first, 1, k)
    return torch.where(mask, rank, n)
