"""Free-slot allocation and drop-mode scatters for fixed-capacity pools.

The r-th new cloudlet goes to the r-th free slot of the active buffer with
two prefix sums and two scatters — O(pool + spawns), no sort.  Overflow is
counted, never silently ignored.

The reference's out-of-range scatter mode (``mode="drop"``) has no torch
counterpart: each scatter here routes the dropped lanes to an overflow row
one past the end and slices it off.  Integer prefix sums name their dtype
(``torch.cumsum`` of int32 would give int64).  Float scatter-adds go through
:func:`scatter_add`, which sums in index order on both devices, so a run
gives the same bits every time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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


def at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d device index.  Plain ``x[i]`` with a 0-d tensor
    reads the index back to the host (a synchronisation); this does not."""
    return x.index_select(0, i.reshape(1).long())[0]


def _overflow_index(ids: torch.Tensor, valid: torch.Tensor, n: int
                    ) -> torch.Tensor:
    return torch.where(valid & (ids >= 0) & (ids < n), ids, n).long()


def add_drop(dst: torch.Tensor, ids: torch.Tensor, vals,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """``dst.at[ids].add(vals, mode="drop")`` (lanes with ``valid`` False
    or ids out of range are dropped); returns a new tensor."""
    n = dst.shape[0]
    valid = torch.ones_like(ids, dtype=torch.bool) if valid is None else valid
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    vals = fill(vals, ids.shape + dst.shape[1:], dst.dtype, dst.device)
    return scatter_add(ext, _overflow_index(ids, valid, n), vals)[:n]


def set_drop(dst: torch.Tensor, ids: torch.Tensor, vals,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """``dst.at[ids].set(vals, mode="drop")`` for ids that are distinct
    where valid; returns a new tensor."""
    n = dst.shape[0]
    valid = torch.ones_like(ids, dtype=torch.bool) if valid is None else valid
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    vals = fill(vals, ids.shape + dst.shape[1:], dst.dtype, dst.device)
    # only the dropped lanes share an index (the overflow row, discarded)
    return ext.index_copy_(0, _overflow_index(ids, valid, n), vals)[:n]


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter-add ``data`` into ``n`` segments, dropping -1/invalid ids."""
    if valid is None:
        valid = ids >= 0
    return add_drop(data.new_zeros((n,)), ids,
                    torch.where(valid, data, torch.zeros_like(data)), valid)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in the order of the reference's compiled CPU
    reductions (XLA's tree-reduction rewrite): while more than 32 rows
    remain, pad with zero rows split evenly before and after (one more
    after) to a multiple of 32, and sum each window of 32 rows in order
    from 0; then sum the last at most 32 rows in order from 0.  Gives the
    same bits on every device (elementwise adds only, no atomics)."""
    while x.shape[0] > 32:
        n, rest = x.shape[0], tuple(x.shape[1:])
        m = -(-n // 32)
        pad = 32 * m - n
        if pad:
            x = torch.cat([x.new_zeros((pad // 2,) + rest), x,
                           x.new_zeros((pad - pad // 2,) + rest)])
        w = x.reshape((m, 32) + rest)
        acc = x.new_zeros((m,) + rest)
        for j in range(32):
            acc = acc + w[:, j]
        x = acc
    acc = x.new_zeros(tuple(x.shape[1:]))
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc


class SlotAssignment(NamedTuple):
    dst: torch.Tensor        # [K] i32 destination pool slot for rank r
    src: torch.Tensor        # [K] i32 source descriptor index for rank r
    live: torch.Tensor       # [K] bool rank is actually assigned
    n_assigned: torch.Tensor  # scalar i32
    n_dropped: torch.Tensor   # scalar i32 (valid descriptors with no slot)


def assign_free_slots(free_mask: torch.Tensor, valid_mask: torch.Tensor,
                      k_static: int | None = None) -> SlotAssignment:
    """Match the r-th valid descriptor to the r-th free pool slot
    (``free_mask`` [C], ``valid_mask`` [M]; at most ``k_static`` per call,
    default min(C, M))."""
    C = free_mask.shape[0]
    M = valid_mask.shape[0]
    K = min(C, M) if k_static is None else min(k_static, C, M)
    i32 = torch.int32
    dev = free_mask.device

    free_rank = torch.cumsum(free_mask, 0, dtype=i32) - 1       # [C]
    want_rank = torch.cumsum(valid_mask, 0, dtype=i32) - 1      # [M]
    n_free = free_rank[-1] + 1
    n_want = want_rank[-1] + 1
    n_assigned = torch.clamp_max(torch.minimum(n_free, n_want), K)

    slot_of_rank = set_drop(torch.zeros((K,), dtype=i32, device=dev),
                            free_rank, torch.arange(C, dtype=i32, device=dev),
                            free_mask & (free_rank < K))
    src_of_rank = set_drop(torch.zeros((K,), dtype=i32, device=dev),
                           want_rank, torch.arange(M, dtype=i32, device=dev),
                           valid_mask & (want_rank < K))
    live = torch.arange(K, dtype=i32, device=dev) < n_assigned
    return SlotAssignment(dst=slot_of_rank, src=src_of_rank, live=live,
                          n_assigned=n_assigned,
                          n_dropped=n_want - n_assigned)


def scatter_pool(cl, asg: SlotAssignment, **cols):
    """Fused spawn writer: one wave of new cloudlets lands in exactly two
    scatters — every int32 column of the stacked [C, NI] block in one,
    every float32 column of the [C, NF] block in the other.  Columns are
    passed by name (rank-level [K] tensors or scalars); every column of
    the active layout must be given, registered columns outside it are
    skipped.  Dead ranks go to the overflow row.  Returns new blocks."""
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
    K = asg.dst.shape[0]

    def stacked(names, like):
        return torch.stack([fill(cols[n], (K,), like.dtype, like.device)
                            for n in names], dim=1)

    return cl.replace(
        ints=set_drop(cl.ints, asg.dst, stacked(layout.i_fields, cl.ints),
                      asg.live),
        flts=set_drop(cl.flts, asg.dst, stacked(layout.f_fields, cl.flts),
                      asg.live))


def segment_rank(keys: torch.Tensor, mask: torch.Tensor,
                 num_segments: int, block: int = 128) -> torch.Tensor:
    """Rank of each masked element within its segment (FCFS by slot order),
    sort-free: intra-block ranks from a strictly-lower-triangular equality
    count, block offsets from a per-segment count matrix cumsummed over
    blocks.  Unmasked elements get rank = n.  Falls back to the sort-based
    ranking when the count matrix would pass 64 MB."""
    n = keys.shape[0]
    n_blocks = -(-n // max(min(block, n), 1))
    if n_blocks * (num_segments + 1) > (1 << 24):
        return segment_rank_sorted(keys, mask, num_segments)
    i32 = torch.int32
    dev = keys.device
    k = torch.where(mask, keys.to(i32), num_segments)
    L = min(block, n)
    pad = -n % L
    if pad:
        k = torch.cat([k, torch.full((pad,), num_segments, dtype=i32,
                                     device=dev)])
        mask_p = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    else:
        mask_p = mask
    B = k.shape[0] // L
    kb = k.reshape(B, L)
    mb = mask_p.reshape(B, L)
    same = (kb[:, :, None] == kb[:, None, :]) & mb[:, None, :]
    earlier = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev),
                         diagonal=-1)[None]
    intra = torch.sum(same & earlier, dim=2, dtype=i32)          # [B, L]
    cnt = torch.zeros((B, num_segments + 1), dtype=i32, device=dev)
    rows = torch.arange(B, device=dev)[:, None].expand(B, L)
    cnt.index_put_((rows.reshape(-1), kb.reshape(-1).long()),
                   mb.reshape(-1).to(i32), accumulate=True)
    base = torch.cumsum(cnt, 0, dtype=i32) - cnt                 # [B, S+1]
    rank = (torch.gather(base, 1, kb.long()) + intra).reshape(-1)[:n]
    return torch.where(mask, rank, n)


def segment_rank_sorted(keys: torch.Tensor, mask: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """O(n log n) sort-based ranking: the oracle for :func:`segment_rank`
    and its O(n)-memory fallback."""
    n = keys.shape[0]
    i32 = torch.int32
    dev = keys.device
    k = torch.where(mask, keys.to(i32), num_segments)
    order = torch.sort(k, stable=True).indices
    pos = torch.empty((n,), dtype=i32, device=dev)
    pos[order] = torch.arange(n, dtype=i32, device=dev)
    first = torch.full((num_segments + 1,), n, dtype=i32, device=dev)
    first = first.scatter_reduce(0, k.long(), pos, "amin")
    rank = pos - first[k.long()]
    return torch.where(mask, rank, n)
