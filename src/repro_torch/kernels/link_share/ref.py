"""Plain PyTorch version of max-min fair NIC bandwidth sharing (network
fabric, DESIGN.md §6), as ``repro.kernels.link_share.ref`` defines it.

Every in-flight transfer ``t`` occupies up to two ports: the egress NIC of
its source host (``src[t]``, -1 = external client, no egress constraint)
and the ingress NIC of its destination host (``dst[t]``).  Progressive
water-filling, ``iters`` rounds of:

* per-port fair share  s_p = remaining_cap_p / live_transfers_on_p
* global water level   λ   = min over occupied ports of s_p
* every live transfer gains λ; ports drain λ·n_p
* transfers touching a now-saturated port freeze at their current rate

then one conservative fill for the transfers still live: the min over
their ports of the residual fair share.

The op order is the reference's.  Port occupancy counts are exact
integers (a ``bincount``; the reference's one-hot/scatter switch changes
no bit), and the port drain ``rem - λ·n`` is one fused multiply-add
(``random.fma32``), as the reference's jitted ``link_share`` and its
compiled simulation tick compute it.
Out-of-range host ids occupy no port and read the nearest port's
table, as the reference's dropping scatters and clamping gathers do.
The CPU path and the tests use this version; on the card the kernel of
``ops.py`` runs instead.
"""
from __future__ import annotations

import torch

from ...random import fma32

# A port counts as saturated once its residual capacity falls below this
# relative tolerance (exact-arithmetic zero crossings land within a few
# ULP).
SAT_REL = 1e-5


def _count(host: torch.Tensor, mask: torch.Tensor, H: int) -> torch.Tensor:
    """Transfers per port as float32: exact integer counts."""
    idx = torch.where(mask & (host >= 0) & (host < H), host, H).long()
    return torch.bincount(idx, minlength=H + 1)[:H].to(torch.float32)


def _gather(table: torch.Tensor, host: torch.Tensor) -> torch.Tensor:
    return table[host.clamp(0, table.shape[0] - 1).long()]


def waterfill(src: torch.Tensor, dst: torch.Tensor, active: torch.Tensor,
              cap_e: torch.Tensor, cap_i: torch.Tensor,
              iters: int) -> torch.Tensor:
    """Per-transfer rates (MB/s), 0 on inactive transfers.

    ``src``/``dst`` [C] int32 hosts, ``active`` [C] bool, ``cap_e``/
    ``cap_i`` [H] float32 port capacities (MB/s), ``iters`` freeze
    rounds."""
    f32 = torch.float32
    H = cap_e.shape[0]
    inf = torch.full((), float("inf"), dtype=f32, device=src.device)
    zero = torch.zeros((), dtype=f32, device=src.device)

    live = active & (dst >= 0)
    has_src = src >= 0
    rate = torch.zeros(src.shape, dtype=f32, device=src.device)
    rem_e = cap_e.to(f32)
    rem_i = cap_i.to(f32)

    def occupancy(live):
        return _count(src, live & has_src, H), _count(dst, live, H)

    for _ in range(iters):
        n_e, n_i = occupancy(live)
        share_e = rem_e / torch.clamp_min(n_e, 1.0)
        share_i = rem_i / torch.clamp_min(n_i, 1.0)
        lam = torch.minimum(torch.where(n_e > 0, share_e, inf).min(),
                            torch.where(n_i > 0, share_i, inf).min())
        lam = torch.where(torch.isfinite(lam), torch.clamp_min(lam, 0.0),
                          zero)
        rate = rate + torch.where(live, lam, zero)
        rem_e = fma32(n_e, -lam, rem_e)
        rem_i = fma32(n_i, -lam, rem_i)
        sat_e = (n_e > 0) & (rem_e <= SAT_REL * cap_e)
        sat_i = (n_i > 0) & (rem_i <= SAT_REL * cap_i)
        frozen = (has_src & _gather(sat_e, src)) | _gather(sat_i, dst)
        live = live & ~frozen

    # Conservative final fill for transfers still live after the rounds.
    n_e, n_i = occupancy(live)
    share_e = rem_e / torch.clamp_min(n_e, 1.0)
    share_i = rem_i / torch.clamp_min(n_i, 1.0)
    fill = torch.minimum(torch.where(has_src, _gather(share_e, src), inf),
                         _gather(share_i, dst))
    rate = rate + torch.where(live, torch.clamp_min(fill, 0.0), zero)
    return torch.where(active & (dst >= 0), rate, zero)


def link_share(src, dst, active, cap_e, cap_i, iters: int = 4):
    """Max-min fair per-transfer rates (MB/s) over host NIC ports."""
    return waterfill(src, dst, active, cap_e, cap_i, iters)


def link_share_batched(src, dst, active, cap_e, cap_i, iters: int = 4):
    """:func:`link_share` for a batch (``[B, C]`` transfers, ``[B, H]``
    capacities): the solo plain version point by point, stacked.  Not the
    card's path (the kernel takes a batch in one launch): the CPU's, and
    the comparisons'."""
    return torch.stack([waterfill(src[b], dst[b], active[b], cap_e[b],
                                  cap_i[b], iters)
                        for b in range(src.shape[0])])
