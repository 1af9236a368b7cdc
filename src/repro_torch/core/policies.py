"""Built-in policy identifiers (paper §3.2, §5), the load-balancing
rank selection shared by the dispatch phase, and the outlier-ejection
view of the dispatch table (chaos mode).

Built-ins are selected with the integer ids below, as in the reference.
"""
from __future__ import annotations

import torch

from .. import random as rnd
from ..analysis.annotate import check, checked_mode
from .pool import take
from .types import INST_ON

# --- load balancing (paper §4.2: "maximum idle resources or random") ------
LB_ROUND_ROBIN = 0
LB_RANDOM = 1
LB_LEAST_LOADED = 2

# --- CPU sharing (paper §4.2: equal vs unequal time slices) ---------------
SHARE_EQUAL = 0        # equal time slice multiplexing
SHARE_SRPT = 1         # unequal: weight ∝ 1/remaining (best-effort short-job)

# --- scaling (paper §5.3 / §6.4: NS, HS, VS) -------------------------------
SCALE_NONE = 0
SCALE_HORIZONTAL = 1
SCALE_VERTICAL = 2
SCALE_HYBRID = 3       # HS first, VS when replica cap reached (beyond-paper)

# --- HS scale-out gate ------------------------------------------------------
HS_UTIL = 0            # threshold on the service utilization EMA (Alg 4)
HS_SLO_BURN = 1        # burn-rate alerting gate (obs/slo.py)

# --- placement (paper §5.1 Alg 3) ------------------------------------------
PLACE_MOST_AVAILABLE = 0   # sorted queue by descending free PEs (paper)
PLACE_FIRST_FIT = 1
PLACE_BEST_FIT = 2
PLACE_SPREAD = 3           # cycle the VM list (k8s-style topology spread)

LB_NAMES = {LB_ROUND_ROBIN: "round_robin", LB_RANDOM: "random",
            LB_LEAST_LOADED: "least_loaded"}
SCALE_NAMES = {SCALE_NONE: "NS", SCALE_HORIZONTAL: "HS",
               SCALE_VERTICAL: "VS", SCALE_HYBRID: "HYBRID"}


def lb_rank(lb_policy: int, rr: torch.Tensor, svc: torch.Tensor,
            rep_safe: torch.Tensor, offset: torch.Tensor, rng: torch.Tensor,
            inst_of_rank: torch.Tensor, inst_status: torch.Tensor,
            inst_n_exec: torch.Tensor, inst_mips: torch.Tensor
            ) -> torch.Tensor:
    """Per-lane replica rank for the three built-in LB policies, per point
    of the batch (``svc`` [B, n]).  ``svc`` must be pre-sanitized (masked
    lanes pointing at a valid id).  The random policy's draw is one row
    shared by the points."""
    if lb_policy == LB_ROUND_ROBIN:
        return (take(rr, svc) + offset) % rep_safe
    if lb_policy == LB_RANDOM:
        return rnd.randint(rng, svc.shape[1:], 0, 1 << 30,
                           device=svc.device) % rep_safe
    # LB_LEAST_LOADED: per service, the replica with the lowest
    # executing-per-mips load among its ON instances.
    valid = inst_of_rank >= 0
    iof_safe = torch.where(valid, inst_of_rank, 0)
    load = take(inst_n_exec, iof_safe) / torch.clamp_min(
        take(inst_mips, iof_safe), 1e-6)
    load = torch.where(valid & (take(inst_status, iof_safe) == INST_ON),
                       load, float("inf"))
    return take(torch.argmin(load, dim=2).to(torch.int32), svc)


def eject_view(sched, eject_until: torch.Tensor, time: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dispatch rank table with every OPEN-ejected replica
    (``time < eject_until``) compacted out, per point (``sched`` tables
    ``[B, S, R]`` / ``[B, S]``, ``eject_until`` ``[B, I]``, ``time``
    ``[B]``): ``(inst_of_rank, svc_replicas)``.  HALF-OPEN replicas stay
    in the rotation as probe targets.  With nothing ejected the keep mask
    is the in-rank mask, each kept replica keeps its rank, and the tables
    equal ``sched``'s."""
    i32 = torch.int32
    iof = sched.inst_of_rank
    B, S, Rm = iof.shape
    idx = torch.arange(Rm, dtype=i32, device=iof.device)
    in_rank = idx < sched.svc_replicas[:, :, None]
    ejected = take(eject_until, torch.clamp_min(iof, 0)) > time[:, None, None]
    keep = in_rank & ~ejected
    pos = torch.cumsum(keep, 2, dtype=i32) - 1
    n_ok = torch.amax(torch.where(keep, pos + 1, 0), dim=2)
    return compact_rows(iof, keep, pos), n_ok


def compact_rows(iof: torch.Tensor, keep: torch.Tensor, pos: torch.Tensor
                 ) -> torch.Tensor:
    """``iof``'s kept entries (``[B, S, R]``) moved to their positions
    ``pos`` in each row, -1 elsewhere.  Within a row the kept positions
    are a prefix ranking, so the targets are distinct (checked under
    ``REPRO_CHECKED=1``); a dropped lane lands in the spare column R."""
    Rm = iof.shape[2]
    cols = torch.where(keep, pos, Rm).long()
    if checked_mode():
        hits = torch.zeros(iof.shape[:2] + (Rm + 1,), dtype=torch.int32,
                           device=iof.device)
        hits.scatter_add_(2, cols, keep.to(torch.int32))
        check(hits[:, :, :Rm] <= 1,
              "eject_view: duplicate compaction target")
    out = torch.full(iof.shape[:2] + (Rm + 1,), -1, dtype=torch.int32,
                     device=iof.device)
    out.scatter_(2, cols, iof)
    return out[:, :, :Rm]
