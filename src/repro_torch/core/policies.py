"""Built-in policy identifiers (paper §3.2, §5) and the load-balancing
rank selection shared by the dispatch phase.

Built-ins are selected with the integer ids below, as in the reference.
"""
from __future__ import annotations

import torch

from .. import random as rnd
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
HS_SLO_BURN = 1        # burn-rate alerting gate (not ported yet)

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
