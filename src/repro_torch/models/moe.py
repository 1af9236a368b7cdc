"""Mixture-of-Experts configuration.  The port holds the type only (so
``ArchConfig`` can name it); the MoE layer itself is not ported yet."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN width
    n_shared: int = 0          # shared-expert count (Qwen2-MoE style)
    d_shared: int = 0          # shared-expert FFN width (total)
    capacity_factor: float = 1.25
    norm_topk: bool = True
