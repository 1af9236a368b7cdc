"""Mixture-of-Experts MLP: top-k routing and the reference's sort-based
dispatch with fixed capacity (``repro.models.moe``).

The (token, k) assignments are sorted by expert id (stable), each
expert's segment fills a buffer of ``cap`` slots, one batched product per
projection runs every expert over its ``[cap, d]`` block, and the
weighted outputs come back to their tokens.  Assignments beyond an
expert's capacity are dropped: their router weight contributes nothing.

Three choices keep the layer the reference's and keep a decode step
capturable as a CUDA graph (no host read, no data-dependent shape):

* top-k is a stable descending sort, so among equal probabilities the
  lower expert index comes first, as ``jax.lax.top_k`` orders them
  (``torch.topk`` promises no order among ties);
* the per-expert counts are a scatter-add of ones into ``[E]``
  (``torch.bincount`` reads its maximum back to the host on CUDA);
* the combine is a fold, not a scatter-add: each assignment finds its
  slot through the inverse of the sort, each token's K assignments are
  taken in ascending expert id and added one after another to zero.
  That is the order of the reference's serial scatter on the CPU (slots
  ascend with the expert id), and it is the same on every run on the
  card, where an atomic ``index_add_`` is not.

The backward is the same on every run too.  The dispatch gather
(``gather_tokens``) differentiates into a fold of each token's K slot
gradients in ascending expert id, in the input's type (the order of the
reference's scatter-add of the gather's transpose; autograd's
``index_add_`` would add a token's K rows atomically, in any order).  A
dropped assignment gets no gradient, in the gather and in the combine.
The combine's own gathers need nothing: a kept slot is read by one
assignment only, so their ``index_add_`` backward puts one row into
zeros, and every dropped assignment adds an exact zero to row 0; the
router weights' gather and the sort behind ``route`` scatter each value
to its own place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..dist.sharding import replicate_like
from .common import P, apply_mlp, mlp_schema


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN width
    n_shared: int = 0          # shared-expert count (Qwen2-MoE style)
    d_shared: int = 0          # shared-expert FFN width (total)
    capacity_factor: float = 1.25
    norm_topk: bool = True


def moe_schema(d: int, cfg: MoECfg, dtype=torch.bfloat16) -> Dict[str, P]:
    E, f = cfg.n_experts, cfg.d_expert
    s = {
        "router": P((d, E), ("embed", None), init="small_normal",
                    dtype=torch.float32),
        "gate": P((E, d, f), ("experts", "embed", "mlp"), dtype=dtype),
        "up": P((E, d, f), ("experts", "embed", "mlp"), dtype=dtype),
        "down": P((E, f, d), ("experts", "mlp", "embed"), dtype=dtype),
    }
    if cfg.n_shared:
        s["shared"] = mlp_schema(d, cfg.d_shared, dtype)
        s["shared_gate"] = P((d, 1), ("embed", None), init="small_normal",
                             dtype=torch.float32)
    return s


def capacity(n_tok: int, cfg: MoECfg) -> int:
    """Slots per expert: the reference's host arithmetic, floats and all."""
    E, K = cfg.n_experts, cfg.top_k
    return int(max(1, -(-n_tok * K * cfg.capacity_factor // E)))


def route(p, xf: torch.Tensor, cfg: MoECfg):
    """Router probabilities → (top_p [n, K] float32, top_e [n, K] int64),
    experts by descending probability, the lower index first among ties."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    if cfg.norm_topk:
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return top_p, top_e


def dispatch(top_e: torch.Tensor, cap: int, n_experts: int):
    """The reference's dispatch tables for the flat assignments
    ``top_e.reshape(-1)`` (assignment ``i`` is token ``i // K``'s k-th
    choice): ``order`` (stable sort by expert), ``keep`` (sorted
    assignment within capacity), ``slot`` (its slot, ``E*cap`` when
    dropped), ``tok_of_slot`` and ``live`` (the ``[E*cap]`` slot tables,
    token 0 and False in an empty slot)."""
    n_tok, K = top_e.shape
    E = n_experts
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = replicate_like(torch.zeros(E, dtype=torch.int64, device=dev),
                            se).scatter_add_(0, se, torch.ones_like(se))
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n_tok * K, device=dev) - offsets[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, E * cap)
    # slot E*cap is the reference's sentinel row: every dropped assignment
    # writes there, and the row is thrown away
    tok_of_slot = replicate_like(
        torch.zeros(E * cap + 1, dtype=torch.int64, device=dev),
        slot).scatter_(0, slot, order // K)
    live = replicate_like(
        torch.zeros(E * cap + 1, dtype=torch.bool, device=dev),
        slot).scatter_(0, slot, keep)
    return order, keep, slot, tok_of_slot[:-1], live[:-1]


def assignment_slots(order: torch.Tensor, slot: torch.Tensor,
                     top_e: torch.Tensor, dropped_slot: int):
    """Each token's K assignments in ascending expert id: ``by_e`` (their
    positions in ``top_e``'s rows), ``rows`` (each one's slot, 0 where
    dropped) and ``dropped`` ([n, K] each).  ``slot`` is ``dispatch``'s,
    in sorted order; its inverse through ``order`` is each assignment's
    slot."""
    n_tok, K = top_e.shape
    slot_of = torch.empty_like(slot).scatter_(0, order, slot)
    by_e = torch.argsort(top_e, dim=-1)
    slot_of = torch.gather(slot_of.reshape(n_tok, K), 1, by_e)
    dropped = slot_of == dropped_slot
    return by_e, torch.where(dropped, 0, slot_of), dropped


def fold_slots(g: torch.Tensor, rows: torch.Tensor,
               dropped: torch.Tensor) -> torch.Tensor:
    """``[n, d]``: for each token, its kept assignments' rows of ``g``
    (``[E*cap, d]``) added to zero one after another in ``rows``' order
    (ascending expert id), in ``g``'s type."""
    out = g.new_zeros((rows.shape[0], g.shape[1]))
    for k in range(rows.shape[1]):
        out = out + torch.where(dropped[:, k, None], 0.0,
                                g.index_select(0, rows[:, k]))
    return out


class _GatherTokens(torch.autograd.Function):
    """``xf[tok_of_slot]`` with the empty slots zero; the backward is
    ``fold_slots`` of the slots' gradients."""

    @staticmethod
    def forward(ctx, xf, tok_of_slot, live, rows, dropped):
        ctx.save_for_backward(rows, dropped)
        xe = xf.index_select(0, tok_of_slot)
        return xe.masked_fill_(~live[:, None], 0)

    @staticmethod
    def backward(ctx, g):
        rows, dropped = ctx.saved_tensors
        return fold_slots(g, rows, dropped), None, None, None, None


def gather_tokens(xf, tok_of_slot, live, rows, dropped) -> torch.Tensor:
    """The dispatch gather ``[E*cap, d]`` of ``xf`` ``[n, d]`` (empty
    slots zero), whose backward folds each token's slot gradients in
    ascending expert id (``rows``, ``dropped``: ``assignment_slots``)."""
    return _GatherTokens.apply(xf, tok_of_slot, live, rows, dropped)


def moe_apply(p, x: torch.Tensor, cfg: MoECfg) -> torch.Tensor:
    """x [B, T, d] → [B, T, d]."""
    B, T, d = x.shape
    n_tok = B * T
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(n_tok, d)
    top_p, top_e = route(p, xf, cfg)

    cap = capacity(n_tok, cfg)
    order, _, slot, tok_of_slot, live = dispatch(top_e, cap, E)
    by_e, rows, dropped = assignment_slots(order, slot, top_e, E * cap)
    xe = gather_tokens(xf, tok_of_slot, live, rows, dropped)
    xe = xe.reshape(E, cap, d)

    h = F.silu(torch.bmm(xe, p["gate"])) * torch.bmm(xe, p["up"])
    ye = torch.bmm(h, p["down"]).reshape(E * cap, d)

    # each token's K assignments in ascending expert id, folded into zero
    w = torch.gather(top_p, 1, by_e)
    out = torch.zeros((n_tok, d), dtype=torch.float32, device=x.device)
    for k in range(K):
        c = ye.index_select(0, rows[:, k]).float() * w[:, k, None]
        out = out + torch.where(dropped[:, k, None], 0.0, c)

    if cfg.n_shared:
        sg = torch.sigmoid(xf.float() @ p["shared_gate"])
        out = out + sg * apply_mlp(p["shared"], xf).float()
    return out.reshape(B, T, d).to(x.dtype)
