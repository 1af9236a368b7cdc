"""AdamW from scratch with mixed precision (the reference's
``repro.train.optimizer``): bfloat16 (or float32) parameters, float32
moments, the update in float32 cast back to each parameter's type.

The arithmetic is that of the reference's jitted step (``jax.jit`` of
``adamw_update`` on the CPU), so that the same gradients give the same
bits.  XLA rewrites the program before it runs it, and the port writes
the rewritten form:

* a division by a constant is a multiply by its float32 reciprocal
  (``step / warmup`` → ``step · f32(1/warmup)``), and constant factors
  fold (``0.9 · (0.5 · x)`` → ``x · 0.45``);
* ``mhat / (sqrt(vhat) + eps)`` with ``mhat = mu / bc1`` is
  ``mu / (bc1 · (sqrt(nu / bc2) + eps))``;
* multiply-add pairs are fused (``numerics.fma32``): ``mu·b1 + (1-b1)·g``,
  ``nu·b2 + ((1-b2)·g)·g``, ``pf·wd + d`` and ``pf - lr·t``, and the
  schedule's ``(cos + 1)·K + min_lr_frac``;
* ``b ** step`` and ``cos`` are the C library's ``powf`` and ``cosf``
  (``numerics.pow32``, ``numerics.cos32``).

``clip_by_global_norm`` sums the leaves in ``jax.tree_util`` order
(sorted dict keys).  On the CPU each leaf's sum of squares follows XLA's
tree reduction (windows of 32 along every dimension longer than 32,
summed in row-major order, until no dimension is; then the rest in
row-major order): that is the reference's order for every 1-d leaf and
wherever LLVM keeps the loops' order; for some multi-dimensional shapes
(a minor extent of 4 or 8, small final reductions) its vectoriser
re-associates a reduction loop, and a leaf's sum moves by a few ulp
(``tests/test_torch_train_opt.py`` lists shapes of both kinds).  On the
card the sums are ``torch.sum``'s over chunks of ``CHUNK`` elements, added
in order (float32, deterministic).

DTensor leaves (a state placed on a mesh by ``ckpt.elastic`` or the dry
run's ``launch.specs``): the moments take their parameter's placements
(ZeRO-1, as the reference's moments follow the parameter sharding), each
gradient is first laid out as its parameter (a partial sum reduced), and
the update runs on each leaf's local shard: it is elementwise, so every
shard gets the bits the unsharded update gives its elements.  A leaf's sum
of squares is its local shard's, chunk by chunk as on the card, summed
over the mesh dims that shard it (an all-reduce); the norm's bits then
depend on the layout.  Plain tensors keep the paths above.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ..dist.sharding import is_dtensor
from ..numerics import cos32, fma32, pow32
from ..random import _sqrt32
from ..tree import tree_leaves, tree_map, tree_unzip

# the elementwise update runs over flat chunks of this many elements, so
# its float64 temporaries (``fma32``: a few GB at 2^26) stay bounded
# beside a large leaf; larger chunks mean fewer launches a step
CHUNK = 1 << 26


def _f32(x: float) -> float:
    return float(np.float32(x))


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any                 # float32 tree like params
    nu: Any                 # float32 tree like params


@dataclasses.dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def _wrap_like(p, local: torch.Tensor):
    """``local`` as a DTensor laid out as ``p`` (a shard of the same global
    shape; no communication)."""
    return type(p).from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def _zeros_f32(p):
    if is_dtensor(p):
        loc = p.to_local()
        return _wrap_like(p, torch.zeros(loc.shape, dtype=torch.float32,
                                         device=loc.device))
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params) -> AdamWState:
    """Zero moments (float32) beside every parameter, laid out as it, step
    0 on the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(_zeros_f32, params),
                      nu=tree_map(_zeros_f32, params))


def _rcp(c: float) -> float:
    """float32 1 / c, as XLA folds a division by the constant c."""
    return float(np.float32(1.0) / np.float32(c))


def lr_schedule(step: torch.Tensor, cfg: AdamWCfg) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (0-d float32 on
    the step's device)."""
    s = step.float()
    warm = torch.clamp_max(s * _rcp(max(cfg.warmup_steps, 1)), 1.0)
    prog = (s - _f32(cfg.warmup_steps)) \
        * _rcp(max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = torch.clamp_max(torch.clamp_min(prog, 0.0), 1.0)
    cos = cos32(prog * _f32(math.pi))
    half = _f32(1 - cfg.min_lr_frac) * 0.5
    frac = fma32(cos + 1.0, half, _f32(cfg.min_lr_frac))
    return (warm * _f32(cfg.lr)) * frac


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum of every element of a CPU tensor in the order of XLA's
    CPU tree reduction (see the module's docstring).  Each window is
    summed left to right by numpy's ``add.accumulate`` (a sequential
    float32 loop); the zero padding adds exactly 0."""
    a = x.detach().numpy()
    while any(d > 32 for d in a.shape):
        pads, outer, inner = [], [], []
        for d in a.shape:
            m = -(-d // 32) if d > 32 else 1
            p = 32 * m - d if d > 32 else 0
            pads.append((p // 2, p - p // 2))
            outer.append(m)
            inner.append(32 if d > 32 else d)
        nd = a.ndim
        a = np.pad(a, pads).reshape(
            [n for pair in zip(outer, inner) for n in pair])
        a = a.transpose(*range(0, 2 * nd, 2), *range(1, 2 * nd, 2)) \
            .reshape(math.prod(outer), math.prod(inner))
        a = np.add.accumulate(a, axis=1)[:, -1].reshape(outer)
    return torch.from_numpy(np.add.accumulate(a.reshape(-1))[-1:].copy()) \
        .reshape(())


def _chunked_sum_squares(leaf: torch.Tensor) -> torch.Tensor:
    # chunk by chunk (``CHUNK`` elements, summed in order): a float32 copy
    # of a stacked expert leaf would be gigabytes
    flat = leaf.reshape(-1)
    s = None
    for a in range(0, flat.numel(), CHUNK):
        c = flat[a:a + CHUNK].float()
        s = torch.sum(c * c) if s is None else s + torch.sum(c * c)
    return s


def _sum_squares(leaf: torch.Tensor) -> torch.Tensor:
    if is_dtensor(leaf):
        return _dist_sum_squares(leaf)
    if leaf.device.type == "cpu":
        return xla_sum(leaf.float() * leaf.float())
    return _chunked_sum_squares(leaf)


def _dist_sum_squares(leaf) -> torch.Tensor:
    """A DTensor leaf's sum of squares (a plain 0-d tensor on every
    rank): its local shard's, all-reduced over the mesh dims that shard
    it (a partial leaf is reduced first)."""
    from torch.distributed.tensor import Partial, Replicate
    if any(p.is_partial() for p in leaf.placements):
        leaf = leaf.redistribute(leaf.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in leaf.placements))
    local = _chunked_sum_squares(leaf.to_local())
    part = tuple(Partial() if p.is_shard() else Replicate()
                 for p in leaf.placements)
    return type(leaf).from_local(local, leaf.device_mesh, part,
                                 run_check=False).full_tensor()


def global_norm(grads) -> torch.Tensor:
    """The gradients' global norm (0-d float32), the leaves' sums of
    squares added in tree order."""
    sq = None
    for leaf in tree_leaves(grads):
        s = _sum_squares(leaf)
        sq = s if sq is None else sq + s
    return _sqrt32(sq)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor numerator: ``number / tensor`` is a reciprocal and a
    # multiply in PyTorch, two roundings
    num = torch.full((), _f32(max_norm), device=gnorm.device)
    return torch.clamp_max(num / torch.clamp_min(gnorm, _f32(1e-9)), 1.0)


def _clip(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / |grads|) (float32 math, the
    leaf's type kept); returns (clipped tree, global norm)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: _clip(g, scale), grads), gnorm


def _update_chunk(p, g, mu, nu, cfg, lr, bc1, bc2):
    gf = g.float()
    mu_n = fma32(mu, _f32(cfg.b1), gf * _f32(1 - cfg.b1))
    nu_n = fma32(nu, _f32(cfg.b2), (gf * _f32(1 - cfg.b2)) * gf)
    d = mu_n / (bc1 * (_sqrt32(nu_n / bc2) + _f32(cfg.eps)))
    pf = p.float()
    t = fma32(pf, _f32(cfg.weight_decay), d)
    return fma32(t, -lr, pf).to(p.dtype), mu_n, nu_n


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _layout_as(g, p):
    """A DTensor gradient laid out as its parameter (a partial sum reduced
    or scattered); anything else as it is."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def adamw_update(params, grads, state: AdamWState, cfg: AdamWCfg,
                 donate: bool = False):
    """One AdamW step: returns (params, state, {"lr", "grad_norm"}), the
    metrics as 0-d float32 tensors on the device (no host read).  The
    gradients are clipped chunk by chunk inside the update (the bits of
    ``clip_by_global_norm``'s leaves, without a clipped copy of the
    tree).  ``donate``: the new parameters and moments are written into
    the given ones' storage (the caller's ``params`` and ``state`` are
    consumed, as buffers donated to a jitted step), so the step holds one
    copy of the state, not two."""
    grads = tree_map(_layout_as, grads, params)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    lr = lr_schedule(_local(step), cfg)
    s = _local(step).float()
    one = torch.ones((), dtype=torch.float32, device=s.device)
    bc1 = 1.0 - pow32(one * _f32(cfg.b1), s)
    bc2 = 1.0 - pow32(one * _f32(cfg.b2), s)

    def upd(p, g, mu, nu):
        if is_dtensor(p):
            out = upd(p.to_local(), g.to_local(), mu.to_local(),
                      nu.to_local())
            return tuple(_wrap_like(t, o) for t, o in zip((p, mu, nu), out))
        if donate:
            out, mu_o, nu_o = p, mu, nu
        else:
            out = torch.empty_like(p)
            mu_o, nu_o = torch.empty_like(mu), torch.empty_like(nu)
        flat = [t.reshape(-1) for t in (p, g, mu, nu, out, mu_o, nu_o)]
        for a in range(0, p.numel(), CHUNK):
            pc, gc, mc, nc, oc, mo, no = (t[a:a + CHUNK] for t in flat)
            r = _update_chunk(pc, _clip(gc, scale), mc, nc, cfg, lr, bc1,
                              bc2)
            oc.copy_(r[0])
            mo.copy_(r[1])
            no.copy_(r[2])
        return out, mu_o, nu_o

    new_p, mu, nu = tree_unzip(
        tree_map(upd, params, grads, state.mu, state.nu), 3)
    return new_p, AdamWState(step=step, mu=mu, nu=nu), \
        {"lr": lr, "grad_norm": gnorm}
