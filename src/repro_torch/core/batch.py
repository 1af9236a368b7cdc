"""The batch axis of the tick.

Inside the tick every state leaf, every ``AppStatic`` table and every
``DynParams`` value carries a leading axis ``B``, one row per point of a
parameter sweep (``Simulation.run_batch``): a pool is ``[B, C]``, a
counter ``[B]``, a swept scalar ``[B]``.  A solo run is a batch of one.
The state's PRNG key is the one leaf without the axis: every point of a
sweep starts from the same seed, so one key schedule serves them all.

``lift`` puts a batch axis in front of a solo container, ``item``
takes point ``b`` out of a batched one, and ``solo_as_batch`` lets a
phase function take solo arguments (as the per-phase parity tests give
it): it lifts them, runs the batched phase and strips the axis from what
the phase returns.
"""
from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

from .types import _F32_FIELDS, Cloudlets, DynParams, SimState


def _named(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def lift(x, B: int = 1):
    """``x`` with a batch axis of ``B`` in front of every tensor leaf (a
    broadcast view: each point sees the same values; a state's host key
    and anything that is not a tensor left alone)."""
    if isinstance(x, torch.Tensor):
        return x.unsqueeze(0).expand((B,) + tuple(x.shape))
    if isinstance(x, Cloudlets):
        return Cloudlets(lift(x.ints, B), lift(x.flts, B), x.layout)
    if isinstance(x, SimState):
        return SimState(*[v if f == "rng" else lift(v, B)
                          for f, v in zip(x._fields, x)])
    if _named(x):
        return type(x)(*[lift(v, B) for v in x])
    return x


def item(x, b: int):
    """Point ``b`` of a batched container: every tensor leaf indexed by
    ``b`` along its batch axis (a state's key only where it has one)."""
    if isinstance(x, torch.Tensor):
        return x[b]
    if isinstance(x, Cloudlets):
        return Cloudlets(x.ints[b], x.flts[b], x.layout)
    if isinstance(x, SimState):
        return SimState(*[(v[b] if v.dim() == 2 else v) if f == "rng"
                          else item(v, b) for f, v in zip(x._fields, x)])
    if _named(x):
        return type(x)(*[item(v, b) for v in x])
    if isinstance(x, tuple):
        return tuple(item(v, b) for v in x)
    return x


def dyn_host(dyn: DynParams) -> DynParams:
    """``dyn`` (one point's scalars, or ``[B]`` arrays or tensors) as
    ``[B]`` numpy arrays of each field's dtype."""
    host = lambda v: v.detach().cpu().numpy() \
        if isinstance(v, torch.Tensor) else np.asarray(v)
    return DynParams(*[np.asarray(host(v), np.float32 if f in _F32_FIELDS
                                  else np.int32).reshape(-1)
                       for f, v in zip(DynParams._fields, dyn)])


def dyn_tensors(dyn: DynParams, device) -> DynParams:
    """``dyn``'s values as ``[B]`` tensors on ``device``."""
    return DynParams(*[torch.from_numpy(v).to(device)
                       for v in dyn_host(dyn)])


def solo_as_batch(probe: str, *tensors: str):
    """Decorate a phase function so that it also takes solo arguments.
    ``probe`` names the argument that tells them apart: a state (solo
    when its ``tick`` is 0-d) or a tensor (solo when 0-d).  For a solo
    call the state, every container of tensors and the tensor arguments
    named in ``tensors`` are lifted to a batch of one, ``DynParams``
    become ``[1]`` tensors, and the result comes back without the
    axis."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            p = bound.arguments[probe]
            t = p.tick if isinstance(p, SimState) else p
            if t.dim() != 0:
                return fn(*args, **kwargs)
            for name, v in bound.arguments.items():
                if isinstance(v, DynParams):
                    bound.arguments[name] = dyn_tensors(v, t.device)
                elif name in tensors or isinstance(v, (SimState, Cloudlets)) \
                        or (_named(v) and all(isinstance(u, torch.Tensor)
                                              for u in v)):
                    bound.arguments[name] = lift(v)
            return item(fn(*bound.args, **bound.kwargs), 0)
        return wrapper
    return deco
