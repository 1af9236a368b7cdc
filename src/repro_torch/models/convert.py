"""Carry the reference's trees across: ``params_from_numpy`` turns nested
dicts of numpy arrays (the JAX package's parameters, each leaf through
``np.asarray``) into the port's tree of tensors, ``decode_state_from_numpy``
a decode state of the reference into the port's, ``opt_state_from_numpy``
an ``AdamWState``; ``tree_to_numpy`` takes a port tree back to numpy
(bfloat16 leaves as the ``ml_dtypes`` type when the caller names it,
else as their uint16 view), for comparison with the reference's.

A JAX bfloat16 array comes to numpy as the ``ml_dtypes`` bfloat16 type,
which ``torch.from_numpy`` refuses; such a leaf (found by its dtype's
name, so the port needs no ``ml_dtypes``) is carried bit for bit through
its uint16 view.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.types import resolve_device
from ..tree import tree_map
from .attention import KVCache, QuantKVCache
from .encdec import EncDecState
from .mamba2 import MambaState
from .transformer import DecodeState


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(resolve_device(device))


def opt_state_from_numpy(state, device="cuda"):
    """The port's ``AdamWState`` from the reference's (its leaves through
    ``np.asarray``; the same field names)."""
    from ..train.optimizer import AdamWState
    return AdamWState(step=tensor_from_numpy(state.step, device),
                      mu=params_from_numpy(state.mu, device),
                      nu=params_from_numpy(state.nu, device))


def tree_to_numpy(tree: Any, bf16_dtype=None) -> Any:
    """A port tree (dicts, named tuples, tensors) as numpy on the host;
    a bfloat16 leaf as ``bf16_dtype`` (e.g. ``ml_dtypes.bfloat16``, bit
    for bit) or, without one, as its uint16 view."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            u16 = t.view(torch.int16).numpy().view(np.uint16)
            return u16 if bf16_dtype is None else u16.view(bf16_dtype)
        return t.numpy()
    return tree_map(one, tree)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """The port's parameter tree on ``device`` from nested dicts of numpy
    arrays keyed as the reference's schema."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


_CACHES = {c.__name__: c for c in (KVCache, QuantKVCache, MambaState)}


def decode_state_from_numpy(state, device="cuda"):
    """The port's decode state on ``device`` from the reference's (its
    leaves through ``np.asarray``, its named tuples kept): an
    ``EncDecState`` as it is, a ``DecodeState``'s stacked layer caches
    (``KVCache``, ``QuantKVCache``, ``MambaState``) cut into the port's
    per-layer list, the hybrid's stacked periods into its per-period
    dicts.  The reference's per-layer ``pos`` leaves, zeros it
    overwrites every step, are dropped."""
    t = lambda a: tensor_from_numpy(a, device)
    if type(state).__name__ == "EncDecState":
        return EncDecState(
            self_kv=KVCache(k=t(state.self_kv.k), v=t(state.self_kv.v)),
            cross_kv={n: t(state.cross_kv[n]) for n in ("k", "v")},
            pos=t(state.pos))
    if isinstance(state.layers, dict):
        # the hybrid's: {"kv": KVCache over periods, "mamba": MambaState
        # over periods and their Mamba layers} → one dict a period
        kv, ms = state.layers["kv"], state.layers["mamba"]
        layers = [{"kv": KVCache(k=t(kv.k[p]), v=t(kv.v[p])),
                   "mamba": [MambaState(h=t(ms.h[p, j]),
                                        conv=t(ms.conv[p, j]))
                             for j in range(ms.h.shape[1])]}
                  for p in range(kv.k.shape[0])]
        return DecodeState(layers=layers, pos=t(state.pos))
    cls = _CACHES[type(state.layers).__name__]
    stacked = {f: getattr(state.layers, f) for f in cls._fields}
    n_layers = len(stacked[cls._fields[0]])
    layers = [cls(**{f: t(a[i]) for f, a in stacked.items()})
              for i in range(n_layers)]
    return DecodeState(layers=layers, pos=t(state.pos))
