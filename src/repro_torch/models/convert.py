"""Carry the reference's parameter tree across: ``params_from_numpy``
turns nested dicts of numpy arrays (the JAX package's parameters, each
leaf through ``np.asarray``) into the port's tree of tensors.

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


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(resolve_device(device))


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """The port's parameter tree on ``device`` from nested dicts of numpy
    arrays keyed as the reference's schema."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
