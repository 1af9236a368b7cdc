"""Named RNG streams — ``split``/``fold_in`` with a name per child.

The engine's RNG-stream topology is part of its result: every tick phase
consumes keys derived from ``state.rng`` along a fixed tree, and ``split``
is not prefix-stable, so widening a split or reordering a ``fold_in``
perturbs every downstream stream.  Every derivation on the tick path goes
through here with the reference's stream names (``carry``, ``gen``,
``spawn``, ``lb``, ``derive``; ``api``/``wait`` in the generator), so the
reference's stream-topology audit can be ported onto these call sites.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import random as _random


def split(key: torch.Tensor, num: int = 2, *,
          names: Sequence[str]) -> torch.Tensor:
    """``random.split`` with named children (``names`` has ``num``
    distinct entries); returns the ``[num, 2]`` keys, or of a
    ``random.TableKey`` its ``num`` child streams."""
    names = tuple(names)
    if len(names) != num:
        raise ValueError(
            f"split(num={num}) needs exactly {num} names, got {names!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"split names must be unique, got {names!r}")
    return _random.split(key, num)


def fold_in(key: torch.Tensor, data: int, *, name: str) -> torch.Tensor:
    """``random.fold_in`` with a named child stream."""
    if not name:
        raise ValueError("fold_in needs a stream name")
    return _random.fold_in(key, data)
