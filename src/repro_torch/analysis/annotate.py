"""Checked mode: run-time checks of the tick's declared-disjoint scatters,
the counterpart of ``repro.analysis.annotate``'s ``REPRO_CHECKED=1``.

Two scatters of the tick write to indices that are distinct by
construction, which no cheap static argument can show: the spawn writer
``pool.scatter_pool`` (free-slot compaction) and the dispatch table of
``policies.eject_view`` (a prefix ranking per row).  On the card a
duplicate index in ``index_copy_``/``scatter_`` gives an unspecified
winner, not a reproducible one, so under ``REPRO_CHECKED=1`` both sites
check their indices at run time, with the reference's messages
(:data:`CHECKS`).

A check never synchronises inside the tick: it ORs a bit into an int32
error word on the device (:func:`check`).  ``engine.TickLoop`` holds the
word beside its buffers and opens it around every step
(:func:`collecting`), so a replayed checked tick is still one CUDA graph;
the run reads the word once after its loop and raises the first violated
check (:func:`throw`) — the counterpart of the reference's ``checkify``
error carried through the scan and thrown after ``run``.  A check made
with no word open (a phase function called on its own) raises at once.
Unchecked, the sites issue no check operation at all.

The reference's ``collide``/``disjoint`` scopes are metadata for its
interval verifier, which is not ported; they are not here either.
"""
from __future__ import annotations

import contextlib
import os
from typing import List

import torch

# The reference's checkify messages, word for word; bit i of the error
# word is CHECKS[i].
CHECKS = ("scatter_pool: duplicate destination slot",
          "scatter_pool: live destination out of range",
          "eject_view: duplicate compaction target")

_WORDS: List[torch.Tensor] = []


class CheckError(RuntimeError):
    """A declared invariant of the tick failed under ``REPRO_CHECKED=1``."""


def checked_mode() -> bool:
    """True when ``REPRO_CHECKED=1``.  Read as the tick runs (and so when
    it is captured); the engine's capture cache keys on it."""
    return os.environ.get("REPRO_CHECKED", "") == "1"


def new_word(device) -> torch.Tensor:
    """A cleared error word on ``device``."""
    return torch.zeros((), dtype=torch.int32, device=device)


@contextlib.contextmanager
def collecting(word: torch.Tensor):
    """Checks made inside the block OR their bits into ``word`` (a 0-d
    int32 tensor) instead of raising."""
    _WORDS.append(word)
    try:
        yield word
    finally:
        _WORDS.pop()


def check(ok: torch.Tensor, message: str) -> None:
    """Record that ``ok`` must hold everywhere (``message`` one of
    :data:`CHECKS`): into the open error word, without reading anything
    back, or, with no word open, at once."""
    bit = 1 << CHECKS.index(message)
    if _WORDS:
        word = _WORDS[-1]
        word.bitwise_or_((~ok.all()).to(torch.int32) * bit)
    elif not bool(ok.all()):
        raise CheckError(message)


def violated(word: torch.Tensor) -> List[str]:
    """The checks whose bits ``word`` holds (one read of the device)."""
    bits = int(word)
    return [m for i, m in enumerate(CHECKS) if bits >> i & 1]


def throw(word: torch.Tensor) -> None:
    """Raise the first violated check of ``word``, if any."""
    bad = violated(word)
    if bad:
        raise CheckError(bad[0])
