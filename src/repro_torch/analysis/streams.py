"""Named RNG streams — auditable ``split``/``fold_in`` (simcheck), the
counterpart of ``repro.analysis.streams``.

The engine's RNG-stream topology is part of its result: every tick phase
consumes keys derived from the tick's root along a fixed tree, and
``split`` is not prefix-stable, so widening a split or reordering a
``fold_in`` perturbs every downstream stream.  Every derivation on the tick
path goes through here with the reference's stream names (``carry``,
``gen``, ``spawn``, ``lb``, ``derive``; ``api``/``wait`` in the generator;
the chaos and fabric streams), so the reference's audit holds here too.

Outside an audit ``split`` and ``fold_in`` are the ``random`` calls plus
one ``is None`` check; they add nothing to the tick's device work (keys are
derived on the host, or are ``random.TableKey`` paths).  Inside
:func:`recording` every derivation is logged as a :class:`StreamEvent`
with the named path of its parent key and of its children, so the auditor
can rebuild the stream tree of one tick, find key reuse and path
collisions (:func:`audit_events`), and pin the whole topology under a
digest (:func:`topology_digest`).

Key identity: a ``random.TableKey`` is the stream at ``path`` below its
table's current root, so it is identified by ``(table, path)``; a host key
(an int64 CPU tensor) by its object.  The tick's root is
``KeyTable.root()``, registered as ``"tick"``.  This module must not import
``repro_torch.core`` (the core imports it).
"""
from __future__ import annotations

import contextlib
import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from .. import random as _random

# The active recorder (host-side only; never touched by device work).
_RECORDER: Optional["StreamRecorder"] = None


@dataclass
class StreamEvent:
    """One derivation: ``parent --op(arg)--> children``."""

    parent: str               # named path of the parent key
    op: str                   # "split" | "fold_in"
    arg: object               # split width / fold_in data
    children: Tuple[str, ...]  # named paths of the derived keys


def _ident(key):
    """A key's identity: ``(table, path)`` for a table key, the object
    for any other key."""
    if isinstance(key, _random.TableKey):
        return ("table", id(key.table), key.path)
    return ("key", id(key))


@dataclass
class StreamRecorder:
    """Log of every named derivation plus the key → path map.  Every key
    named here is kept alive (``_keepalive``), so a recycled ``id()`` can
    never misattribute a stream within one audit."""

    events: List[StreamEvent] = field(default_factory=list)
    unnamed: List[str] = field(default_factory=list)
    _paths: dict = field(default_factory=dict)      # identity -> path
    _keepalive: list = field(default_factory=list)

    def register(self, key, path: str) -> None:
        self._paths[_ident(key)] = path
        self._keepalive.append(key)

    def path_of(self, key) -> Optional[str]:
        return self._paths.get(_ident(key))

    def _parent_path(self, key, op: str, arg) -> str:
        path = self.path_of(key)
        if path is None:
            path = f"<unnamed#{len(self.unnamed)}>"
            self.unnamed.append(f"{op}({arg!r}) off an unregistered key — "
                                "wrap the site that derived it")
        return path


class _NamedKeys:
    """Recording view of a host key's ``[num, 2]`` split: indexing
    (negative indices, slices and unpacking too) returns the key rows and
    binds each one read to its declared name."""

    __slots__ = ("_keys", "_names", "_rec", "_parent")

    def __init__(self, keys, names: Tuple[str, ...], rec: StreamRecorder,
                 parent: str):
        self._keys = keys
        self._names = names
        self._rec = rec
        self._parent = parent

    def __len__(self) -> int:
        return len(self._names)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(len(self._names))[i]]
        k = self._keys[i]
        self._rec.register(k, f"{self._parent}/{self._names[i]}")
        return k

    def __iter__(self):
        return (self[i] for i in range(len(self._names)))


def split(key, num: int = 2, *, names: Sequence[str]):
    """``random.split`` with named children (``names`` has ``num``
    distinct entries): the ``[num, 2]`` keys of a host key, or the ``num``
    child streams of a ``random.TableKey``.  Inside an audit a host key's
    split is a :class:`_NamedKeys` view that names its rows as they are
    read."""
    names = tuple(names)
    if len(names) != num:
        raise ValueError(
            f"split(num={num}) needs exactly {num} names, got {names!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"split names must be unique, got {names!r}")
    keys = _random.split(key, num)
    rec = _RECORDER
    if rec is None:
        return keys
    parent = rec._parent_path(key, "split", num)
    rec.events.append(StreamEvent(parent, "split", num,
                                  tuple(f"{parent}/{n}" for n in names)))
    if isinstance(keys, torch.Tensor):
        return _NamedKeys(keys, names, rec, parent)
    for k, n in zip(keys, names):
        rec.register(k, f"{parent}/{n}")
    return keys


def fold_in(key, data: int, *, name: str):
    """``random.fold_in`` with a named child stream."""
    if not name:
        raise ValueError("fold_in needs a stream name")
    child = _random.fold_in(key, data)
    rec = _RECORDER
    if rec is None:
        return child
    parent = rec._parent_path(key, "fold_in", data)
    path = f"{parent}/{name}"
    rec.events.append(StreamEvent(parent, "fold_in", data, (path,)))
    rec.register(child, path)
    return child


@contextlib.contextmanager
def recording():
    """Audit context: every named derivation inside is logged.  Not
    reentrant; the recorder is detached even on error."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("stream recording is already active")
    rec = StreamRecorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None


# ---------------------------------------------------------------------------
# Auditing: reuse/collision detection + the topology digest
# ---------------------------------------------------------------------------

def audit_events(rec: StreamRecorder) -> List[str]:
    """Stream-topology violations in one recorded tick:

    * **key reuse** — two derivations with identical (parent, op, arg):
      their children are the same keys feeding different consumers;
    * **path collision** — two distinct streams bound to one name;
    * **unnamed derivation** — a ``split``/``fold_in`` off a key no named
      site produced (an unwrapped call site upstream).
    """
    problems: List[str] = []
    seen_derivations: dict = {}
    seen_paths: dict = {}
    for i, ev in enumerate(rec.events):
        sig = (ev.parent, ev.op, repr(ev.arg))
        if sig in seen_derivations:
            problems.append(
                f"key reuse: {ev.op}({ev.arg!r}) applied to "
                f"{ev.parent!r} twice (events "
                f"{seen_derivations[sig]} and {i}) — the derived keys "
                "collide bit-for-bit")
        else:
            seen_derivations[sig] = i
        for child in ev.children:
            if child in seen_paths:
                problems.append(
                    f"stream path collision: {child!r} produced by events "
                    f"{seen_paths[child]} and {i}")
            else:
                seen_paths[child] = i
    for msg in rec.unnamed:
        problems.append(f"unnamed stream: {msg}")
    return problems


def topology_lines(rec: StreamRecorder) -> List[str]:
    """One line per derivation, in call order (call order is part of the
    contract: split widths and fold_in positions are what prefix
    instability is sensitive to).  The reference's serialisation."""
    return [f"{ev.parent} --{ev.op}({ev.arg!r})--> [" +
            ", ".join(n.rsplit("/", 1)[-1] for n in ev.children) + "]"
            for ev in rec.events]


def topology_digest(rec: StreamRecorder) -> str:
    """Digest of the stream-derivation tree (16 hex chars), the
    reference's."""
    blob = "\n".join(topology_lines(rec)).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
