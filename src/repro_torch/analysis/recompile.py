"""Capture sentinel — captures and builds across runs must be zero once
warm; the counterpart of ``repro.analysis.recompile``.

The port's compile-once contract: on the card a run replays CUDA graphs
captured at the first run of a structure and kept in a cache of the class
(``Simulation._graphs``), keyed by the structure only — caps, the static
knobs, the device, the number of points, the scaling cadence's variants,
the leaf shapes of the state and of the application, checked mode.  Swept
values, the application's values and the seed travel in the loop's
buffers.  The contract breaks silently the moment a value that should be
a buffer enters the key, or a tick reads a knob the key leaves out: every
sweep point or every new ``Simulation`` then pays a capture (or, worse,
replays another instance's value).

The sentinel runs a **warm pass** — each golden combo solo and as an
``n``-point ``run_batch`` — then a **counting pass** over fresh
``Simulation`` objects (the cache must hit across instances), with
``seed + 1`` and perturbed sweep values, in the same shapes.  On the card
it counts CUDA-graph captures (``engine.TickGraphs`` constructions) and
kernel builds (``nvcc`` runs of ``kernels._build``); on the CPU, where
nothing is captured, it counts the misses of the capture-cache key
(``Simulation._capture_key``, the key the card's cache uses) against the
keys seen so far.  The counting pass must count 0 of each.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional

import torch


@dataclasses.dataclass
class Counts:
    """What one pass made: captures (on the CPU: capture-key misses) and
    kernel builds."""

    captures: int = 0
    builds: int = 0


@contextlib.contextmanager
def count_captures(device, seen: Optional[set] = None) -> Iterator[Counts]:
    """Count the captures and kernel builds made inside the block on
    ``device``.  On the CPU a capture is a run whose capture-cache key is
    not in ``seen`` (which the block extends: pass one set to a warm and
    a counting pass)."""
    from ..core import engine
    from ..kernels import _build
    counts = Counts()
    cuda = torch.device(device).type == "cuda"
    seen = set() if seen is None else seen

    def watch(key) -> None:
        if key not in seen:
            seen.add(key)
            if not cuda:
                counts.captures += 1

    c0, b0 = engine.TickGraphs.captures, _build.builds
    engine.KEY_WATCHERS.append(watch)
    try:
        yield counts
    finally:
        engine.KEY_WATCHERS.remove(watch)
        if cuda:
            counts.captures = engine.TickGraphs.captures - c0
        counts.builds = _build.builds - b0


@dataclasses.dataclass
class SentinelReport:
    warm: Counts
    counting: Counts
    device: str

    @property
    def what(self) -> str:
        return ("captures" if self.device.startswith("cuda")
                else "capture-key misses")

    @property
    def problems(self) -> List[str]:
        c = self.counting
        if c.captures or c.builds:
            return [
                f"recompile: {c.captures} {self.what} and {c.builds} kernel "
                f"build(s) in the counting pass (warm pass: "
                f"{self.warm.captures} and {self.warm.builds}) — some value "
                "that should travel in the loop's buffers (a DynParams "
                "field, the application) is in the capture key, or a "
                "fresh Simulation misses the class's cache"]
        return []


def sweep_points(params, n_points: int = 8, offset: float = 0.0):
    """``n_points`` copies of ``params`` with perturbed swept values."""
    return [dataclasses.replace(params,
                                spawn_rate=params.spawn_rate
                                + 0.5 * i + offset,
                                slo_ms=params.slo_ms + 10.0 * i + offset)
            for i in range(n_points)]


GOLDEN_COMBOS = (("uniform", "none"), ("uniform", "chaos"),
                 ("fabric", "none"), ("fabric", "chaos"))


def run_sentinel(n_points: int = 8, device="cuda") -> SentinelReport:
    """Warm-then-count over the four golden combos and an ``n_points``
    sweep of each."""
    from .layout_check import _tiny_sim

    seen: set = set()
    with count_captures(device, seen) as warm:
        for net, fl in GOLDEN_COMBOS:
            sim = _tiny_sim(net, fl, False, device=device)
            sim.run()
            sim.run_batch(sweep_points(sim.params, n_points))

    with count_captures(device, seen) as cold:
        for net, fl in GOLDEN_COMBOS:
            # fresh Simulation objects: the cache must hit across
            # instances, not just across calls on one instance
            sim = _tiny_sim(net, fl, False, device=device)
            sim.run(seed=sim.params.seed + 1)     # seed is not a cache key
            sim.run_batch(sweep_points(sim.params, n_points, offset=0.25),
                          seed=sim.params.seed + 1)

    return SentinelReport(warm=warm, counting=cold, device=str(device))
