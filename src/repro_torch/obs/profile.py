"""Per-phase time attribution (§9), the port's counterpart of the
reference's ``repro.obs.profile``.

The reference times *prefix programs* (the tick cut after each phase) and
differences their walls, since XLA fuses the whole tick into one
executable.  A replayed CUDA graph has no such cut, but the eager tick
calls a probe at every phase boundary (``make_tick``'s ``probe``; the
Disruption phase's stages too).  So here the tick runs eagerly under a
probe that records a clock at each mark — a CUDA event on the card,
``time.perf_counter`` on the CPU — and each interval between two marks
goes to the label whose prefix cut covers it in the reference:

* a phase's own interval to the phase;
* the Telemetry span pass (after Execute) to ``"Alerting"`` when
  alerting is on (the reference's Alerting cut covers it), else to the
  next label (``"Derive"``, or ``"Response"`` without edges);
* the Trace, the window close and the loop's own work between ticks
  (the state write-back, the telemetry flushes) to ``"Trace+rest"``.

``wall_s`` of a row is the time of the phases up to and including it
(the reference's prefix wall), ``delta_s`` the row's own.  Times are of
the eager tick, which issues the same device work as the replayed one
plus its launch overhead.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.engine import Simulation
from ..core.faults import DISRUPTION_STAGES


@dataclasses.dataclass
class PhaseCost:
    """One row of a profile: the time attributed to ``label``."""

    label: str
    wall_s: float     # time of the phases through this one
    delta_s: float    # this row's own time
    share: float      # delta_s / the total


def tick_phases(sim: Simulation) -> List[str]:
    """The phases this sim's mode combination runs, in tick order: the
    reference's labels."""
    p = sim.params
    ph = ["Generation"]
    if p.faults == "chaos":
        ph.append("Disruption")
    if p.network == "fabric":
        ph.append("Transit")
    ph += ["Dispatch", "Execute"]
    if p.telemetry == "stream" and p.alerting == "burn":
        # the Alerting label also covers the Telemetry span pass
        ph.append("Alerting")
    if sim._has_edges:
        ph.append("Derive")
    ph.append("Response")
    if p.scaling_policy or p.migration_enabled:
        ph.append("Scaling")
    return ph


class _Clock:
    """A probe that records (mark, clock) at every call."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def __call__(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, _time.perf_counter()))

    def intervals(self) -> list:
        """(mark, seconds to the next mark) for every mark but the last."""
        if self.cuda:
            torch.cuda.synchronize()
            dt = lambda a, b: a.elapsed_time(b) / 1e3
        else:
            dt = lambda a, b: b - a
        return [(name, dt(a, b)) for (name, a), (_, b)
                in zip(self.marks, self.marks[1:])]


def _phase_label(sim: Simulation):
    """Mark → label of ``phase_breakdown`` (``None``: not attributed)."""
    phases = tick_phases(sim)
    after_exec = phases[phases.index("Execute") + 1]
    state = {"traced": False}

    def label(mark: str) -> Optional[str]:
        if mark == "Generation":
            state["traced"] = False
        if mark in ("Trace", "end"):
            state["traced"] = True
            return "Trace+rest"
        if mark == "Telemetry":
            return "Trace+rest" if state["traced"] else after_exec
        return mark.split("/", 1)[0]

    return label


def _stage_label(mark: str) -> Optional[str]:
    """Mark → label of ``disruption_breakdown``."""
    if mark == "Disruption":
        return DISRUPTION_STAGES[0]
    if mark.startswith("Disruption/"):
        return mark.split("/", 1)[1]
    return None


def _attribute(sim: Simulation, n_ticks: int, reps: int, labels: list,
               label_of) -> Dict[str, float]:
    """Seconds per label over ``n_ticks`` eager ticks from a fresh state,
    the least of ``reps`` runs for each label."""
    best = {k: float("inf") for k in labels}
    for _ in range(max(reps, 1)):
        clock = _Clock(sim.device)
        sim.run_state(sim.init_state(), n_ticks=n_ticks, probe=clock)
        tot = dict.fromkeys(labels, 0.0)
        for mark, sec in clock.intervals():
            k = label_of(mark)
            if k in tot:
                tot[k] += sec
        for k in labels:
            best[k] = min(best[k], tot[k])
    return best


def _rows(labels: list, times: Dict[str, float]) -> List[PhaseCost]:
    total = max(sum(times.values()), 1e-12)
    out, wall = [], 0.0
    for k in labels:
        wall += times[k]
        out.append(PhaseCost(label=k, wall_s=wall, delta_s=times[k],
                             share=times[k] / total))
    return out


def phase_breakdown(sim: Simulation, reps: int = 3,
                    n_ticks: Optional[int] = None) -> List[PhaseCost]:
    """Time per tick phase over ``n_ticks`` eager ticks (default
    ``params.n_ticks``), the least of ``reps`` runs: the labels of
    :func:`tick_phases` and a final ``"Trace+rest"``."""
    T = n_ticks or sim.params.n_ticks
    labels = tick_phases(sim) + ["Trace+rest"]
    return _rows(labels, _attribute(sim, T, reps, labels, _phase_label(sim)))


def disruption_breakdown(sim: Simulation, reps: int = 3,
                         n_ticks: Optional[int] = None) -> List[PhaseCost]:
    """Time per stage inside the Disruption phase (``DISRUPTION_STAGES``,
    then the outlier ejection that ends the phase)."""
    if sim.params.faults != "chaos":
        raise ValueError("disruption_breakdown needs faults='chaos'")
    T = n_ticks or sim.params.n_ticks
    labels = list(DISRUPTION_STAGES) + ["ejection"]
    return _rows(labels, _attribute(sim, T, reps, labels, _stage_label))


def format_table(costs: List[PhaseCost], title: str = "phase") -> str:
    """Markdown cost table (DESIGN.md §7 / example output)."""
    lines = [f"| {title} | prefix wall (s) | delta (s) | share |",
             "|---|---|---|---|"]
    for c in costs:
        lines.append(f"| {c.label} | {c.wall_s:.4f} | {c.delta_s:+.4f} "
                     f"| {100.0 * c.share:+.1f}% |")
    return "\n".join(lines)


def profile_np(costs: List[PhaseCost]) -> np.ndarray:
    """[n, 3] (wall, delta, share) float64 — programmatic consumers."""
    return np.array([[c.wall_s, c.delta_s, c.share] for c in costs],
                    np.float64)
