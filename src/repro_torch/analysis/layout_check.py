"""Layout-access checker — ``PHASE_COLUMNS`` against what the tick touches,
the counterpart of ``repro.analysis.layout_check``.

``PHASE_COLUMNS`` declares which pool columns each tick phase reads and
writes, and ``resolve_layout`` shrinks the stacked pool to the union of the
declared sets.  This checker replays one tick eagerly (``engine.TickLoop``'s
step) on a tiny diamond-graph sim with

* a **recording layout proxy** in place of the ``PoolLayout`` carried by
  ``Cloudlets`` — every ``layout.i(name)`` / ``layout.f(name)`` lookup
  (the funnel every named read and every ``with_cols`` write goes
  through) is logged, and ``i_fields``/``f_fields`` block reads (only
  ``pool.scatter_pool`` makes them) are logged as whole-row *spawn*
  writes;
* the tick's ``probe`` attributing each access to the phase that runs
  (a Disruption stage ``"Disruption/<stage>"`` to Disruption).

The reference replays under ``lax.cond``, which traces both scaling
branches, so its Scaling phase records on a tick that is not due; the
port's tick branches in Python, so the replay runs the scaling variant of
the step (``scale_due=True``), or the Scaling phase would record nothing.

Rules (per mode combo, then unioned where noted), the reference's:

* **undeclared-access** — a named access in a registry phase to a column
  outside that phase's declared set fails (spawn writes are exempt);
* **declared-but-never-touched** — a declared column no combo touches in
  that phase fails, on the union across all combos;
* **non-registry phases** (Response/Scaling/Trace) stay inside the
  always-on core columns;
* **spawns** occur only in the three phases that respawn rows
  (Generation, Derive, Disruption).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple

from .. import random as rnd
from ..core import SimCaps, SimParams, Simulation, diamond
from ..core.engine import TickLoop, carry_path
from ..core.types import (PHASE_COLUMNS, Cloudlets, DynParams,
                          resolve_layout)

# (network, faults, egress_shaping, telemetry) combos replayed: the four
# golden combos, the egress-shaping variant, the telemetry combo and the
# alerting combo ("alert": stream + alerting="burn"), as the reference's.
COMBOS: Tuple[Tuple[str, str, bool, object], ...] = (
    ("uniform", "none", False, False),
    ("uniform", "chaos", False, False),
    ("fabric", "none", False, False),
    ("fabric", "chaos", False, False),
    ("fabric", "chaos", True, False),
    ("fabric", "chaos", False, True),
    ("fabric", "chaos", False, "alert"),
)

# Registry sub-entries ("Phase/feature") activate with these flags.
_FEATURE_ON = {
    "chaos": lambda net, fl, eg, tel: fl == "chaos",
    "fabric": lambda net, fl, eg, tel: net == "fabric",
    "egress_shaping": lambda net, fl, eg, tel: eg,
}

_SPAWN_PHASES = ("Generation", "Derive", "Disruption")


class RecordingLayout:
    """Duck-typed ``PoolLayout`` stand-in that logs column accesses.

    Delegates every lookup to the wrapped layout, so the replayed tick
    computes what it would with the real one; ``__contains__`` and
    ``columns`` stay unrecorded (a skip decision or a validation sweep is
    not an access)."""

    def __init__(self, inner, log: "AccessLog"):
        self._inner = inner
        self._log = log

    def i(self, name: str) -> int:
        self._log.touch(name, "named")
        return self._inner.i(name)

    def f(self, name: str) -> int:
        self._log.touch(name, "named")
        return self._inner.f(name)

    @property
    def i_fields(self):
        for n in self._inner.i_fields:
            self._log.touch(n, "spawn")
        return self._inner.i_fields

    @property
    def f_fields(self):
        for n in self._inner.f_fields:
            self._log.touch(n, "spawn")
        return self._inner.f_fields

    @property
    def columns(self):
        return self._inner.columns

    def __contains__(self, name: str) -> bool:
        return name in self._inner

    def init_ints(self):
        return self._inner.init_ints()

    def init_flts(self):
        return self._inner.init_flts()


@dataclasses.dataclass
class AccessLog:
    """phase → {(column, kind)}, with the probe's phase cursor."""

    phase: str = "<init>"
    accesses: Dict[str, Set[Tuple[str, str]]] = \
        dataclasses.field(default_factory=dict)

    def probe(self, phase: str) -> None:
        self.phase = "<end>" if phase == "end" else phase.split("/", 1)[0]

    def touch(self, column: str, kind: str) -> None:
        self.accesses.setdefault(self.phase, set()).add((column, kind))


def _tiny_sim(network: str, faults: str, egress: bool,
              telemetry: bool | str = False, device="cuda") -> Simulation:
    """The reference's tiny diamond sim of one mode combo: telemetry
    knobs shrunk so a 4-tick run closes windows and flushes the ring,
    every request sampled; ``"alert"`` adds the Alerting stage."""
    caps = SimCaps(n_clients=8, max_requests=128, max_cloudlets=128,
                   max_instances=8, n_vms=2, d_max=2, max_replicas=2)
    alert_on = telemetry == "alert"
    tel_on = alert_on or telemetry in (True, "stream")
    params = SimParams(dt=0.05, n_ticks=4, n_clients=6, spawn_rate=10.0,
                       wait_lo=0.1, wait_hi=0.3, seed=7,
                       scaling_policy=1,  # exercise the Scaling phase too
                       network=network, faults=faults,
                       egress_shaping=egress,
                       telemetry="stream" if tel_on else "none",
                       tel_window_ticks=2, tel_windows=2,
                       tel_span_k=1, tel_span_cap=64,
                       alerting="burn" if alert_on else "none",
                       slo_budget=0.05 if alert_on else 0.0,
                       slo_short_wins=1, slo_long_wins=2,
                       slo_for_ticks=1, slo_event_cap=16)
    return Simulation(diamond(mi=200.0), caps=caps, params=params,
                      device=device)


def eager_loop(sim: Simulation, state=None, cap: int = 4) -> TickLoop:
    """An eager ``TickLoop`` of ``sim``'s solo tick from ``state``
    (default: a fresh one), its key table filled for ``cap`` steps."""
    state = sim.init_state() if state is None else state
    roots, _ = rnd.chain(state.rng, cap, carry_path(sim.params))
    loop = TickLoop(sim._tick, DynParams.from_params(sim.params), sim.app,
                    state, cap)
    loop.keys.fill(roots)
    return loop


def replay_sim(sim: Simulation) -> Dict[str, Set[Tuple[str, str]]]:
    """Per-phase column accesses of one eager step of ``sim``'s tick from
    its initial state, the scaling variant where it scales."""
    log = AccessLog()
    state = sim.init_state()
    cl = state.cloudlets
    state = state._replace(cloudlets=Cloudlets(
        cl.ints, cl.flts, RecordingLayout(cl.layout, log)))
    loop = eager_loop(sim, state, 1)
    loop.step(True, probe=log.probe)
    return log.accesses


def replay_accesses(network: str, faults: str, egress: bool,
                    telemetry: bool | str = False, device="cuda"
                    ) -> Dict[str, Set[Tuple[str, str]]]:
    """Actual per-phase column accesses of one eager tick of the combo's
    tiny sim."""
    return replay_sim(_tiny_sim(network, faults, egress, telemetry, device))


def declared_for(registry: dict, phase: str, network: str, faults: str,
                 egress: bool, telemetry: bool | str = False) -> Set[str]:
    """Declared column set of a registry phase under one mode combo
    (base entry + active ``Phase/feature`` sub-entries)."""
    cols = set(registry[phase])
    for key, sub in registry.items():
        if "/" not in key:
            continue
        base, feature = key.split("/", 1)
        if base == phase and _FEATURE_ON[feature](network, faults,
                                                  egress, telemetry):
            cols |= set(sub)
    return cols


def combo_name(network, faults, egress, telemetry) -> str:
    return (f"network={network} faults={faults}"
            + (" egress_shaping" if egress else "")
            + (" telemetry+alerting" if telemetry == "alert"
               else " telemetry" if telemetry else ""))


def replay_problems(actual: Dict[str, Set[Tuple[str, str]]], network: str,
                    faults: str, egress: bool, telemetry: bool | str = False,
                    registry: dict | None = None) -> List[str]:
    """The per-combo rules (undeclared access, spawns outside the respawn
    phases, mode-keyed columns in the core phases) on one replay's
    accesses ``actual`` of a sim of that mode combo (at any size)."""
    registry = PHASE_COLUMNS if registry is None else registry
    base_phases = [p for p in registry if "/" not in p]
    core = set(resolve_layout(SimParams()).columns)
    combo = combo_name(network, faults, egress, telemetry)
    problems: List[str] = []
    for phase, accs in actual.items():
        spawns = {c for c, kind in accs if kind == "spawn"}
        named = {c for c, kind in accs if kind == "named"}
        if spawns and phase not in _SPAWN_PHASES:
            problems.append(
                f"[{combo}] phase {phase!r} performs whole-row spawn "
                f"writes — only {_SPAWN_PHASES} respawn rows")
        if phase in base_phases:
            undeclared = named - declared_for(registry, phase, network,
                                              faults, egress, telemetry)
            if undeclared:
                problems.append(
                    f"[{combo}] phase {phase!r} accesses undeclared "
                    f"column(s) {sorted(undeclared)} — declare them "
                    f"in PHASE_COLUMNS[{phase!r}] (or a mode "
                    "sub-entry) so the layout resolver knows")
        else:
            off_core = named - core
            if off_core:
                problems.append(
                    f"[{combo}] non-registry phase {phase!r} touches "
                    f"mode-keyed column(s) {sorted(off_core)} — it "
                    "runs in every mode, so these reads crash "
                    "layouts that don't carry them")
    return problems


def check_layout_access(phase_columns: dict | None = None, device="cuda",
                        replays: dict | None = None) -> List[str]:
    """All layout-access violations across :data:`COMBOS` (empty = clean).

    ``phase_columns`` overrides the registry for the diff only (the
    seeded-violation tests pass a perturbed copy); ``replays`` maps a
    combo of :data:`COMBOS` to its accesses where they were replayed
    already (the rest are replayed on ``device``)."""
    registry = PHASE_COLUMNS if phase_columns is None else phase_columns
    base_phases = [p for p in registry if "/" not in p]
    problems: List[str] = []
    # union of touches and declarations per phase across combos (the
    # never-touched rule's input)
    touched: Dict[str, Set[str]] = {p: set() for p in base_phases}
    declared_any: Dict[str, Set[str]] = {p: set() for p in base_phases}

    for combo_key in COMBOS:
        actual = (replays or {}).get(combo_key)
        if actual is None:
            actual = replay_accesses(*combo_key, device=device)
        problems += replay_problems(actual, *combo_key, registry=registry)
        for phase, accs in actual.items():
            if phase in base_phases:
                declared_any[phase] |= declared_for(registry, phase,
                                                    *combo_key)
                touched[phase] |= {c for c, _ in accs}

    for phase in base_phases:
        unused = declared_any[phase] - touched[phase]
        if unused:
            problems.append(
                f"phase {phase!r} declares column(s) {sorted(unused)} "
                "that no mode combo ever touches — stale declaration "
                "holding dead pool bytes")
    return problems
