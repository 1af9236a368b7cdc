"""simcheck orchestrator — run every analyzer, one report, one exit code;
the counterpart of ``repro.analysis.simcheck``.

``python -m repro_torch.analysis`` drives this module over the port's own
tick: the op lint with its write-back rule per lint combo
(:mod:`.op_lint`), the layout-access diff (:mod:`.layout_check`), the RNG
stream audit with per-combo topology digests (:mod:`.streams`) and the
capture sentinel (:mod:`.recompile`) and the sharding-readiness audit
against its committed baseline (:mod:`.shardability`,
``shard_baseline.json``).  Each section returns a list of violation
strings; the lint's and the audit's findings carry a rule id and are
filtered through ``analysis/waivers.toml`` first, and expired or
unmatched waivers are themselves violations.  The reference's
``intervals`` section is not ported (:data:`NOT_PORTED`).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List, Optional, Set, Tuple

from . import layout_check, op_lint, recompile, shardability, streams
from .waivers import apply_waivers, load_waivers

SHARD_BASELINE_PATH = pathlib.Path(__file__).with_name("shard_baseline.json")

GOLDEN_COMBOS = recompile.GOLDEN_COMBOS
# telemetry="stream" on the full mode: the Telemetry phase draws no tick
# key (its sample mask is an init-time named fold_in), so its digest must
# equal fabric+chaos's
TELEMETRY_COMBO = ("fabric", "chaos", "stream")
# alerting="burn" on top: pure arithmetic over sealed SLI windows, the
# same rule
ALERTING_COMBO = ("fabric", "chaos", "alert")
# the reference's lint combos
LINT_COMBOS = [(*c, "none") for c in GOLDEN_COMBOS] + [TELEMETRY_COMBO,
                                                       ALERTING_COMBO]
SECTIONS = ("lint", "layout", "streams", "recompile", "shardability")
# the reference's sections the port lacks: what each would analyse is in
# ROADMAP.md (Queue 1, item 14a)
NOT_PORTED = ("intervals",)
# sections whose findings carry a rule id, which a dated waiver in
# analysis/waivers.toml may silence; the others' are structural
WAIVABLE_SECTIONS = ("lint", "shardability")


def record_tick_streams(network: str, faults: str,
                        telemetry: bool | str = False, device="cuda"
                        ) -> streams.StreamRecorder:
    """Replay one eager step of the combo's tiny sim with stream recording;
    the step's root key (``KeyTable.root()``) is registered as ``"tick"``,
    so every wrapped derivation resolves a path."""
    sim = layout_check._tiny_sim(network, faults, False, telemetry, device)
    loop = layout_check.eager_loop(sim, cap=1)
    with streams.recording() as rec:
        rec.register(loop.keys.root(), "tick")
        loop.step(True)
    return rec


def check_streams(device="cuda") -> Dict[str, object]:
    """Audit all six combos; returns ``{'problems': [...], 'digests':
    {...}}``."""
    problems: List[str] = []
    digests: Dict[str, str] = {}

    def audit(combo: str, rec) -> None:
        digests[combo] = streams.topology_digest(rec)
        for p in streams.audit_events(rec):
            problems.append(f"[{combo}] {p}")
        if not rec.events:
            problems.append(
                f"[{combo}] no stream derivations recorded — the engine "
                "bypassed analysis.streams entirely")

    for net, fl in GOLDEN_COMBOS:
        audit(f"{net}+{fl}", record_tick_streams(net, fl, device=device))
    for (net, fl, tel), name, why in (
            (TELEMETRY_COMBO, "telemetry",
             "the Telemetry phase must not consume tick RNG (its sample "
             "mask is an init-time named fold_in)"),
            (ALERTING_COMBO, "alerting",
             "the Alerting phase must not consume tick RNG (burn-rate "
             "rules are pure arithmetic over sealed SLI windows)")):
        combo = f"{net}+{fl}+{name}"
        audit(combo, record_tick_streams(
            net, fl, True if tel == "stream" else tel, device))
        if digests[combo] != digests[f"{net}+{fl}"]:
            problems.append(f"[{combo}] tick stream topology differs from "
                            f"{net}+{fl} — {why}")
    return {"problems": problems, "digests": digests}


@dataclasses.dataclass
class SimcheckReport:
    sections: Dict[str, List[str]]
    stream_digests: Dict[str, str]
    sentinel: Optional[recompile.SentinelReport]
    shard_reports: Dict[str, shardability.ShardReport] = \
        dataclasses.field(default_factory=dict)

    @property
    def problems(self) -> List[str]:
        return [f"{sec}: {p}" for sec, ps in self.sections.items()
                for p in ps]

    @property
    def ok(self) -> bool:
        return not self.problems


def _split_waived(waivable: List[Tuple[str, str, str]],
                  surviving: List[str]) -> Dict[str, List[str]]:
    """Regroup ``apply_waivers``' surviving texts (an ordered subsequence
    of the waivable texts) back into their sections."""
    per_sec: Dict[str, List[str]] = {}
    si = 0
    for sec, _rule, text in waivable:
        if si < len(surviving) and surviving[si] == text:
            per_sec.setdefault(sec, []).append(text)
            si += 1
    return per_sec


def check_shardability(device="cuda", baseline: Optional[dict] = None
                       ) -> Tuple[Dict[str, shardability.ShardReport],
                                  List[str]]:
    """The audit of each golden combo on ``device`` and its findings
    against ``baseline`` (default: the committed ``shard_baseline.json``;
    none committed is a finding per combo)."""
    reports = {}
    for net, fl in GOLDEN_COMBOS:
        rep = shardability.audit_combo(net, fl, device=device)
        reports[rep.combo] = rep
    if baseline is None:
        baseline = (json.loads(SHARD_BASELINE_PATH.read_text())
                    if SHARD_BASELINE_PATH.exists() else {"combos": {}})
    return reports, shardability.compare_to_baseline(
        list(reports.values()), baseline)


def run_simcheck(only: Optional[Set[str]] = None, sweep_points: int = 8,
                 device="cuda") -> SimcheckReport:
    """Run the requested analyzer sections (default: all five) on
    ``device``.  ``only`` limits to a subset of :data:`SECTIONS`; naming a
    section of :data:`NOT_PORTED` raises ``ValueError``.  Rule waivers
    come from ``analysis/waivers.toml``, not from arguments."""
    for name in sorted(set(only or ()) - set(SECTIONS)):
        raise ValueError(
            f"section {name!r} is "
            + ("not ported to repro_torch (ROADMAP.md, Queue 1 item 14a)"
               if name in NOT_PORTED
               else f"unknown (sections: {', '.join(SECTIONS)})"))
    run = lambda name: only is None or name in only
    sections: Dict[str, List[str]] = {}
    digests: Dict[str, str] = {}
    sentinel = None
    shard_reports: Dict[str, shardability.ShardReport] = {}
    # (section, rule, text) findings that waivers.toml may silence
    waivable: List[Tuple[str, str, str]] = []

    if run("lint"):
        # lint findings are "rule: detail" — the prefix is the rule id
        # (f64, sync, transfer, writeback) waivers.toml matches
        tags = {"stream": "+telemetry", "alert": "+alerting", "none": ""}
        waivable += [("lint", p.split(":", 1)[0],
                      f"[{net}+{fl}{tags[tel]}] {p}")
                     for net, fl, tel in LINT_COMBOS
                     for p in op_lint.lint_combo(net, fl, tel, device)]
    if run("layout"):
        sections["layout"] = layout_check.check_layout_access(device=device)
    if run("streams"):
        res = check_streams(device)
        sections["streams"] = res["problems"]
        digests = res["digests"]
    if run("recompile"):
        sentinel = recompile.run_sentinel(n_points=sweep_points,
                                          device=device)
        sections["recompile"] = sentinel.problems
    if run("shardability"):
        shard_reports, found = check_shardability(device)
        waivable += [("shardability", "shardability", p) for p in found]

    ran_waivable = [s for s in WAIVABLE_SECTIONS if run(s)]
    if ran_waivable:
        surviving, wproblems = apply_waivers(
            [(rule, text) for _, rule, text in waivable], load_waivers())
        per_sec = _split_waived(waivable, surviving)
        for sec in ran_waivable:
            sections[sec] = per_sec.get(sec, [])
        if set(ran_waivable) != set(WAIVABLE_SECTIONS):
            # a partial run cannot tell a stale waiver from one whose
            # section was skipped: only expiry stays fatal
            wproblems = [p for p in wproblems
                         if "matched no finding" not in p]
        sections["waivers"] = wproblems

    return SimcheckReport(sections=sections, stream_digests=digests,
                          sentinel=sentinel, shard_reports=shard_reports)
