"""Persistent simcheck waivers (DESIGN.md §8), the counterpart of
``repro.analysis.waivers``: the same file format and rules, applied to the
port's findings (``python -m repro_torch.analysis``).

A waiver silences one analyzer finding — by rule id, optionally pinned
to one site — for a bounded time.  Waivers live in
``analysis/waivers.toml`` next to this module (one ``[[waiver]]`` table
each), NOT in CLI flags: a flag waives forever and invisibly, a file
row is reviewed in the diff, carries its reason, and **expires**:

.. code-block:: toml

    [[waiver]]
    rule = "writeback"             # analyzer rule id
    site = "pool.py:111"           # optional substring match ("" = any)
    reason = "why the finding stands, and where it is tracked"
    expires = 2026-12-31           # TOML date; past due ⇒ CI failure

Expired waivers and waivers that matched nothing are both violations —
a stale waiver is a silenced alarm nobody remembers.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
import pathlib
from typing import List, Optional, Sequence, Tuple

import tomllib as _toml

WAIVERS_PATH = pathlib.Path(__file__).with_name("waivers.toml")


@dataclasses.dataclass(frozen=True)
class Waiver:
    rule: str
    site: str            # substring of the finding text; "" matches any
    reason: str
    expires: _dt.date

    def expired(self, today: Optional[_dt.date] = None) -> bool:
        return (today or _dt.date.today()) > self.expires

    def matches(self, rule: str, text: str) -> bool:
        return self.rule == rule and (not self.site or self.site in text)


def load_waivers(path: Optional[pathlib.Path] = None) -> List[Waiver]:
    path = path or WAIVERS_PATH
    if not path.exists():
        return []
    with open(path, "rb") as fh:
        doc = _toml.load(fh)
    out: List[Waiver] = []
    for i, row in enumerate(doc.get("waiver", [])):
        missing = [k for k in ("rule", "reason", "expires") if k not in row]
        if missing:
            raise ValueError(
                f"waivers.toml [[waiver]] #{i + 1} is missing required "
                f"key(s) {missing} — every waiver needs a rule, a "
                f"reason, and an expiry date")
        exp = row["expires"]
        if isinstance(exp, _dt.datetime):
            exp = exp.date()
        if not isinstance(exp, _dt.date):
            raise ValueError(
                f"waivers.toml [[waiver]] #{i + 1}: 'expires' must be a "
                f"TOML date (e.g. 2026-12-31), got {exp!r}")
        out.append(Waiver(rule=str(row["rule"]), site=str(row.get("site", "")),
                          reason=str(row["reason"]), expires=exp))
    return out


def apply_waivers(findings: Sequence[Tuple[str, str]],
                  waivers: Sequence[Waiver],
                  today: Optional[_dt.date] = None
                  ) -> Tuple[List[str], List[str]]:
    """Filter ``(rule, text)`` findings through the waiver list.

    Returns ``(surviving_texts, waiver_problems)`` where the problems
    list holds one violation per expired waiver and per waiver that
    matched no finding (unused) — both fail CI.
    """
    today = today or _dt.date.today()
    used = [False] * len(waivers)
    surviving: List[str] = []
    for rule, text in findings:
        waived = False
        for i, w in enumerate(waivers):
            if w.matches(rule, text) and not w.expired(today):
                used[i] = True
                waived = True
        if not waived:
            surviving.append(text)
    problems: List[str] = []
    for i, w in enumerate(waivers):
        if w.expired(today):
            problems.append(
                f"waiver for rule {w.rule!r}"
                + (f" site {w.site!r}" if w.site else "")
                + f" expired {w.expires.isoformat()} ({w.reason}) — "
                  f"fix the finding or renew the waiver")
        elif not used[i]:
            problems.append(
                f"waiver for rule {w.rule!r}"
                + (f" site {w.site!r}" if w.site else "")
                + " matched no finding — delete the stale waiver")
    return surviving, problems
