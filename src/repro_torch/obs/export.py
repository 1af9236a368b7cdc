"""Host-side metric exporter (paper §3.1 Exporter/Reporter, §9).

:func:`dispatch` is where streamed rows land: every flush of the metric
ring (``obs/telemetry.py``, between replayed ticks) and the end-of-run
drain hand it a ``[n, K]`` float32 block of sealed metric rows (K
columns = ``types.TEL_METRIC_COLUMNS``; batched runs deliver every sweep
point's rows, told apart by the ``tag`` column).  Registered sinks see
each row as a plain dict; the built-in renderers format them as
Prometheus exposition lines or OTel-style JSON.

The default sink just accumulates rows in memory
(:class:`RowCollector`), so tests and `QoSReport` cross-checks can
compare the streamed view against end-of-run aggregates.
"""
from __future__ import annotations

import contextlib
import json
import threading
from typing import Callable, List

import numpy as np

from ..core.types import ALERT_RULES, ALERT_STATES, TEL_METRIC_COLUMNS

_COUNTERS = ("completed", "generated")      # per-window sums
_CUMULATIVE = ("failed_attempts", "retries", "spans", "span_drops")

# Alert-transition row schema (obs/slo.py drain; DESIGN.md §10).  Alert
# rows are events with string labels, not [n, K] float blocks, so they
# ride a parallel sink registry instead of the strict metric pipeline.
ALERT_COLUMNS = ("time_s", "tag", "service", "rule", "state")

_lock = threading.Lock()
_sinks: List[Callable[[dict], None]] = []
_alert_sinks: List[Callable[[dict], None]] = []


def install(sink: Callable[[dict], None]) -> None:
    """Register a sink; it receives one dict per streamed metric row."""
    with _lock:
        _sinks.append(sink)


def uninstall(sink: Callable[[dict], None]) -> None:
    with _lock:
        with contextlib.suppress(ValueError):
            _sinks.remove(sink)


def dispatch(rows) -> None:
    """Deliver a flushed row block to every installed sink.

    Called by the flushes of a run and by the end-of-run drain; tolerant
    of any leading batching — rows are reshaped to ``[-1, K]``.
    """
    rows = np.asarray(rows, np.float32).reshape(-1,
                                                len(TEL_METRIC_COLUMNS))
    with _lock:
        sinks = list(_sinks)
    if not sinks:
        return
    for r in rows:
        d = {n: float(v) for n, v in zip(TEL_METRIC_COLUMNS, r)}
        for s in sinks:
            s(d)


class RowCollector:
    """Thread-safe accumulating sink (the default test/report consumer)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: List[dict] = []

    def __call__(self, row: dict) -> None:
        with self._lock:
            self._rows.append(row)

    @property
    def rows(self) -> List[dict]:
        with self._lock:
            return list(self._rows)

    def rows_np(self) -> np.ndarray:
        """[n, K] float32 in column order TEL_METRIC_COLUMNS."""
        rows = self.rows
        out = np.zeros((len(rows), len(TEL_METRIC_COLUMNS)), np.float32)
        for i, r in enumerate(rows):
            out[i] = [r[n] for n in TEL_METRIC_COLUMNS]
        return out


@contextlib.contextmanager
def collecting():
    """``with export.collecting() as rows:`` — scoped RowCollector."""
    c = RowCollector()
    install(c)
    try:
        yield c
    finally:
        uninstall(c)


# ----------------------------------------------------------------------
# Alert-transition channel (obs/slo.py, DESIGN.md §10)
# ----------------------------------------------------------------------
def install_alert(sink: Callable[[dict], None]) -> None:
    """Register an alert sink; it receives one dict per alert transition
    (``ALERT_COLUMNS`` schema, rule/state as label strings)."""
    with _lock:
        _alert_sinks.append(sink)


def uninstall_alert(sink: Callable[[dict], None]) -> None:
    with _lock:
        with contextlib.suppress(ValueError):
            _alert_sinks.remove(sink)


def dispatch_alerts(rows: List[dict]) -> None:
    """Deliver drained alert-transition rows to every alert sink."""
    with _lock:
        sinks = list(_alert_sinks)
    if not sinks:
        return
    for r in rows:
        for s in sinks:
            s(dict(r))


@contextlib.contextmanager
def alert_collecting():
    """``with export.alert_collecting() as events:`` — scoped collector
    on the alert channel (RowCollector semantics)."""
    c = RowCollector()
    install_alert(c)
    try:
        yield c
    finally:
        uninstall_alert(c)


# ----------------------------------------------------------------------
# Renderers
# ----------------------------------------------------------------------
def prometheus_line(row: dict, prefix: str = "repro") -> str:
    """One Prometheus exposition block per row (gauge per column)."""
    tag = int(row.get("tag", 0.0))
    win = int(row.get("window", 0.0))
    ts = row.get("time_s", 0.0)
    labels = f'{{point="{tag}",window="{win}"}}'
    lines = []
    for n in TEL_METRIC_COLUMNS:
        if n in ("window", "tag", "time_s"):
            continue
        kind = "counter" if n in _COUNTERS + _CUMULATIVE else "gauge"
        lines.append(f"# TYPE {prefix}_{n} {kind}")
        lines.append(f"{prefix}_{n}{labels} {row[n]:g} {ts:g}")
    return "\n".join(lines)


def otel_json(row: dict) -> str:
    """OTel-style JSON datapoint for the whole row."""
    return json.dumps({
        "resource": {"point": int(row.get("tag", 0.0))},
        "time_s": row.get("time_s", 0.0),
        "window": int(row.get("window", 0.0)),
        "metrics": {n: row[n] for n in TEL_METRIC_COLUMNS
                    if n not in ("window", "tag", "time_s")},
    }, sort_keys=True)


def printer(render: Callable[[dict], str] = otel_json,
            out=None) -> Callable[[dict], None]:
    """Sink that renders each row and prints it (live streaming view)."""
    import sys
    stream = out or sys.stdout

    def sink(row: dict) -> None:
        print(render(row), file=stream, flush=True)

    return sink


def prometheus_alert_line(ev: dict, prefix: str = "repro") -> str:
    """Prometheus `ALERTS`-convention exposition line for one transition:
    ``ALERTS{alertname,service,state,point} 1 <ts>`` — the series a real
    Alertmanager scrape would show while the alert is in that state."""
    labels = (f'{{alertname="{ev["rule"]}",service="{ev["service"]}",'
              f'alertstate="{ev["state"]}",point="{int(ev["tag"])}"}}')
    return (f"# TYPE ALERTS gauge\n"
            f"ALERTS{labels} 1 {ev['time_s']:g}")


def otel_alert_event(ev: dict) -> str:
    """OTel span-event JSON for one alert transition."""
    return json.dumps({
        "name": ev["rule"],
        "resource": {"point": int(ev["tag"])},
        "time_s": ev["time_s"],
        "attributes": {"service": int(ev["service"]),
                       "state": ev["state"]},
    }, sort_keys=True)


def validate_alert_rows(rows: List[dict]) -> None:
    """Schema check for drained alert transitions: every row carries the
    full ALERT_COLUMNS schema with known rule/state labels and finite,
    non-decreasing timestamps per (tag, service, rule) lane."""
    lanes: dict = {}
    for i, r in enumerate(rows):
        missing = [n for n in ALERT_COLUMNS if n not in r]
        if missing:
            raise ValueError(f"alert row {i} missing columns {missing}")
        if r["rule"] not in ALERT_RULES:
            raise ValueError(f"alert row {i} unknown rule {r['rule']!r}")
        if r["state"] not in ALERT_STATES:
            raise ValueError(f"alert row {i} unknown state {r['state']!r}")
        if not np.isfinite(r["time_s"]):
            raise ValueError(f"alert row {i} non-finite time_s")
        key = (r["tag"], r["service"], r["rule"])
        if lanes.get(key, -np.inf) > r["time_s"]:
            raise ValueError(
                f"alert row {i} time_s {r['time_s']} decreases within "
                f"lane {key}")
        lanes[key] = r["time_s"]


def validate_rows(rows: List[dict]) -> None:
    """Schema check for CI: every row carries every column, finite,
    with monotone non-negative window ids per tag."""
    if not rows:
        raise ValueError("no telemetry rows streamed")
    per_tag: dict = {}
    for i, r in enumerate(rows):
        missing = [n for n in TEL_METRIC_COLUMNS if n not in r]
        if missing:
            raise ValueError(f"row {i} missing columns {missing}")
        bad = [n for n in TEL_METRIC_COLUMNS if not np.isfinite(r[n])]
        if bad:
            raise ValueError(f"row {i} non-finite columns {bad}")
        if r["window"] < 0:
            raise ValueError(f"row {i} negative window id")
        per_tag.setdefault(r["tag"], []).append(r["window"])
    for tag, wins in per_tag.items():
        if sorted(wins) != list(range(len(wins))):
            raise ValueError(
                f"tag {tag}: windows {sorted(wins)} are not the "
                f"contiguous range 0..{len(wins) - 1}")
