"""Opt-in observability for the port (DESIGN.md §9, §10), as the
reference's ``repro.obs``.

Five pieces, all default-off and leaving every simulation leaf as it is
when on:

- :mod:`.telemetry` — the device-side metric-row ring and sampled span
  ring; the replayed tick loop copies each just-sealed half of the ring
  out between ticks (the paper's Exporter, §3.1).
- :mod:`.export` — the host-side exporter registry rendering OTel /
  Prometheus-style rows as runs stream them.
- :mod:`.spans` — host-side trace-tree reconstruction of the seeded
  1-in-k request sample, cross-checked against the tropical-closure
  critical path (paper §4.3.2).
- :mod:`.profile` — per-phase time attribution from the eager tick's
  phase probes (CUDA events on the card).
- :mod:`.slo` — per-service SLO objectives, multi-window burn-rate
  alerting, and the alert state machine feeding the control plane.

Submodules import lazily: ``profile`` imports ``core.engine``, which
imports ``obs.telemetry`` and ``obs.slo``, so an eager package import
would cycle.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("telemetry", "export", "spans", "profile", "slo")

__all__ = list(_SUBMODULES)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
