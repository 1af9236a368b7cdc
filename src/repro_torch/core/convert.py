"""Carry an application and a simulation state across from numpy.

``app_from_numpy(d)`` and ``state_from_numpy(d, layout)`` build the port's
``AppStatic`` / ``SimState`` from a dict of numpy arrays keyed by the
reference containers' field names (nested dicts for nested containers;
the cloudlet pool as ``{"ints": [C, NI], "flts": [C, NF]}`` in the
layout's column order; the PRNG key as two uint32 words).  It is how the
parity tests start both packages from the same state, and the inverse,
``state_to_numpy``, is how they compare the results.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .app import AppStatic
from .types import (AlertState, Clients, Cloudlets, Counters, FaultState,
                    FaultStats, Hosts, Instances, NetStats, PoolLayout,
                    Requests, SchedState, SimState, SvcStats, TelemetryState,
                    VMs, resolve_device)

_NESTED = {
    "clients": Clients, "requests": Requests, "instances": Instances,
    "vms": VMs, "hosts": Hosts, "net": NetStats, "sched": SchedState,
    "svc_stats": SvcStats, "counters": Counters, "fault": FaultState,
    "fstats": FaultStats, "telemetry": TelemetryState, "alerts": AlertState,
}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        raise TypeError("uint32 leaves other than the PRNG key are not "
                        "part of the state")
    return torch.as_tensor(np.array(a, copy=True), device=device)


def app_from_numpy(d: Dict[str, Any], device="cuda") -> AppStatic:
    """``AppStatic`` on ``device`` from numpy arrays keyed by field name."""
    device = resolve_device(device)
    return AppStatic(**{f: _tensor(d[f], device) for f in AppStatic._fields})


def state_from_numpy(d: Dict[str, Any], layout: PoolLayout,
                     device="cuda") -> SimState:
    """``SimState`` on ``device`` from numpy arrays keyed by field name.
    The key stays on the CPU (as int64 words)."""
    device = resolve_device(device)
    out = {}
    for f in SimState._fields:
        v = d[f]
        if f == "rng":
            out[f] = torch.as_tensor(np.asarray(v).astype(np.int64))
        elif f == "cloudlets":
            out[f] = Cloudlets(_tensor(v["ints"], device),
                               _tensor(v["flts"], device), layout)
        elif f in _NESTED:
            cls = _NESTED[f]
            out[f] = cls(**{g: _tensor(v[g], device) for g in cls._fields})
        else:
            out[f] = _tensor(v, device)
    return SimState(**out)


def state_to_numpy(state: SimState) -> Dict[str, Any]:
    """The inverse of :func:`state_from_numpy` (the key as uint32)."""
    host = lambda t: t.detach().cpu().numpy()
    out = {}
    for f in SimState._fields:
        v = getattr(state, f)
        if f == "rng":
            out[f] = host(v).astype(np.uint32)
        elif f == "cloudlets":
            out[f] = {"ints": host(v.ints), "flts": host(v.flts)}
        elif f in _NESTED:
            out[f] = {g: host(getattr(v, g)) for g in v._fields}
        else:
            out[f] = host(v)
    return out
