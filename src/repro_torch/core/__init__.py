"""CloudNativeSim core in PyTorch — the default simulation path.

Public API:
    Simulation, SimCaps, SimParams   — build & run a simulation
    batch_item / stack_dyn            — slice / build a run_batch sweep
    build_graph / ServiceGraph       — service-dependency DAG (paper §4.1.1)
    register                          — file registry (paper §3.1)
    summarize / QoSReport             — QoS feedback (paper §3.1)
    critical_path / response_times    — Alg 2 analysis (paper §4.3.2)
    policies                          — built-in policy ids
"""
from . import policies  # noqa: F401
from .app import AppStatic, InstanceTemplate, build_app  # noqa: F401
from .critical_path import (critical_path, path_delay,  # noqa: F401
                            response_times,  # noqa: F401
                            response_times_batched)  # noqa: F401
from .engine import (SimResult, Simulation, batch_item,  # noqa: F401
                     make_tick, stack_dyn)  # noqa: F401
from .generator import (n_clients_analytic, qps_analytic,  # noqa: F401
                        total_requests_analytic)  # noqa: F401
from .graph import (ServiceGraph, build_graph, diamond,  # noqa: F401
                    linear_chain, star)  # noqa: F401
from .qos import QoSReport, node_delays, report_text, summarize  # noqa: F401
from .registry import register  # noqa: F401
from .types import (DynParams, PoolLayout, SimCaps, SimParams,  # noqa: F401
                    SimState, resolve_layout)  # noqa: F401
