"""SockShop — the paper's case-study application (§6.3, Figs 8/10).

The microservice e-commerce demo (https://github.com/microservices-demo):
NodeJS front-end, Java orders, Go services, MySQL/MongoDB stores, RabbitMQ
shipping pipeline.  APIs map to entry services exactly as the paper's file
registry does (Fig 3a: ``POST /orders`` → service ``orders``); the chain of
a request is the subgraph reachable from its entry service.

``app_spec()`` / ``instance_spec()`` return the two registry documents
(JSON/YAML shapes of Fig 3); ``make_sim(...)`` builds the calibrated
Simulation of the paper's Fig 10 experiment on ``device`` (default
``"cuda"``).  The calibration constants are the reference's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core import SimCaps, SimParams, Simulation, register

# Calibrated against the paper's testbed measurements (Fig 10): average
# response 749 ms at 100 clients → 2574 ms at 300 clients, Locust wait
# U[5, 15] s, 600 s runs.  `mi` is the mean Gaussian cloudlet length
# (paper §4.1.2); shares are milicores (1 milicore ≡ 1 MIPS here).
SERVICES: Dict[str, dict] = {
    # name:             (calls,                                  mi)
    "front-end":   dict(calls=["catalogue", "carts", "user"],    mi=70.0),
    "orders":      dict(calls=["orders-db", "carts", "user",
                               "payment", "shipping"],           mi=90.0),
    "orders-db":   dict(calls=[],                                mi=55.0),
    "carts":       dict(calls=["carts-db"],                      mi=60.0),
    "carts-db":    dict(calls=[],                                mi=45.0),
    "user":        dict(calls=["user-db"],                       mi=55.0),
    "user-db":     dict(calls=[],                                mi=40.0),
    "catalogue":   dict(calls=["catalogue-db"],                  mi=65.0),
    "catalogue-db":dict(calls=[],                                mi=50.0),
    "payment":     dict(calls=[],                                mi=50.0),
    "shipping":    dict(calls=["rabbitmq"],                      mi=55.0),
    "rabbitmq":    dict(calls=["queue-master"],                  mi=35.0),
    "queue-master":dict(calls=[],                                mi=40.0),
}

APIS = [
    # (api name, entry service, weight) — Fig 3a format
    ("GET /",          "front-end", 3.0),
    ("GET /catalogue", "catalogue", 3.0),
    ("GET /login",     "user",      1.0),
    ("GET /basket",    "carts",     2.0),
    ("POST /orders",   "orders",    1.0),
]

# Per-edge RPC payloads in MB (request + response lumped), network fabric
# mode (DESIGN.md §6).  Sized from the public sock-shop API shapes: the
# catalogue returns full product listings (images metadata — the fat edge),
# DB round-trips return document sets, control-plane calls (payment auth,
# shipping hand-off) are near-empty.  Unlisted edges default to 0.01 MB.
PAYLOADS_MB = {
    ("front-end", "catalogue"):    0.120,
    ("front-end", "carts"):        0.030,
    ("front-end", "user"):         0.020,
    ("catalogue", "catalogue-db"): 0.150,
    ("carts", "carts-db"):         0.040,
    ("user", "user-db"):           0.015,
    ("orders", "orders-db"):       0.050,
    ("orders", "carts"):           0.030,
    ("orders", "user"):            0.015,
    ("orders", "payment"):         0.002,
    ("orders", "shipping"):        0.005,
    ("shipping", "rabbitmq"):      0.005,
    ("rabbitmq", "queue-master"):  0.005,
}

# Client→entry request payloads per API (MB): page requests are small;
# order submissions carry the basket document.
API_PAYLOADS_MB = {
    "GET /":          0.004,
    "GET /catalogue": 0.002,
    "GET /login":     0.001,
    "GET /basket":    0.002,
    "POST /orders":   0.020,
}


def app_spec(mi_scale: float = 1.0) -> dict:
    """The Fig 3a JSON document (as a dict; json.dump-able)."""
    return {
        "apis": [{"name": n, "entry": e, "weight": w,
                  "payload": API_PAYLOADS_MB[n]} for n, e, w in APIS],
        "services": [
            {"name": n, "calls": v["calls"], "mi": v["mi"] * mi_scale,
             "mi_std": 0.15 * v["mi"] * mi_scale,
             "payloads": {callee: mb for (src, callee), mb
                          in PAYLOADS_MB.items() if src == n}}
            for n, v in SERVICES.items()
        ],
    }


def instance_spec(share: float = 420.0, replicas: int = 1) -> dict:
    """The Fig 3b YAML document (as a dict; yaml.dump-able).

    Matches the paper's example: requests/limits blocks per instance group.
    """
    return {
        "instances": [
            {
                "prefix": name, "type": "pod", "labels": [name],
                "replicas": replicas, "size": 500,
                "rec_bw": 100, "trans_bw": 100,
                "requests": {"share": share, "ram": 300},
                "limits": {"share": 5 * share, "ram": 500},
            }
            for name in SERVICES
        ]
    }


# Calibrated constants (fit to the paper's published endpoints with the
# 2-knob secant in benchmarks/bench_response.py; see EXPERIMENTS.md):
#   mi_scale   — global cloudlet-length scale (congestion/curvature knob)
#   share      — per-instance CPU share, milicores (fixed during the fit)
#   net_latency— per-RPC-hop transport latency, seconds (level knob)
CALIBRATED = dict(mi_scale=1.052, share=1250.0, net_latency_s=0.1888)


def make_sim(n_clients: int = 100, duration_s: float = 600.0,
             dt: float = 0.1, mi_scale: float = CALIBRATED["mi_scale"],
             share: float = CALIBRATED["share"],
             net_latency_s: float = CALIBRATED["net_latency_s"],
             scaling_policy: int = 0, seed: int = 0,
             max_replicas: int = 4, spawn_rate: float | None = None,
             placement_policy: int | None = None, replicas: int = 1,
             host_zone: np.ndarray | None = None,
             vm_mips: np.ndarray | None = None,
             host_cpu_scale: np.ndarray | None = None,
             device="cuda", **param_overrides) -> Simulation:
    """Build the paper's §6.3 experiment: Locust wait U[5,15] s, 600 s.

    Pass ``network="fabric"`` (plus ``nic_egress_mbps``/``nic_ingress_mbps``)
    to replace the calibrated uniform hop latency with payload transit over
    the 10-node cluster's NICs (DESIGN.md §6); ``placement_policy=
    policies.PLACE_SPREAD`` puts the services on different nodes so their
    calls cross NICs.  ``replicas`` sets the initial replica count per
    service; ``host_zone`` maps the 10 nodes onto failure domains.  Pass
    ``faults="chaos"`` (plus the fault-rate knobs) for the Disruption
    phase, as the chaos study (``examples/chaos_study.py``) does.
    """
    param_overrides.setdefault("net_latency_s", net_latency_s)
    max_replicas = max(max_replicas, replicas)
    caps = SimCaps(
        n_clients=max(n_clients, 1),
        max_requests=int(n_clients * duration_s / 8.0) + 256,
        max_cloudlets=1 << 13,
        max_instances=len(SERVICES) * max_replicas + 8,
        n_vms=10,                      # the paper's 10-node cluster
        d_max=5,
        max_replicas=max_replicas,
    )
    params = SimParams(
        dt=dt,
        n_ticks=int(duration_s / dt),
        n_clients=n_clients,
        spawn_rate=spawn_rate if spawn_rate is not None else n_clients / 30.0,
        wait_lo=5.0, wait_hi=15.0,     # paper: "wait times 5 to 15 seconds"
        slo_ms=1000.0,
        scaling_policy=scaling_policy,
        scale_interval=max(int(15.0 / dt), 1),
        seed=seed,
        **param_overrides,
    )
    # 3 master + 7 workers; capacities follow the paper's node list
    # (32..104 cores), 1 core ≡ 1000 milicores ≡ 1000 MIPS.  ``vm_mips``
    # overrides the node capacities (heterogeneous-hardware studies, e.g.
    # examples/hetero_study.py) while keeping the 10-node shape.
    if vm_mips is None:
        vm_mips = np.array([32, 32, 32, 32, 32, 32, 32, 56, 104, 64],
                           np.float32) * 1000.0
    vm_mips = np.asarray(vm_mips, np.float32)
    if vm_mips.shape != (10,):
        raise ValueError("sockshop runs on the paper's 10-node cluster; "
                         f"vm_mips must have 10 entries, got "
                         f"{vm_mips.shape}")
    vm_ram = np.array([64, 64, 64, 64, 64, 64, 64, 128, 256, 64],
                      np.float32) * 1024.0
    return register(app_spec(mi_scale), instance_spec(share, replicas),
                    caps=caps, params=params, vm_mips=vm_mips, vm_ram=vm_ram,
                    placement_policy=placement_policy, host_zone=host_zone,
                    host_cpu_scale=host_cpu_scale, device=device)


# Paper Fig 10 testbed reference (ms).  Only the 100/300-client values are
# published in the text; the figure's intermediate bars are unlabeled, so
# benchmarks score accuracy on the published points only and report the
# midpoints as predictions.
TESTBED_MS = {100: 749.0, 300: 2574.0}
