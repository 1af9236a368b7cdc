"""File registry (paper §3.1, Fig 3): JSON APIs/services + YAML instances.

Users describe a cloud-native application with two documents and never
touch engine internals:

* ``app.json`` — APIs (name, weight, entry service) and services
  (name, labels, calls, cloudlet length stats), Fig 3a.
* ``instances.yaml`` — instance groups (prefix, labels, replicas, size,
  bandwidths, requests/limits), Fig 3b.

``register(...)`` parses both into a ready :class:`Simulation`.  Documents
are dicts, JSON strings or paths; PyYAML is imported only when a ``.yaml``
path is given.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

import numpy as np

from .app import InstanceTemplate
from .engine import Simulation
from .graph import ServiceGraph, build_graph
from .types import SimCaps, SimParams


def _load_doc(path_or_dict) -> Dict[str, Any]:
    """A registry document from a dict, a JSON string, or a path to a
    ``.json`` or ``.yaml``/``.yml`` file (PyYAML is imported only for a
    YAML path)."""
    if isinstance(path_or_dict, pathlib.Path) or (
            isinstance(path_or_dict, str)
            and not path_or_dict.lstrip().startswith("{")):
        path = pathlib.Path(path_or_dict)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            import yaml
            return yaml.safe_load(text)
        return json.loads(text)
    if isinstance(path_or_dict, str):
        return json.loads(path_or_dict)
    return dict(path_or_dict)


def load_app_json(path_or_dict) -> Dict[str, Any]:
    return _load_doc(path_or_dict)


def load_instances_yaml(path_or_dict) -> Dict[str, Any]:
    return _load_doc(path_or_dict)


def graph_from_spec(spec: Dict[str, Any],
                    default_mi: float = 500.0) -> ServiceGraph:
    """Build the service DAG from the Fig 3a JSON document.

    Network-fabric extension (DESIGN.md §6): a service may carry a
    ``"payloads": {callee: MB}`` map (per-call-edge RPC payload mean) and
    an API a ``"payload": MB`` scalar (client→entry request payload).

    Resilience extension (DESIGN.md §7): a service may carry a
    ``"retries": {callee: n}`` map (per-call-edge retry budget) and an API
    a ``"retries": n`` scalar (client→entry budget); unlisted edges use
    the run-wide ``SimParams.retry_budget``.  Timeout budgets mirror the
    retry resolver: a service ``"timeouts": {callee: seconds}`` map and an
    API ``"timeout": seconds`` scalar override the run-wide
    ``SimParams.retry_timeout_s`` per edge.
    """
    services = spec["services"]
    names = [s["name"] for s in services]
    calls = {s["name"]: list(s.get("calls", [])) for s in services}
    len_mean = {s["name"]: float(s.get("mi", default_mi)) for s in services}
    len_std = {s["name"]: float(s.get("mi_std", 0.1 * len_mean[s["name"]]))
               for s in services}
    apis = [(a["name"], a["entry"], float(a.get("weight", 1.0)))
            for a in spec["apis"]]
    payloads = {(s["name"], callee): float(mb)
                for s in services
                for callee, mb in s.get("payloads", {}).items()}
    api_payloads = {a["name"]: float(a["payload"])
                    for a in spec["apis"] if "payload" in a}
    retries = {(s["name"], callee): int(n)
               for s in services
               for callee, n in s.get("retries", {}).items()}
    api_retries = {a["name"]: int(a["retries"])
                   for a in spec["apis"] if "retries" in a}
    timeouts = {(s["name"], callee): float(sec)
                for s in services
                for callee, sec in s.get("timeouts", {}).items()}
    api_timeouts = {a["name"]: float(a["timeout"])
                    for a in spec["apis"] if "timeout" in a}
    return build_graph(names, calls, apis, len_mean, len_std,
                       payloads=payloads or None,
                       api_payloads=api_payloads or None,
                       retries=retries or None,
                       api_retries=api_retries or None,
                       timeouts=timeouts or None,
                       api_timeouts=api_timeouts or None)


def templates_from_spec(spec: Dict[str, Any],
                        graph: ServiceGraph) -> Dict[str, InstanceTemplate]:
    """Map Fig 3b instance groups onto services by label/prefix match."""
    templates: Dict[str, InstanceTemplate] = {}
    for item in spec.get("instances", []):
        labels = set(item.get("labels", [item.get("prefix", "")]))
        req = item.get("requests", {})
        lim = item.get("limits", {})
        tmpl = InstanceTemplate(
            mips=float(req.get("share", 1000.0)),
            limit_mips=float(lim.get("share", 2 * req.get("share", 1000.0))),
            ram=float(req.get("ram", 300.0)),
            limit_ram=float(lim.get("ram", 500.0)),
            bw=float(item.get("rec_bw", item.get("trans_bw", 100.0))),
            replicas=int(item.get("replicas", 1)),
            ram_per_cloudlet=float(item.get("ram_per_cloudlet", 1.0)),
            bytes_per_rpc=float(item.get("bytes_per_rpc", 0.01)),
        )
        for name in graph.names:
            if name in labels or any(name.startswith(l) for l in labels if l):
                templates[name] = tmpl
    return templates


def register(app_spec, instance_spec=None, caps: SimCaps | None = None,
             params: SimParams | None = None, vm_mips=None, vm_ram=None,
             host_egress_scale=None, host_ingress_scale=None,
             placement_policy=None, host_zone=None,
             host_cpu_scale=None, device="cuda") -> Simulation:
    """One-call entity registration (paper Fig 4 ``Register`` class).

    Failure-domain extension (DESIGN.md §7.1): the app document may carry
    a top-level ``"zones": [zone_id, ...]`` list (one entry per host) that
    maps hosts to correlated failure domains for zone-level chaos; the
    ``host_zone`` argument overrides it.  Default: one zone per host.

    SLO-objective extension (DESIGN.md §10): a service may declare
    ``"slo_ms": target`` and ``"slo_budget": fraction`` — the per-service
    latency target and error-budget fraction burn-rate alerting evaluates
    (``SimParams.alerting="burn"``); undeclared services fall back to the
    run-wide ``slo_ms`` / ``slo_budget`` params at evaluation time.
    """
    spec = load_app_json(app_spec)
    graph = graph_from_spec(spec)
    # spec-level bounds checks name the offending document entry; the
    # table-level recheck (app.validate_app) runs inside Simulation
    caps_eff = caps or SimCaps()
    for item in (load_instances_yaml(instance_spec).get("instances", [])
                 if instance_spec is not None else []):
        r = int(item.get("replicas", 1))
        if not 1 <= r <= caps_eff.max_replicas:
            who = item.get("labels", item.get("prefix", "?"))
            raise ValueError(
                f"instance group {who!r} declares replicas={r}; must lie "
                f"in [1, caps.max_replicas={caps_eff.max_replicas}]")
    if host_zone is None and "zones" in spec:
        host_zone = np.asarray(spec["zones"], np.int32)
        if host_zone.shape[0] != caps_eff.n_vms:
            raise ValueError(
                f'app document "zones" lists {host_zone.shape[0]} entries '
                f"but the cluster has caps.n_vms={caps_eff.n_vms} hosts")
    services = spec["services"]
    slo_ms = [float(s.get("slo_ms", -1.0)) for s in services]
    slo_budget = [float(s.get("slo_budget", -1.0)) for s in services]
    templates = {}
    if instance_spec is not None:
        inst_spec = load_instances_yaml(instance_spec)
        templates = templates_from_spec(inst_spec, graph)
    return Simulation(graph, caps=caps, params=params, templates=templates,
                      vm_mips=vm_mips, vm_ram=vm_ram,
                      host_egress_scale=host_egress_scale,
                      host_ingress_scale=host_ingress_scale,
                      placement_policy=placement_policy,
                      host_zone=host_zone,
                      host_cpu_scale=host_cpu_scale,
                      service_slo_ms=slo_ms,
                      service_slo_budget=slo_budget, device=device)
