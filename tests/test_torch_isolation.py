"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` and the
examples written for the port (``examples/torch_*.py``) import neither
JAX nor the JAX package, import PyYAML only lazily, run with both of them
unimportable, and never fall back to the CPU unasked."""
import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

# the port's tensors here are small: one intra-op thread per test
# process beats oversubscribing the cores across test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 20
    for twin in ("llm_serving_sim", "quickstart", "sockshop_sim",
                 "autoscale_study", "network_saturation", "chaos_study",
                 "hetero_study", "slo_study", "telemetry_study",
                 "train_lm"):
        assert ROOT / "examples" / f"torch_{twin}.py" in files
    return files


def _imports(tree):
    """(module name, at module level?) for every import in ``tree``."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top_level in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path}: imports {name}"
        if root == "yaml":
            assert not top_level, f"{path}: imports yaml at module level"


def test_runs_with_jax_and_reference_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        sys.modules["yaml"] = None
        import numpy as np
        from repro_torch.configs import sockshop
        from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,
                                      Simulation, diamond, summarize)
        caps = SimCaps(n_clients=8, max_requests=64, max_cloudlets=64,
                       max_instances=8, n_vms=2, d_max=2, max_replicas=2)
        params = SimParams(dt=0.05, n_ticks=5, n_clients=4,
                           spawn_rate=100.0, wait_lo=0.1, wait_hi=0.2)
        sim = Simulation(diamond(mi=100.0), caps=caps, params=params,
                         device="cpu")
        res = sim.run()
        assert int(res.state.tick) == 5
        assert int(res.state.counters.spawned) > 0
        summarize(sim, res)
        sockshop.make_sim(10, 1.0, device="cpu").run()
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_fabric_runs_with_jax_and_reference_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        from repro_torch.configs import capacity, sockshop
        from repro_torch.core import policies, summarize
        sim = sockshop.make_sim(10, 2.0, network="fabric",
                                nic_egress_mbps=8.0, nic_ingress_mbps=8.0,
                                placement_policy=policies.PLACE_SPREAD,
                                device="cpu")
        res = sim.run()
        assert int(res.state.tick) == 20
        summarize(sim, res)
        sim, meta = capacity.build_tagged("case1b+net", 0.0001,
                                          device="cpu")
        state, _ = sim.run_state(sim.init_state(), n_ticks=5)
        assert int(state.net.transits) > 0
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_obs_runs_with_jax_and_reference_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        from repro_torch.configs import sockshop
        from repro_torch.obs import export, profile, slo, spans
        sim = sockshop.make_sim(20, 6.0, telemetry="stream",
                                tel_window_ticks=10, tel_windows=4,
                                tel_span_k=4, alerting="burn",
                                slo_budget=0.05, device="cpu")
        with export.collecting() as rows:
            res = sim.run()
        export.validate_rows(rows.rows)
        assert len(rows.rows) == 6
        spans.verify_traces(res.state, sim.graph, int(sim.app.succ.shape[1]))
        slo.drain_events(res.state.alerts)
        profile.phase_breakdown(sim, reps=1, n_ticks=3)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_train_runs_with_jax_and_reference_unimportable(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["repro"] = None
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch import train
        losses = train.main(["--preset", "tiny", "--steps", "3", "--batch",
                             "2", "--seq", "16", "--ckpt-dir",
                             {str(tmp_path / "ck")!r}, "--ckpt-every", "2",
                             "--compress-grads", "--device", "cpu"])
        assert len(losses) == 3 and all(x == x for x in losses)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000001.json", "step_00000001.npz", "step_00000002.json",
        "step_00000002.npz"]


def test_default_device_is_the_gpu():
    from repro_torch.core import (SimCaps, SimParams, Simulation, diamond,
                                  response_times)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    caps = SimCaps(n_clients=4, max_requests=16, max_cloudlets=16,
                   max_instances=8, n_vms=2, d_max=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation(diamond(), caps=caps, params=SimParams(n_ticks=1))
    with pytest.raises(RuntimeError):
        response_times(diamond(), [1.0, 1.0, 1.0, 1.0])
    # the public builders default to the GPU too, so a state built with
    # them and driven through make_tick never lands on the CPU unasked
    from repro_torch import random as trnd
    from repro_torch.core import build_app, convert, resolve_layout
    from repro_torch.core.types import zeros_state
    params = SimParams(n_ticks=1)
    sim = Simulation(diamond(), caps=caps, params=params, device="cpu")
    st = sim.init_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_app(diamond())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zeros_state(caps, params, trnd.PRNGKey(0), app=sim.app)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.app_from_numpy({k: v.numpy()
                                for k, v in sim.app._asdict().items()})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_numpy(convert.state_to_numpy(st),
                                 resolve_layout(params))
    # training too: the driver and the data pipeline
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--preset", "tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(64, 8, 1).batch(0)


def test_unported_modes_raise():
    from repro_torch.core import SimCaps, SimParams, Simulation, diamond
    caps = SimCaps(n_clients=4, max_requests=16, max_cloudlets=16,
                   max_instances=8, n_vms=2, d_max=2)
    # chaos mode is ported: both network modes build and run
    for knob in (dict(faults="chaos"), dict(network="fabric",
                                            faults="chaos")):
        sim = Simulation(diamond(), caps=caps,
                         params=SimParams(n_ticks=2, **knob), device="cpu")
        assert int(sim.run().state.tick) == 2
    # the observability modes are ported: they build and run, with and
    # without chaos
    for knob in (dict(telemetry="stream"),
                 dict(telemetry="stream", alerting="burn"),
                 dict(telemetry="stream", alerting="burn",
                      hs_mode="slo_burn"),
                 dict(faults="chaos", telemetry="stream"),
                 dict(faults="chaos", telemetry="stream", alerting="burn")):
        sim = Simulation(diamond(), caps=caps,
                         params=SimParams(n_ticks=2, **knob), device="cpu")
        assert int(sim.run().state.tick) == 2
    # ... and raise ValueError where the reference's validators do
    for knob, match in ((dict(hs_mode="slo_burn"), "requires alerting"),
                        (dict(alerting="burn"), "requires telemetry"),
                        (dict(telemetry="sometimes"), "'none' or 'stream'"),
                        (dict(telemetry="stream", tel_windows=3), "even")):
        with pytest.raises(ValueError, match=match):
            Simulation(diamond(), caps=caps,
                       params=SimParams(n_ticks=1, **knob), device="cpu")
    with pytest.raises(ValueError, match="uniform.*fabric"):
        Simulation(diamond(), caps=caps,
                   params=SimParams(n_ticks=1, network="mesh"), device="cpu")
    with pytest.raises(ValueError, match="none.*chaos"):
        Simulation(diamond(), caps=caps,
                   params=SimParams(n_ticks=1, faults="mayhem"),
                   device="cpu")
    # as the reference's run_batch: a sweep may not vary the fault mode
    params = SimParams(n_ticks=1)
    sim = Simulation(diamond(), caps=caps, params=params, device="cpu")
    with pytest.raises(ValueError, match="structural"):
        sim.run_batch([params, dataclasses.replace(params, faults="chaos")])


def test_registry_reads_dicts_json_strings_and_json_files(tmp_path):
    import json
    from repro_torch.configs import sockshop
    from repro_torch.core import SimCaps, register
    spec, inst = sockshop.app_spec(), sockshop.instance_spec()
    path = tmp_path / "app.json"
    path.write_text(json.dumps(spec))
    kw = dict(caps=SimCaps(d_max=5, n_vms=10), device="cpu")
    sims = [register(spec, inst, **kw),
            register(json.dumps(spec), json.dumps(inst), **kw),
            register(path, inst, **kw),
            register(str(path), inst, **kw)]
    for s in sims[1:]:
        for k, v in sims[0].app._asdict().items():
            assert torch.equal(getattr(s.app, k), v), k
