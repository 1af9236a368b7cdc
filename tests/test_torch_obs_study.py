"""``examples/slo_study.py``'s util and slo_burn arms on the port, as
one ``run_batch``, against the JAX reference's: every leaf, trace,
streamed metric row and alert row equal (tolerance zero).  The port's
SockShop is built with the arguments the example gives the reference's
(captured from its call), and the run is cut to 30 simulated seconds."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from test_torch_obs_runs import run_both

from repro.configs import sockshop as jsock

from repro_torch.configs import sockshop as tsock
from repro_torch.obs import export

torch.set_num_threads(1)


def _slo_study():
    """``examples/slo_study.py``, loaded from its file."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "examples" / "slo_study.py"
    spec = importlib.util.spec_from_file_location("slo_study", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_slo_study_arms_match_reference(monkeypatch):
    """``examples/slo_study.py``'s util and slo_burn arms (SockShop x2
    replicas, zone fail-slow chaos, HS every 5 s, ejection tightened to
    0.3 in the burn arm) as one ``run_batch`` over 30 simulated seconds;
    the port's SockShop is built with the very arguments the example
    gives the reference's."""
    study = _slo_study()
    args = {}
    real = jsock.make_sim

    def capture(**kw):
        args.update(kw)
        return real(**kw)

    monkeypatch.setattr(study.sockshop, "make_sim", capture)
    jsim = study.make_sim(30.0, 100)
    tsim = tsock.make_sim(device="cpu", **args)
    assert dataclasses.asdict(tsim.params) == dataclasses.asdict(jsim.params)
    base = dict(scale_interval=50)
    arms = (dict(hs_mode="util", slo_eject_tighten=1.0),
            dict(hs_mode="slo_burn", slo_eject_tighten=0.3))
    jpts = [dataclasses.replace(jsim.params, **base, **a) for a in arms]
    tpts = [dataclasses.replace(tsim.params, **base, **a) for a in arms]
    res, _, alerts = run_both(jsim, tsim, "slo study", jpts, tpts)
    export.validate_alert_rows(alerts)
    # no burn alert fires in the first 30 s (the long lookback is 60 s),
    # so the burn gate holds while the util gate scales out
    out = res.state.counters.scale_out
    assert int(out[0]) > 0 and int(out[1]) == 0
