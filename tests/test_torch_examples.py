"""The port's twins of ``examples/`` (``examples/torch_*.py``) on the CPU,
each at its smallest setting, asserting its verdict (each twin's
``main`` returns 0 where the verdict holds: the critical path within 5 %
of the simulated response, HS scaling out on fewer milicores than NS, the
transit p95 rising with the load, ejection lowering the error rate or the
p95 tail, the alert rows valid, every streamed window reconciled and every
eligible trace exact, the registry documents giving the calibrated
deployment, the mean loss of the last ten steps below the first ten's).
The twins without a size flag (quickstart, sockshop_sim) are cut through
their module's size constant.
autoscale_study, network_saturation and hetero_study print the same table
as the reference example at the same flags, the reference run under the
non-partitionable threefry its goldens were pinned with
(``jax_reference``)."""
import contextlib
import importlib.util
import io
import pathlib
import sys

import pytest
import torch

from test_torch_phases import jax_reference

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"

# twin -> (flags at its smallest setting, module constants cut, compare
# with the reference example at the same flags)
CASES = {
    "quickstart": ([], {"N_TICKS": 100}, False),
    "sockshop_sim": ([], {"DURATION_S": 5.0, "LOADS": (100,)}, False),
    "autoscale_study": (["--loads", "100", "--duration", "16"], {}, True),
    "network_saturation": (["--loads", "10,20", "--duration", "5"], {},
                           True),
    "chaos_study": (["--radii", "2", "--clients", "60", "--duration", "20"],
                    {}, False),
    "hetero_study": (["--clients", "40", "--duration", "20"], {}, True),
    "slo_study": (["--duration", "10", "--clients", "30"], {}, False),
    "telemetry_study": (["--duration", "10", "--points", "2"], {}, False),
    "train_lm": (["--steps", "20", "--batch", "4", "--seq", "32",
                  "--lr", "1e-2", "--log-every", "100"], {}, False),
}


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _table(text: str) -> list:
    """The printed report without the lines that carry wall times or the
    twin's verdict comment (``#``)."""
    return [ln for ln in text.splitlines()
            if ln.strip() and not ln.startswith("#")]


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_passes_its_verdict(name, monkeypatch):
    flags, consts, compare = CASES[name]
    twin = _load(EXAMPLES / f"torch_{name}.py", f"torch_{name}")
    for k, v in consts.items():
        monkeypatch.setattr(twin, k, v)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = twin.main(flags + ["--device", "cpu"])
    assert code == 0, out.getvalue()[-3000:]
    if not compare:
        return
    ref = _load(EXAMPLES / f"{name}.py", f"ref_{name}")
    want = io.StringIO()
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + flags)
    with jax_reference(), contextlib.redirect_stdout(want):
        ref.main()
    assert _table(out.getvalue()) == _table(want.getvalue())
