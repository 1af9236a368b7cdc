"""Whole runs of the port with telemetry and burn-rate alerting on, on the
uniform network under chaos, against the JAX reference: every leaf,
trace, report, streamed metric row and alert row equal, and every
simulation leaf equal to the same run with both off
(``test_torch_obs_runs.py`` holds the helpers)."""
from __future__ import annotations

import torch

from test_torch_obs_runs import check_combo

torch.set_num_threads(1)


def test_uniform_chaos_runs_match_reference():
    check_combo("uniform", "chaos")
