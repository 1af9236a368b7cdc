"""Whole runs of the port with telemetry and burn-rate alerting on, on the
network fabric under chaos, against the JAX reference: every leaf,
trace, report, streamed metric row and alert row equal, and every
simulation leaf equal to the same run with both off
(``test_torch_obs_runs.py`` holds the helpers)."""
from __future__ import annotations

import torch

from test_torch_obs_runs import check_combo

torch.set_num_threads(1)


def test_fabric_chaos_runs_match_reference():
    check_combo("fabric", "chaos")
