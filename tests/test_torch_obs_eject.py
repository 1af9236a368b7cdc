"""The alert-driven outlier-ejection tightening of chaos mode
(``slo_eject_tighten``, read one tick late from the alert state) on the
port, as one ``run_batch`` of two arms, against the JAX reference's:
every leaf, trace, streamed metric row and alert row equal (tolerance
zero)."""
from __future__ import annotations

import dataclasses

import torch

from test_layouts import matrix_sim
from test_torch_obs_runs import HOT_KW, run_both
from test_torch_sim import _port_matrix_sim

torch.set_num_threads(1)


def test_ejection_tightening_matches_reference():
    """Chaos with every completion an SLO miss, so burn alerts fire, and
    latency ejection on: the arm that tightens the ejection thresholds to
    0.3 while alerts fire ejects more replicas than the one that keeps
    them (``slo_eject_tighten=1`` multiplies exactly)."""
    jsim = matrix_sim("uniform", "chaos", **HOT_KW, eject_err_thresh=0.5,
                      eject_lat_factor=1.5)
    tsim = _port_matrix_sim(jsim)
    jpts = [dataclasses.replace(jsim.params, slo_eject_tighten=t)
            for t in (1.0, 0.3)]
    tpts = [dataclasses.replace(tsim.params, slo_eject_tighten=t)
            for t in (1.0, 0.3)]
    res, _, _ = run_both(jsim, tsim, "tightening", jpts, tpts)
    ej = res.state.fstats.ejections
    assert int(ej[1]) > int(ej[0])
