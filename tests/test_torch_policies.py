"""The port's policy variants against a live run of the JAX reference:
the random and least-loaded load balancers, SRPT sharing, the space-shared
concurrency cap and VM migration, each on the golden scenario (120
ticks).  Same contract as ``test_torch_sim.py``: the final state bit-
identical, integer traces equal, the ``used_mips`` trace bit for bit."""
import pytest

from test_layouts import matrix_sim
from test_torch_phases import jax_reference
from test_torch_sim import _assert_runs_match, _port_matrix_sim


@pytest.mark.parametrize("overrides", [
    dict(lb_policy=1), dict(lb_policy=2), dict(share_policy=1),
    dict(max_concurrent=2),
    dict(migration_enabled=True, mig_vm_util_hi=0.01, scale_interval=20),
], ids=["lb_random", "lb_least_loaded", "share_srpt", "space_shared",
        "migration"])
def test_policy_variants_match_live_reference(overrides):
    with jax_reference():
        jsim = matrix_sim("uniform", "none", n_ticks=120, **overrides)
        jres = jsim.run()
    tres = _port_matrix_sim(jsim).run()
    _assert_runs_match(jres, tres)
