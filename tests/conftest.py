"""Shared test fixtures. NOTE: never set XLA_FLAGS device-count here —
smoke tests and benches must see the single real CPU device; only
launch/dryrun.py fakes 512 devices (and only in its own process)."""
import os

# Keep test-time compilation lean and deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

# REPRO_STRICT_PROMOTION=1 runs the whole session under JAX's strict
# dtype-promotion regime: any implicit cross-kind promotion (the classic
# leak is a weak Python float widening an i32/u8 operand) becomes a
# TypePromotionError instead of a silent upcast the jaxpr lint would
# have to chase.  CI's simcheck job sets it for the core-sim modules;
# locally it is opt-in because third-party test deps may not be strict.
if os.environ.get("REPRO_STRICT_PROMOTION"):
    import jax

    jax.config.update("jax_numpy_dtype_promotion", "strict")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit (skips "
        "without one; chip_smoke.py runs the same checks on the card)")
