"""Request Generator (paper §4.3.1, Algorithm 1, Eqs 1–4).

Vectorized Locust-style closed-loop client model: ``N_c`` clients ramp up at
``v`` clients/second; each client fires a request at a weighted-random API,
then sleeps uniform ``[p0, p1]`` seconds.  The closed forms of Eqs 1, 3, 4
are the ``*_analytic`` functions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import random as rnd
from ..analysis import streams
from .batch import solo_as_batch
from .types import DynParams, SimParams


class GenOut(NamedTuple):
    fired: torch.Tensor       # [B, Nc] bool — client fired this tick
    api: torch.Tensor         # [B, Nc] i32 — chosen API (valid where fired)
    n_active: torch.Tensor    # [B] i32 — active clients (Eq 1)
    wait_proposal: torch.Tensor  # [B, Nc] i32 — next wait if the fire is
    #                              accepted


@solo_as_batch("time", "wait", "time", "req_count", "api_weight_cdf")
def client_phase(wait: torch.Tensor, time: torch.Tensor,
                 req_count: torch.Tensor, api_weight_cdf: torch.Tensor,
                 dyn: DynParams, rng: torch.Tensor) -> GenOut:
    """One generation tick (paper Alg 1 lines 4–17, vectorized): fire
    decisions + proposed wait resets; the engine commits them after
    admission (backpressure may defer a fire to the next tick).  Each
    point of the batch has its own clients, clock, API weights and swept
    values; the draws are shared."""
    B, Nc = wait.shape
    dev = wait.device
    idx = torch.arange(Nc, dtype=torch.int32, device=dev)
    # Eq 1: N(t) = min(Nc, v * t)   (ramp at spawn rate v).
    n_active = torch.minimum(
        torch.floor(dyn.spawn_rate * time).to(torch.int32) + 1,
        dyn.n_clients)
    active = idx < n_active[:, None]
    under_limit = req_count < dyn.num_limit
    fired = active & (wait <= 0) & under_limit[:, None]

    k_api, k_wait = streams.split(rng, names=("api", "wait"))
    # Weighted API selection (Alg 1 line 9): inverse-CDF on the weight set.
    u = rnd.uniform(k_api, (Nc,), device=dev)
    api = torch.searchsorted(api_weight_cdf, u.expand(B, Nc).contiguous(),
                             right=False).to(torch.int32)
    api = torch.clamp_max(api, api_weight_cdf.shape[-1] - 1)

    # Alg 1 line 13: wait ~ U[p0, p1] (converted to ticks, ≥ 1); the
    # reference's compiled program fuses the multiply-add.
    span = dyn.wait_hi - dyn.wait_lo
    wait_s = rnd.fma32(rnd.uniform(k_wait, (Nc,), device=dev), span[:, None],
                       dyn.wait_lo[:, None])
    wait_ticks = torch.clamp_min(
        torch.round(rnd.div32(wait_s, dyn.dt[:, None])), 1).to(torch.int32)
    return GenOut(fired=fired, api=api, n_active=n_active,
                  wait_proposal=wait_ticks)


# --------------------------------------------------------------------------
# Closed forms (paper Eqs 1, 3, 4) — used to validate the generator (Fig 9).
# --------------------------------------------------------------------------

def n_clients_analytic(t: np.ndarray, params: SimParams) -> np.ndarray:
    """Eq 1: N(t) = min(N_c, v·t)."""
    return np.minimum(params.n_clients, params.spawn_rate * np.asarray(t))


def qps_analytic(t: np.ndarray, params: SimParams) -> np.ndarray:
    """Eq 3: λ(t) = N(t) · 2/(p0+p1)."""
    return (n_clients_analytic(t, params) * 2.0
            / (params.wait_lo + params.wait_hi))


def total_requests_analytic(t: np.ndarray, params: SimParams) -> np.ndarray:
    """Eq 4: piecewise ∫λ — quadratic during ramp-up, linear afterwards."""
    t = np.asarray(t, dtype=np.float64)
    Nc, v = params.n_clients, params.spawn_rate
    psum = params.wait_lo + params.wait_hi
    t_ramp = Nc / v
    ramp = v / psum * t ** 2
    steady = 2.0 * Nc / psum * t - Nc ** 2 / (v * psum)
    return np.where(t <= t_ramp, ramp, steady)


def api_weight_cdf(weights: np.ndarray) -> np.ndarray:
    """Normalized cumulative API weights (float32, last entry exactly 1)."""
    w = np.asarray(weights, dtype=np.float64)
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    return cdf.astype(np.float32)
