"""CloudNativeSim × the LM substrate on the PyTorch port: capacity-plan an
LLM serving fleet (the twin of ``examples/llm_serving_sim.py``).

The service graph models an LLM inference cluster (router → prefill pool
→ decode pool → detokenizer); per-stage cloudlet lengths come from the
roofline cost model of the chosen architecture (``repro_torch.launch.
roofline``'s H100 constants), and the paper's HS autoscaler manages the
pools under a bursty load.  Both arms, a static fleet and the HS
autoscaler, run on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_llm_serving_sim.py --arch qwen3-0.6b
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,  # noqa
                              Simulation, build_graph, policies, summarize)
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.common import n_params  # noqa: E402


def stage_costs_ms(arch: str, prompt_len=1024, gen_len=128, batch=8):
    """Per-request stage service times from the arch's roofline model."""
    n = n_params(build_model(get_config(arch)).schema())
    # assumed fractions of the H100's peak: 40% of its FLOP rate in
    # prefill and 60% of its HBM bandwidth in decode (not measured)
    mfu, mbu = 0.4, 0.6
    # prefill: compute-bound, 2·N·prompt FLOPs
    t_prefill = 2 * n * prompt_len / (PEAK_FLOPS * mfu)
    # decode: memory-bound, gen_len × (param bytes / HBM bw) / batch
    t_decode = gen_len * (2 * n / (HBM_BW * mbu)) / batch
    return {"router": 2.0, "prefill": t_prefill * 1e3,
            "decode": t_decode * 1e3, "detok": 1.0}


ARMS = ((policies.SCALE_NONE, "static fleet"),
        (policies.SCALE_HORIZONTAL, "HS autoscaler"))


def make_sims(arch: str, clients: int, duration: float, device="cuda"):
    """(label, Simulation) of both arms."""
    costs = stage_costs_ms(arch)
    # 1 MIPS ≡ 1 ms of stage work → cloudlet length in "ms units"
    graph = build_graph(
        ["router", "prefill", "decode", "detok"],
        {"router": ["prefill"], "prefill": ["decode"],
         "decode": ["detok"]},
        [("POST /generate", "router", 1.0)],
        {k: max(v, 0.5) for k, v in costs.items()},
    )
    caps = SimCaps(n_clients=max(clients, 1), max_requests=65536,
                   max_cloudlets=16384, max_instances=64, n_vms=8,
                   d_max=1, max_replicas=12)
    out = []
    for policy, label in ARMS:
        params = SimParams(
            dt=0.05, n_ticks=int(duration / 0.05),
            n_clients=clients, spawn_rate=clients / 60.0,
            wait_lo=2.0, wait_hi=8.0, slo_ms=4000.0,
            scaling_policy=policy, scale_interval=300,
            hs_util_hi=0.6, hs_util_lo=0.1, util_ema=0.05)
        out.append((label, Simulation(
            graph, caps=caps, params=params,
            default_template=InstanceTemplate(
                mips=1000.0, limit_mips=4000.0, replicas=1,
                ram=4096.0, limit_ram=8192.0),
            vm_mips=np.full(8, 64_000.0, np.float32),
            vm_ram=np.full(8, 10_0000.0, np.float32), device=device)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--clients", type=int, default=150)
    ap.add_argument("--duration", type=float, default=600.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    costs = stage_costs_ms(args.arch)
    print(f"{args.arch} stage costs (ms/request): "
          + ", ".join(f"{k}={v:.1f}" for k, v in costs.items()))
    reports = []
    for label, sim in make_sims(args.arch, args.clients, args.duration,
                                args.device):
        rep = summarize(sim, sim.run())
        reports.append((label, rep))
        print(f"\n=== {label} ({args.arch}) ===")
        print(f"  completed {rep.completed_requests}  "
              f"avg {rep.avg_response_ms:.0f} ms  "
              f"p95 {rep.p95_response_ms:.0f} ms  "
              f"SLO viol {rep.slo_violation_rate:.1%}  "
              f"replicas+{rep.scale_out}/-{rep.scale_in}")
    return reports


if __name__ == "__main__":
    main()
