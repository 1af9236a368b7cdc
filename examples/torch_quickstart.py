"""Quickstart on the PyTorch port: simulate the paper's Fig 6 diamond app
(the twin of ``examples/quickstart.py``), then check the Alg 2 critical
path against the simulated response.  Runs on the card unless ``--device
cpu`` is given.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,  # noqa
                              Simulation, critical_path, diamond,
                              node_delays, report_text, summarize)

N_TICKS = 2400          # 120 simulated seconds at dt 0.05
# the verdict: Alg 2's prediction within this fraction of the simulated
# average response
CRITICAL_PATH_TOL = 0.05


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # Service DAG from paper Fig 6: A → {B, C} → D (C is 2× heavier).
    graph = diamond(mi=500.0)
    sim = Simulation(
        graph,
        caps=SimCaps(n_clients=32, max_requests=4096, max_cloudlets=4096,
                     max_instances=16, n_vms=4, d_max=2, max_replicas=4),
        params=SimParams(dt=0.05, n_ticks=N_TICKS,
                         n_clients=20, spawn_rate=2.0,  # Alg 1 client model
                         wait_lo=1.0, wait_hi=3.0, slo_ms=1500.0),
        default_template=InstanceTemplate(mips=11000.0, limit_mips=22000.0),
        device=args.device)

    result = sim.run()
    report = summarize(sim, result)
    print(report_text(report))

    # Alg 2: critical path over measured node delays
    delays = node_delays(result)
    rt, path = critical_path(graph, delays, api=0)
    print("\ncritical path:", " → ".join(graph.names[i] for i in path),
          f"(predicted response {rt * 1000:.0f} ms, "
          f"simulated avg {report.avg_response_ms:.0f} ms)")
    gap = abs(rt * 1000 - report.avg_response_ms) / report.avg_response_ms
    if gap > CRITICAL_PATH_TOL:
        print(f"(!) the critical path is {gap:.1%} off the simulated "
              f"response (tolerance {CRITICAL_PATH_TOL:.0%})")
        return 1
    print(f"critical path within {gap:.1%} of the simulated response")
    return 0


if __name__ == "__main__":
    sys.exit(main())
