"""SockShop end-to-end on the PyTorch port: the paper's §6.3 case study
through the file registry (the twin of ``examples/sockshop_sim.py``).

Writes the two registry documents (Fig 3 JSON + YAML) to disk, registers
them, runs the calibrated 600-second experiment at 100 and 300 clients
and compares with the paper's testbed measurements.  Without PyYAML the
instance document is registered from its dict, and the output says so.
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_sockshop_sim.py
"""
import argparse
import json
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import sockshop  # noqa: E402
from repro_torch.core import register, summarize  # noqa: E402

LOADS = (100, 300)
DURATION_S = 600.0


def write_documents(tmp: pathlib.Path):
    """The Fig 3 documents on disk: (app document path, instance document
    as registered: its YAML path, or its dict where PyYAML is absent)."""
    app_json = tmp / "app.json"
    app_json.write_text(json.dumps(sockshop.app_spec(
        mi_scale=sockshop.CALIBRATED["mi_scale"]), indent=2))
    inst = sockshop.instance_spec(share=sockshop.CALIBRATED["share"])
    try:
        import yaml
    except ImportError:
        print(f"registry document written to {tmp}/app.json; PyYAML is not "
              "installed, so instances.yaml is not written and the "
              "instance document is registered from its dict")
        return app_json, inst
    inst_yaml = tmp / "instances.yaml"
    inst_yaml.write_text(yaml.safe_dump(inst))
    print(f"registry documents written to {tmp}/ (paper Fig 3 formats)")
    return app_json, inst_yaml


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="sockshop_"))
    app_doc, inst_doc = write_documents(tmp)
    # the documents read back give the calibrated deployment's tables
    want = sockshop.make_sim(n_clients=LOADS[0], duration_s=DURATION_S,
                             device=args.device)
    sim = register(app_doc, inst_doc, caps=want.caps, params=want.params,
                   device=args.device)
    ok = (sim.graph.names == want.graph.names
          and all(a.equal(b) for a, b in zip(sim.app, want.app)))
    print(f"registered {len(sim.graph.names)} services and "
          f"{int(sim.app.tmpl_replicas.sum())} replicas from the documents"
          + (": the calibrated deployment" if ok
             else " (!) not the calibrated deployment"))

    for n_clients in LOADS:
        sim = sockshop.make_sim(n_clients=n_clients, duration_s=DURATION_S,
                                device=args.device)
        rep = summarize(sim, sim.run())
        ref = sockshop.TESTBED_MS[n_clients]
        acc = 1 - abs(rep.avg_response_ms - ref) / ref
        print(f"\n=== {n_clients} clients ===")
        print(f"  simulated avg response {rep.avg_response_ms:7.0f} ms")
        print(f"  paper testbed          {ref:7.0f} ms  (accuracy {acc:.1%})")
        print(f"  p95 {rep.p95_response_ms:.0f} ms  qps {rep.qps_mean:.1f}  "
              f"SLO violations {rep.slo_violation_rate:.1%}")
        ok = ok and rep.completed_requests > 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
