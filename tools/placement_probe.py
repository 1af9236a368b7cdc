#!/usr/bin/env python3
"""How numpy's sort dispatch decides the port's initial placement.

``core.placement.initial_allocation`` (like the reference's) orders VMs by
``np.argsort(-free_mips)``, numpy's default, unstable sort, so the order
among VMs of equal free capacity is whatever the sort numpy dispatches to
gives.  For each of three settings of ``NPY_DISABLE_CPU_FEATURES`` (none;
AVX-512 off; AVX2, FMA3 and AVX-512 off, ``chip_smoke.NUMPY_BASELINE``)
this prints numpy's version and, for the Table 2 cases case1b, case2a and
case2b, a digest of the instance-to-VM map and its first entries.  Hosts
that print the same digests under a setting place instances alike under
it.  Needs only numpy and the port; run from the repository root:

    python tools/placement_probe.py
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r'''
import hashlib
import sys
sys.path.insert(0, "src")
import numpy as np
from repro_torch.configs import capacity
from repro_torch.core.placement import initial_allocation
out = [np.__version__]
for tag in ("case1b", "case2a", "case2b"):
    sim, _ = capacity.build_tagged(tag, device="cpu")
    h = lambda t: t.detach().cpu().numpy()
    app = sim.app
    inst, _, _ = initial_allocation(
        h(app.tmpl_replicas), h(app.tmpl_mips), h(app.tmpl_limit_mips),
        h(app.tmpl_ram), h(app.tmpl_limit_ram), h(app.tmpl_bw), sim.vm_mips,
        sim.vm_ram, sim.caps, policy=sim.placement_policy)
    digest = hashlib.sha256(inst["vm"].tobytes()).hexdigest()[:12]
    out.append(f"{tag} {digest} {inst['vm'][:6].tolist()}")
print("  ".join(out))
'''

AVX512 = ("AVX512F AVX512CD AVX512_SKX AVX512_CLX AVX512_CNL AVX512_ICL "
          "AVX512_SPR")
SETTINGS = (("default", None), ("AVX-512 off", AVX512),
            ("baseline", "AVX2 FMA3 " + AVX512))


def main() -> int:
    for name, disable in SETTINGS:
        env = dict(os.environ)
        env.pop("NPY_DISABLE_CPU_FEATURES", None)
        if disable:
            env["NPY_DISABLE_CPU_FEATURES"] = disable
        r = subprocess.run([sys.executable, "-c", CODE], env=env, cwd=ROOT,
                           capture_output=True, text=True)
        print(f"{name:12s} {r.stdout.strip()}{r.stderr.strip()[-300:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
