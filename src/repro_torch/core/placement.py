"""Service placement & migration (paper §5.1, Algorithm 3).

Initial allocation runs host-side (numpy) at build time — it is
configuration, not state, and every point of a sweep starts from it.
Runtime migration (overloaded VM → cooler VM) runs inside the tick loop
on the device, without synchronising.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import policies
from .app import AppStatic
from .batch import solo_as_batch
from .pool import at
from .types import DynParams, INST_ON, SimCaps, SimState


class PlacementError(RuntimeError):
    pass


def initial_allocation(app_replicas: np.ndarray, tmpl_mips: np.ndarray,
                       tmpl_limit_mips: np.ndarray, tmpl_ram: np.ndarray,
                       tmpl_limit_ram: np.ndarray, tmpl_bw: np.ndarray,
                       vm_mips: np.ndarray, vm_ram: np.ndarray,
                       caps: SimCaps,
                       policy: int = policies.PLACE_MOST_AVAILABLE,
                       ) -> Tuple[dict, np.ndarray, np.ndarray]:
    """Paper Algorithm 3: deploy every service's replicas onto VMs.

    VMs are kept in a priority order by available CPU ("sortedQueue …
    descending available PE resources"); each instance goes to the head VM
    that fits.  Returns (instance field dict, inst_of_rank, svc_replicas).
    """
    S = len(app_replicas)
    I, V = caps.max_instances, caps.n_vms
    if len(vm_mips) != V:
        raise PlacementError(f"expected {V} VMs, got {len(vm_mips)}")

    inst = {
        "status": np.zeros(I, np.int32),
        "service": np.full(I, -1, np.int32),
        "vm": np.full(I, -1, np.int32),
        "host": np.full(I, -1, np.int32),
        "mips": np.zeros(I, np.float32),
        "limit_mips": np.zeros(I, np.float32),
        "request_mips": np.zeros(I, np.float32),
        "ram": np.zeros(I, np.float32),
        "limit_ram": np.zeros(I, np.float32),
        "bw": np.zeros(I, np.float32),
    }
    vm_used_mips = np.zeros(V, np.float64)
    vm_used_ram = np.zeros(V, np.float64)
    inst_of_rank = np.full((S, caps.max_replicas), -1, np.int32)
    svc_replicas = np.zeros(S, np.int32)

    slot = 0
    for s in range(S):
        n_rep = int(app_replicas[s])
        if n_rep > caps.max_replicas:
            raise PlacementError(
                f"service {s}: {n_rep} replicas > "
                f"max_replicas={caps.max_replicas}")
        for r in range(n_rep):
            if slot >= I:
                raise PlacementError(
                    "instance pool exhausted during placement")
            free_mips = vm_mips - vm_used_mips
            free_ram = vm_ram - vm_used_ram
            if policy == policies.PLACE_FIRST_FIT:
                order = np.arange(V)
            elif policy == policies.PLACE_BEST_FIT:
                order = np.argsort(free_mips)            # tightest fit first
            elif policy == policies.PLACE_SPREAD:
                order = np.roll(np.arange(V), -slot)     # cycle hosts
            else:  # PLACE_MOST_AVAILABLE (paper default)
                order = np.argsort(-free_mips)
            placed = False
            for v in order:
                if (free_mips[v] >= tmpl_mips[s]
                        and free_ram[v] >= tmpl_ram[s]):
                    inst["status"][slot] = INST_ON
                    inst["service"][slot] = s
                    inst["vm"][slot] = v
                    inst["host"][slot] = v     # NIC attachment = VM's node
                    inst["mips"][slot] = tmpl_mips[s]
                    inst["limit_mips"][slot] = tmpl_limit_mips[s]
                    inst["request_mips"][slot] = tmpl_mips[s]
                    inst["ram"][slot] = tmpl_ram[s]
                    inst["limit_ram"][slot] = tmpl_limit_ram[s]
                    inst["bw"][slot] = tmpl_bw[s]
                    vm_used_mips[v] += tmpl_mips[s]
                    vm_used_ram[v] += tmpl_ram[s]
                    inst_of_rank[s, r] = slot
                    svc_replicas[s] += 1
                    slot += 1
                    placed = True
                    break
            if not placed:
                raise PlacementError(
                    f"service {s} replica {r}: no VM fits "
                    f"(mips={tmpl_mips[s]}, ram={tmpl_ram[s]})")
    return inst, inst_of_rank, svc_replicas


def _onehot(n: int, i: torch.Tensor) -> torch.Tensor:
    """``[B, n]``: True at ``i[b]`` in row ``b``."""
    return torch.arange(n, device=i.device) == i[:, None]


@solo_as_batch("state")
def migrate(state: SimState, app: AppStatic, caps: SimCaps,
            dyn: DynParams) -> SimState:
    """One migration step (paper §5.1): if the hottest VM exceeds the
    utilization threshold, move its smallest instance to the coolest VM
    (each point of the batch on its own)."""
    inst, vms = state.instances, state.vms
    V = vms.mips.shape[1]
    I = inst.mips.shape[1]
    util = vms.mips_used / torch.clamp_min(vms.mips, 1e-9)
    hot = torch.argmax(util, dim=1)
    util_hot = at(util, hot)
    need = util_hot > dyn.mig_vm_util_hi

    on_hot = (inst.status == INST_ON) & (inst.vm == hot[:, None])
    cand_mips = torch.where(on_hot, inst.mips, float("inf"))
    mover = torch.argmin(cand_mips, dim=1)
    movable = need & at(on_hot, mover)

    # never migrate onto the source VM or a down host
    free = torch.where(_onehot(V, hot) | (state.fault.host_up <= 0),
                       float("-inf"), vms.mips - vms.mips_used)
    tgt = torch.argmax(free, dim=1)
    m_mips, m_ram = at(inst.mips, mover), at(inst.ram, mover)
    fits = (at(free, tgt) >= m_mips) & \
        (at(vms.ram, tgt) - at(vms.ram_used, tgt) >= m_ram)
    # anti-ping-pong hysteresis: the target must end strictly cooler
    tgt_util_after = (at(vms.mips_used, tgt) + m_mips) \
        / torch.clamp_min(at(vms.mips, tgt), 1e-9)
    do = movable & fits & (tgt_util_after < util_hot - 1e-6)

    dm = torch.where(do, m_mips, 0.0)[:, None]
    dr = torch.where(do, m_ram, 0.0)[:, None]
    oh_hot, oh_tgt = _onehot(V, hot), _onehot(V, tgt)
    mips_used = torch.where(oh_hot, vms.mips_used - dm, vms.mips_used)
    mips_used = torch.where(oh_tgt, mips_used + dm, mips_used)
    ram_used = torch.where(oh_hot, vms.ram_used - dr, vms.ram_used)
    ram_used = torch.where(oh_tgt, ram_used + dr, ram_used)
    vms = vms._replace(mips_used=mips_used, ram_used=ram_used)
    new_vm = torch.where(do, tgt.to(torch.int32), at(inst.vm, mover))
    oh_mover = _onehot(I, mover)
    inst = inst._replace(
        vm=torch.where(oh_mover, new_vm[:, None], inst.vm),
        host=torch.where(oh_mover, new_vm[:, None], inst.host))
    counters = state.counters._replace(
        migrations=state.counters.migrations + do.to(torch.int32))
    return state._replace(instances=inst, vms=vms, counters=counters)
