"""Plain PyTorch version of the fused cloudlet execution tick (paper §4.2).

Progress, finish detection and every finish-side aggregate in one pass,
as ``repro.kernels.cloudlet_step.ref.cloudlet_finish`` defines them:

* per lane: ``rem -= rate·dt`` on executing lanes (one fused multiply-add,
  as the reference's compiled program computes it), the finish flag, the
  sub-tick finish time clipped to ``[t, t+dt]``, the MI consumed;
* per instance: one ``[I+1, 5]`` scatter-add of (used MI/s, finishes,
  sojourn, exec and wait sums), row ``I`` the overflow row;
* per request: ``max(finish)``, ``max(depth+1)`` and ``outstanding -= fin``.

``cloudlet_step`` is the legacy five-output tick, the same pass with inert
request lanes.

Out-of-range instance and request ids are dropped, as the reference's
``mode="drop"``.  Float sums run in lane order (a serial scatter), which
is the reference's order on the CPU.  The CPU path and the tests use this
version; on the card the kernel of ``ops.py`` runs instead.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...random import div32, fma32

CL_EXEC = 2

# inst_acc column indices
ACC_USED, ACC_FIN, ACC_SOJOURN, ACC_EXEC, ACC_WAIT = range(5)


class FinishOut(NamedTuple):
    new_rem: torch.Tensor    # [C] f32
    fin: torch.Tensor        # [C] bool
    tfin: torch.Tensor       # [C] f32 sub-tick finish timestamp
    consumed: torch.Tensor   # [C] f32 MI consumed this tick
    inst_acc: torch.Tensor   # [I+1, 5] f32 (row I = overflow)
    req_finish: torch.Tensor  # [R] f32 updated max finish time
    req_crit: torch.Tensor    # [R] i32 updated max critical depth
    req_out: torch.Tensor     # [R] i32 updated outstanding count


def lane_math(status, rem, inst, arrival, start, rate, time, dt):
    """The elementwise core, shared with the kernel's tests: returns
    (new_rem, fin, tfin, consumed, rows [C,5] of the inst_acc terms)."""
    # a float32 scalar, as in the kernel (a 0-d tensor stays one: no read
    # back)
    dt = (dt.to(torch.float32) if isinstance(dt, torch.Tensor)
          else float(np.float32(dt)))
    execm = status == CL_EXEC
    prog = rate * dt
    fin = execm & (rem <= prog) & (rate > 0)
    tnext = time + dt
    tfin = torch.where(
        fin, torch.minimum(torch.maximum(
            time + rem / torch.clamp_min(rate, 1e-9), time), tnext), 0.0)
    consumed = torch.where(execm, torch.minimum(prog, rem), 0.0)
    # the reference's compiled program contracts rem - rate*dt into one
    # fused multiply-add (the rest rounds the product first)
    new_rem = torch.where(
        execm, torch.clamp_min(fma32(-rate, dt, rem), 0.0), rem)
    started = torch.maximum(start, arrival)
    sojourn = torch.where(fin, tfin - arrival, 0.0)
    exec_t = torch.where(fin, tfin - started, 0.0)
    wait_t = torch.where(fin, started - arrival, 0.0)
    rows = torch.stack([div32(consumed, dt), fin.float(), sojourn, exec_t,
                        wait_t], dim=1)
    return new_rem, fin, tfin, consumed, rows


def cloudlet_finish(status, rem, inst, req, arrival, start, depth, rate,
                    time, dt, req_finish, req_crit, req_out,
                    n_inst: int) -> FinishOut:
    """All [C] inputs are 1-D; ``time`` a 0-d tensor, ``dt`` a number or
    a 0-d float32 tensor.
    Returns new request arrays (the inputs are not modified)."""
    n_req = req_finish.shape[0]
    execm = status == CL_EXEC
    new_rem, fin, tfin, consumed, rows = lane_math(
        status, rem, inst, arrival, start, rate, time, dt)

    iidx = torch.where(execm & (inst >= 0), inst, n_inst).long()
    iidx = torch.where(iidx <= n_inst, iidx, n_inst + 1)   # drop past I
    acc = torch.zeros((n_inst + 2, 5), dtype=torch.float32,
                      device=rem.device)
    if acc.is_cuda:   # the sort-based path: lane order, not atomics
        acc.index_put_((iidx,), rows, accumulate=True)
    else:
        acc.index_add_(0, iidx, rows)
    inst_acc = acc[:n_inst + 1]

    ok = fin & (req >= 0) & (req < n_req)
    ridx = torch.where(ok, req, n_req).long()
    ext = lambda x, fill: torch.cat([x, x.new_full((1,), fill)])
    req_finish = ext(req_finish, 0.0).scatter_reduce_(
        0, ridx, tfin, "amax")[:n_req]
    req_crit = ext(req_crit, 0).scatter_reduce_(
        0, ridx, (depth + 1).to(req_crit.dtype), "amax")[:n_req]
    req_out = ext(req_out, 0).index_add_(
        0, ridx, -fin.to(req_out.dtype))[:n_req]
    return FinishOut(new_rem=new_rem, fin=fin, tfin=tfin, consumed=consumed,
                     inst_acc=inst_acc, req_finish=req_finish,
                     req_crit=req_crit, req_out=req_out)


def inert_lanes(rem, inst):
    """The request-side inputs of :func:`cloudlet_finish` that make its
    request lanes inert (the legacy five-output tick's): no request,
    arrival and start 0, depth 0, one-row request arrays."""
    dev = rem.device
    zf = torch.zeros_like(rem)
    return (torch.full_like(inst, -1), zf, zf, torch.zeros_like(inst),
            torch.zeros(1, dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def cloudlet_step(status, rem, inst, rate, time, dt, n_inst: int):
    """The legacy five-output tick (the reference's ``ref.cloudlet_step``):
    ``(new_rem, fin, tfin, consumed, used)``, ``used`` ``[n_inst]`` the
    MI/s each instance's executing lanes consumed, summed in lane order.
    It is :func:`cloudlet_finish` with inert request lanes, as the
    reference's ``cloudlet_step_pallas`` computes it, keeping
    ``inst_acc[:n_inst, 0]``."""
    req, arrival, start, depth, *reqs = inert_lanes(rem, inst)
    out = cloudlet_finish(status, rem, inst, req, arrival, start, depth,
                          rate, time, dt, *reqs, n_inst=n_inst)
    return (out.new_rem, out.fin, out.tfin, out.consumed,
            out.inst_acc[:n_inst, ACC_USED])


def cloudlet_finish_batched(status, rem, inst, req, arrival, start, depth,
                            rate, time, dt, req_finish, req_crit, req_out,
                            n_inst: int) -> FinishOut:
    """:func:`cloudlet_finish` for a batch: ``[B, C]`` lanes, ``time``
    ``[B]``, ``dt`` ``[B]`` (a tensor) or one number, ``[B, R]`` request
    arrays; the solo plain version point by point, stacked.  Not the
    card's path (the kernel takes a batch in one launch): the CPU's, and
    the comparisons'."""
    outs = []
    for b in range(rate.shape[0]):
        d = dt[b] if isinstance(dt, torch.Tensor) else dt
        outs.append(cloudlet_finish(
            status[b], rem[b], inst[b], req[b], arrival[b], start[b],
            depth[b], rate[b], time[b], d, req_finish[b], req_crit[b],
            req_out[b], n_inst=n_inst))
    return FinishOut(*[torch.stack(x) for x in zip(*outs)])
