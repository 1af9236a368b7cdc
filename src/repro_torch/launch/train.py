"""Training driver of the port (the reference's ``repro.launch.train``):
the synthetic pipeline → the train step (AdamW, remat, optional gradient
compression) → rolling async checkpoints → crash-resume, bit for bit
thanks to the step-indexed pipeline.

  python -m repro_torch.launch.train --preset tiny --device cpu
  python -m repro_torch.launch.train --arch qwen3-0.6b --seq 4096 --batch 2
  python -m repro_torch.launch.train --arch mamba2-130m --seq 4096 --batch 8

On the card (the default) the attention layers run the flash kernel and
its backward (``csrc/flash_attention_bwd.cu``), the Mamba layers the SSD
kernel and its backward (``csrc/ssd_chunk_bwd.cu``); ``--device cpu``
runs the plain versions.  Every family the reference's driver trains
trains here, on ``SyntheticLM``'s tokens: dense, ssm, moe, vlm (tokens
through its embedding table, as the reference's driver feeds it) and
hybrid.  The encdec family needs frames, which the reference's driver
does not give (its ``loss_fn`` would fail on the batch): it raises here,
and whisper-base trains through ``make_train_step`` on
``data.batch_for``'s batches.  Parameters come from the port's own
``init_params`` (a ``torch.Generator`` seeded with ``--seed``); the
batches are the reference's bits.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..core.types import resolve_device
from ..data.synthetic import SyntheticLM
from ..models import build_model
from ..train.optimizer import AdamWCfg, adamw_init
from ..train.train_step import make_train_step
from .serve import PRESETS


def main(argv=None, on_step=None, cfg=None):
    """Train; returns the per-step losses (one host read of the loss a
    step).  ``on_step(step, params, opt, metrics)``, if given, is called
    after every step (chip_smoke times and counts through it); ``cfg``,
    where given, takes the place of ``--arch``'s or ``--preset``'s config
    (a variant of it, such as its ``reduced()`` config)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch) if args.arch else PRESETS[args.preset]
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the encdec family trains on frames, which this "
            "driver's token batches do not hold; train it through "
            "train.make_train_step on data.batch_for's batches")
    model = build_model(cfg)
    opt_cfg = AdamWCfg(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)
    # each step's state replaces the last: the update writes in place
    step_fn = make_train_step(model, opt_cfg,
                              compress_grads=args.compress_grads,
                              donate=True)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init_params(gen, device=device)
    opt = adamw_init(params)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        restored, step = mgr.restore_latest({"params": params, "opt": opt})
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            start = step + 1
            print(f"resumed from step {step}")

    losses = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = data.batch(step, device=device)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(step, params, opt, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt:.1f}s)", flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save({"params": params, "opt": opt}, step)
    if mgr:
        mgr.save({"params": params, "opt": opt}, args.steps - 1,
                 blocking=True)
    return losses


if __name__ == "__main__":
    main()
