"""Serving driver of the port: batched decode in waves, and the prefill
program (the reference's ``repro.launch.serve`` and the ``prefill_step``
of ``repro.launch.specs``).

A miniature batch server: up to ``--batch-slots`` requests decode in
lock-step (one shared position counter); each wave feeds its prompts
token by token (forced), then generates greedily (``argmax``) or, with
``--temperature``, by Gumbel-max sampling on ``repro_torch.random``'s
threefry keys in the reference's key schedule.  Tokens stay on the device
during a wave; the host reads them back once per wave.  On the card each
token step replays ``DecodeGraph``, ``LM.decode_step`` captured once as
a CUDA graph (the reference's ``jax.jit(model.decode_step)``); sampling
stays outside the graph, as the reference jits only the decode step.  On
the CPU the step runs eagerly.  The encdec family (whisper-base) decodes
against the zero cross K/V of ``init_decode_state``, and the vlm family
(qwen2-vl-7b) feeds its tokens through the embedding table, as the
reference's server does.  The hybrid (jamba-1.5-large) decodes its
periods' KV caches and Mamba states in place; at full width it needs
more than one card, so it is served cut (``main(argv, cfg=)``).

  python -m repro_torch.launch.serve --arch qwen3-0.6b          # on the GPU
  python -m repro_torch.launch.serve --arch whisper-base
  python -m repro_torch.launch.serve --preset tiny --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from .. import random as rnd
from ..configs import ARCH_IDS, get_config
from ..configs.base import ArchConfig
from ..core.types import resolve_device
from ..models import build_model

# the presets of this driver and of launch/train.py (defined here once)
PRESETS = {
    # ~8M-param decoder (runs a few steps/s on one CPU core)
    "tiny": ArchConfig(name="tiny", family="dense", n_layers=4,
                       d_model=256, n_heads=4, n_kv=2, head_dim=64,
                       d_ff=1024, vocab=2048, tie_embeddings=True),
    # ~110M-param decoder (the "~100M model" example target)
    "100m": ArchConfig(name="100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv=4, head_dim=64,
                       d_ff=3072, vocab=32768, tie_embeddings=True),
}

_TINY = float(np.finfo(np.float32).tiny)


def prefill_step(model, params, batch):
    """The prefill program: the full-sequence forward without remat, then
    the logits of the last position, [B, 1, V] float32.  ``batch`` holds
    ``tokens`` (and ``frames`` [B, F, d] for the encdec family: the
    encoder, then the decoder against its output), or for the vlm family
    ``embeds`` [B, T, d] and ``positions`` [3, B, T]."""
    if model.cfg.family == "encdec":
        enc = model.encode(params, batch["frames"])
        h = model.decode_train(params, batch["tokens"], enc)
        return model.logits(params, h[:, -1:])
    h = model.hidden_states(params, tokens=batch.get("tokens"),
                            embeds=batch.get("embeds"),
                            positions=batch.get("positions"), remat=False)
    return model.logits(params, h[:, -1:])


def gumbel(key: torch.Tensor, shape, device) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, the default low-range mode):
    -log(-log(u)) for u uniform on [tiny, 1)."""
    u = rnd.uniform(key, shape, _TINY, 1.0, device=device)
    return -torch.log(-torch.log(u))


class DecodeGraph:
    """``model.decode_step`` at ``batch`` slots and ``max_seq`` cache slots,
    captured as a CUDA graph over a static ``[batch, 1]`` token buffer and
    a static ``DecodeState``: ``reset()`` zeroes the state in place (a new
    wave), ``step(tokens)`` copies the tokens in, replays, and returns the
    logits ``[batch, 1, V]`` (a buffer the next step overwrites).  The
    capture follows one warm-up step on a side stream; both take
    ``compile_time_s``, and a failed capture raises."""

    def __init__(self, model, params, batch: int, max_seq: int, device):
        dev = resolve_device(device)
        t0 = time.perf_counter()
        self.params = params      # the graph reads these buffers
        self.tokens = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.state = model.init_decode_state(batch, max_seq, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            model.decode_step(params, self.tokens, self.state)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, _ = model.decode_step(params, self.tokens,
                                               self.state)
        self.reset()
        torch.cuda.synchronize(dev)
        self.compile_time_s = time.perf_counter() - t0

    def reset(self) -> None:
        for t in _leaves(self.state):
            t.zero_()

    def step(self, tokens: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.graph.replay()
        return self.logits


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [t for v in tree for t in _leaves(v)]


def serve_waves(model, params, prompts: List[np.ndarray], *,
                batch_slots: int, prompt_len: int, gen_len: int,
                max_seq: int, temperature: float = 0.0, seed: int = 0,
                device="cuda", record: Optional[list] = None,
                info: Optional[dict] = None):
    """Decode ``prompts`` in waves of ``batch_slots``; returns the
    generated tokens of each request, and the decode-token count.  With
    ``record`` a list, each step's logits [B, V] are appended to it (on
    the card, copies of the graph's output).  With ``info`` a dict, the
    decode graph's capture time goes to ``info["compile_time_s"]`` (0.0 on
    the CPU)."""
    dev = resolve_device(device)
    B = batch_slots
    key = rnd.PRNGKey(seed + 1)
    outputs: List[List[int]] = []
    tokens_out = 0
    graph = (DecodeGraph(model, params, B, max_seq, dev)
             if dev.type == "cuda" else None)
    if info is not None:
        info["compile_time_s"] = graph.compile_time_s if graph else 0.0
    for wave_start in range(0, len(prompts), B):
        wave = prompts[wave_start:wave_start + B]
        n = len(wave)
        forced = np.zeros((B, prompt_len), np.int64)  # idle slots feed 0
        forced[:n] = np.stack(wave)
        forced_t = torch.from_numpy(forced).to(dev)
        live = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        live[:n] = True
        if graph is None:
            state = model.init_decode_state(B, max_seq, device=dev)
        else:
            graph.reset()
        cur = forced_t[:, :1]
        gen = []
        for t in range(1, prompt_len + gen_len):
            key, sub = rnd.split(key)
            if graph is None:
                logits, state = model.decode_step(params, cur, state)
            else:
                logits = graph.step(cur)
            lg = logits[:, 0]
            if record is not None:
                record.append(lg.clone())
            if temperature > 0:
                nxt = torch.argmax(
                    gumbel(sub, lg.shape, dev) + lg / temperature, dim=-1)
            else:
                nxt = torch.argmax(lg, dim=-1)
            tokens_out += n
            if t < prompt_len:
                cur = forced_t[:, t:t + 1]
            else:
                cur = torch.where(live, nxt[:, None], 0)
                gen.append(nxt)
        got = torch.stack(gen, dim=1).cpu().numpy() if gen else \
            np.zeros((B, 0), np.int64)
        outputs.extend([int(v) for v in got[s]] for s in range(n))
    return outputs, tokens_out


def main(argv=None, cfg: Optional[ArchConfig] = None):
    """The server's command line; ``cfg``, where given, takes the place of
    ``--arch``'s or ``--preset``'s config (a variant of it, such as its
    int8 KV cache)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    assert args.prompt_len + args.gen_len < args.max_seq

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch) if args.arch else PRESETS[args.preset]
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init_params(gen, dev)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    info = {}
    outputs, tokens_out = serve_waves(
        model, params, prompts, batch_slots=args.batch_slots,
        prompt_len=args.prompt_len, gen_len=args.gen_len,
        max_seq=args.max_seq, temperature=args.temperature, seed=args.seed,
        device=dev, info=info)
    dt = time.perf_counter() - t0
    cap = info["compile_time_s"]
    print(f"served {args.requests} requests, {tokens_out} decode tokens "
          f"in {dt:.2f}s ({tokens_out / dt:.1f} tok/s)")
    if dev.type == "cuda":
        print(f"decode graph captured in {cap:.3f}s; the rest "
              f"{dt - cap:.3f}s ({tokens_out / (dt - cap):.1f} tok/s)")
    print("sample output:", outputs[0][:16])
    return outputs


if __name__ == "__main__":
    main()
