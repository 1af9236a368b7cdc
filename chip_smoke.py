#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA GPU and the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. device and build: the card's name and power limit, then the seven
   CUDA sources built from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel); the ``ptxas`` registers and spills per kernel of
   the simulator's ``tropical``, ``cloudlet_finish`` and ``link_share``
   builds and of each model-zoo build (flash attention, its backward, the
   SSD chunk, its backward), where the two tropical kernels, the
   tensor-core kernels (``flash_fwd_sm90``, ``ssd_chunk_sm90``) and every
   kernel of the two backward builds (the flash backward's four:
   ``flash_bwd_dq_sm90``, ``flash_bwd_dkdv_sm90``, ``flash_bwd_dq``,
   ``flash_bwd_dkdv``; the SSD backward's five: the tensor-core
   ``ssd_bwd_ds``, ``ssd_bwd_dx``, ``ssd_bwd_db`` and the CUDA-core
   ``ssd_bwd_heads``, ``ssd_bwd_groups``) must be in the report and
   spill nothing; the tropical kernels' SASS (``cuobjdump --dump-sass``)
   counts of FADD and FMNMX, which must be equal (one max instruction a
   term), and the model-zoo builds' SASS (the SSD backward's too), which
   must hold ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA loads);
2. an empty kernel's launch (device and per call), the floor of the
   launch-bound simulator kernels; then each kernel against its plain
   PyTorch version on the card, at the main paths' shapes, with the route
   it takes: ``cloudlet_finish`` at the Table 2 case1b and case2b pool
   shapes and a pool with most lanes on one instance (every output, the
   instance sums included, bit-equal to the plain version run on a CPU
   copy of the inputs, two launches bit-identical, one device operation a
   call; whether the plain version's CUDA branch agrees is printed);
   ``tropical_matmul`` at the SockShop window-batch shape and the fleet
   shape (8 x 1024^3), and ``tropical_closure`` (the closure kernel: the
   identity and every squaring in one launch) at SockShop's Alg 2 shape
   (60 windows x 13 services, 2 squarings), each bit-equal to its plain
   version and timed beside its bound and the issue floor of an FADD and
   an FMNMX a term; ``link_share`` at the SockShop fabric,
   case1b+net and case2b+net shapes (rates bit-equal, two launches
   bit-identical) and at case1b+net's shape on chaos mode's inputs (a
   quarter of the egress and a fifth of the ingress ports at capacity 0,
   a fifth of the transfers cut out of the water-fill), bit-equal to the
   plain version on the card and on the CPU; both simulator kernels
   batched, one launch for every
   point (``cloudlet_finish`` at 8 x SockShop's pool and 4 x case2b's, the
   cooperative grid striding over the points' tiles; ``link_share`` at 8
   x SockShop's fabric and 2 x case2b+net's), each point bit-equal to its
   unbatched launch and to the plain version on a CPU copy; the
   reference's unpooled APIs (``kernels.cloudlet_step.cloudlet_step`` and
   ``cloudlet_finish``) at case1b's shape, one ``cloudlet_finish.cu``
   launch a call (one call of each counted on the kernels line), every
   output bit-equal to the plain version on a CPU copy, timed beside the
   pooled call and the stacking copy of their columns;
   ``flash_attention`` at qwen3-0.6b's prefill heads
   (B=1, Hq=16, Hkv=8, D=128, bfloat16: the tensor-core kernel) at
   T=4096 and at the prefill's own T=32,768, at the moe family's
   (qwen3-moe-30b-a3b: Hq=32, Hkv=4; qwen2-moe-a2.7b: Hq=Hkv=16) at
   32,768 and at granite-20b's MQA (Hq=48, Hkv=1) at 4096, each element
   within one bfloat16 rounding of the plain version (run in query
   blocks at 32,768), with its TFLOP/s, share of the bound and ratio to
   SDPA, and PyTorch's ``scaled_dot_product_attention`` timed beside it as its
   yardstick (never on the port's path); and ``ssd_chunk`` at
   mamba2-130m's heads (M=24, P=64, N=128) in chunks of 16 (the reduced
   configs' chunk: the CUDA-core kernel) at K=8, and of 128 (the
   tensor-core kernel) at K=32 and at the prefill's K=256, and at
   jamba-1.5-large's prefill heads (M=128, K=256, L=N=P=128: the
   CUDA-core kernel, the head width staged 64 columns at a time), within
   its stated tolerance, with its TFLOP/s, share of the bound and the
   float32-pipe figure beside the bound; two launches bit-identical.
   Then the golden small scenarios of both network modes, whose integer
   counters and response digests are pinned, and their chaos combos
   (``faults="chaos"``, in a child process on numpy's own code paths,
   as ``MATRIX_GOLDEN`` was pinned), held to its pinned fields, the chaos
   conservation law, one launch of each kernel a tick and, every leaf
   and trace, the same run on the CPU;
3. Table 2 case1b at full size, run twice through ``Simulation.run``,
   which captures the tick as a CUDA graph at the first run and replays
   it once per tick (conservation laws, 10^6 requests admitted, one
   ``cloudlet_finish`` launch per tick, the two final states
   bit-identical and every leaf equal to the JAX reference's pin,
   ``CAPACITY_PINS``; the capture time, zero at the second run; the peak
   device memory), with per-phase CUDA-event times over the 100 ticks of
   an eager run (probes keep the tick eager), a 100-tick replayed run
   that must equal that eager run in every leaf and trace, the
   synchronising calls per replayed tick, the device busy share and
   device operations per tick over 20 replayed ticks, and the tick's
   operations by call site (counted on the CPU at a small size);
4. Table 2 case1b+net (the network fabric on 10,000 Mbit/s NICs) at full
   size, once, with the same checks and one ``link_share`` launch per
   tick; its per-phase times name the Transit phase;
5. Table 2 case2b at full size, once, with the same checks; then the
   chaos cases case1b+faults, case1b+chaos2 and case1b+net+chaos2 (the
   Disruption phase on; the last two with every gray-failure stream over
   4 zones), once each, with the same checks (their final states against
   ``CAPACITY_PINS``, the chaos conservation law with the fault counters
   printed, per-phase times that name Disruption), and their replayed
   ms per tick, device operations a tick and busy share beside case1b's;
6. SockShop (paper §6.3), three runs one after another: 100 clients
   (HS) and 300 clients (NS) over 600 s, average response against the
   testbed, and 300 clients with HS over 180 s, which must scale out;
   each run's response digest and integer counters must equal the JAX
   reference's (``SOCKSHOP_PINS``); each run replays its tick graphs
   (two: the scaling tick apart) in 10 s windows, with the host's key
   schedule for the whole run timed, its peak memory, and the busy share
   and device operations per tick over 20 replayed ticks, launches
   ``cloudlet_finish`` once per tick and is followed by Alg 2 over its
   per-window node delays through one ``tropical_closure`` launch (and no
   ``tropical_matmul``), held against the DP critical path; the
   synchronising calls per tick over a window that holds a scaling tick;
   Then ``benchmarks/bench_scaling.py``'s ``sweep8_demo`` at full width:
   SockShop with HS and the Fig 11 knobs, 8 loads from 200 to 1100
   clients over 600 s as one ``Simulation.run_batch`` (one replayed
   batched tick a tick), timed beside a solo replayed run at the largest
   load (``batch_over_solo``, ``batch_over_sequential``): one
   ``cloudlet_finish`` launch a tick, each point's response digest and
   counters equal to the JAX reference's ``run_batch`` (``SWEEP_PINS``),
   points 0 and 7 equal to their solo runs, the device operations a
   batched tick below twice the solo tick's, 0 synchronising calls a
   replayed batched tick over a scaling tick, and 100 replayed batched
   ticks equal to the eager ones (with their per-phase times);
   then ``examples/chaos_study.py``'s sweep (``CHAOS_STUDY``: SockShop
   with 2 replicas spread, zone fail-slow chaos, 100 clients over 120 s,
   blast radii 1, 2 and 5 x outlier ejection off and on) as one
   ``run_batch(apps=)``: one ``cloudlet_finish`` launch a batched tick,
   each point's response digest, counters and ``FaultStats`` equal to the
   JAX reference's (``CHAOS_PINS``), 0 synchronising calls a replayed
   batched tick, and the study's table;
7. observability (``repro_torch.obs``): case1b+obs (streamed telemetry:
   metric rows in 16-tick windows, 1 request in 100 traced) and
   case1b+slo (burn-rate alerting too) at full size, twice each, with
   case1b's checks: every simulation leaf equal to case1b's pin, the
   telemetry and alert leaves and a digest of the streamed metric and
   alert rows equal to the JAX reference's (``CAPACITY_PINS``,
   ``ROW_PINS``), per-phase times that name Telemetry and Alerting, 0
   synchronising calls over ten replayed ticks that hold a flush of the
   metric ring, and their replay figures beside case1b's; case1b+slo's
   ``phase_breakdown`` as a table; SockShop, 100 clients with HS over
   600 s with ``examples/telemetry_study.py``'s telemetry: its pins
   unchanged, and ``verify_traces`` on the card equal to the reference's
   (``TRACE_PINS``), every eligible trace exact, each graph-level Alg 2
   one ``tropical_closure`` launch; and ``examples/slo_study.py`` at its
   defaults, both arms as one ``run_batch``, each arm's counters, alert
   counters and alert rows equal to the reference's (``SLO_PINS``), the
   burn arm's violation rate below the util arm's, 0 synchronising calls
   a replayed batched tick over a flush and a scaling tick;
8. SockShop on the network fabric (8 Mbit/s NICs, spread placement,
   ``examples/network_saturation.py``'s sweep) at 10, 50 and 100 clients
   over 120 s, one after another: one ``link_share`` and one
   ``cloudlet_finish`` launch per tick, the same replay figures, and the
   transit p95 rising with the load; then the example's own batched
   sweep (10, 25, 50 and 100 clients as one ``run_batch``): one launch of
   each kernel a tick, the points at 10, 50 and 100 clients equal to the
   solo runs in every leaf and trace, the transit p95 rising;
9. Alg 2 at fleet scale: ``response_times_batched`` over a seeded
   1024-service DAG (each service calls up to 4 higher-numbered ones, 4
   APIs) in 8 windows, through ⌈log₂ depth⌉ ``tropical_matmul`` launches,
   every (window, API) held against the DP critical path;
10. simcheck on the card (``repro_torch.analysis``): the op lint, the layout
   check, the stream audit and the capture sentinel of ``python -m
   repro_torch.analysis`` (every section clean, every stream digest
   printed, the sentinel's counting pass with 0 captures and 0 kernel
   builds); the lint and the layout replay at full size on one eager tick
   of case1b and of case1b+net+chaos2, with the tick's operations by call
   site counted on the card; case1b under ``REPRO_CHECKED=1``, every leaf
   equal to its pin, 0 synchronising calls per replayed checked tick (the
   error word read once after the loop), its ms per tick beside the
   unchecked run's; and SockShop 100 clients HS over 600 s on two fresh
   ``Simulation``s, the second replaying the first's capture (capture
   time 0.000 s), both equal to ``SOCKSHOP_PINS``.  The
   ``shardability`` section's report on the card must equal the CPU's,
   every op and site included (``check_shardability``).  Each cell starts
   with the capture cache cleared (``Simulation.clear_captures``), so its
   peak memory is its own;
11. the model zoo's prefill program (``serve.prefill_step``) of
   qwen3-0.6b, mamba2-130m, qwen3-moe-30b-a3b, qwen2-moe-a2.7b,
   whisper-base (the encoder over 1,500 seeded frames, then the decoder)
   and qwen2-vl-7b (seeded embeddings, M-RoPE positions of a prompt that
   holds a 64 x 64 image) at full width and depth (the MoE pair at 12 of
   48 and 6 of 24 layers, qwen2-vl-7b at 14 of 28: ``SERVE_DEPTH``), and
   of one period of jamba-1.5-large at full width (8 of its 72 layers, 4
   of its 16 experts, top-2 kept: ``jamba_period``), on seeded random
   weights, one
   model's weights on the card at a time, at ``prefill_32k``'s T =
   32,768 with the batch cut from 32 to 1: finite last-position logits,
   the mixer kernels' launches (one a layer: 28, 24, 12, 6 and 14;
   whisper 18, six each for the encoder, the decoder's self-attention and
   its cross-attention; ``ssd_chunk`` for mamba2, ``flash_attention``
   for the others; the jamba period 1 ``flash_attention`` and 7
   ``ssd_chunk``), ``flash_fwd_sm90`` and ``ssd_chunk_sm90`` (jamba's
   head width 128 too) in the device traces, the device busy share
   (device time over the unprofiled prefill's wall), the peak memory;
   and a 2-layer full-width model of each served arch (whisper with 2
   encoder layers), of granite-20b (MQA: 48 query heads on one KV head),
   of phi3-medium-14b at ``attn_impl="flat"`` (K/V repeated to its 40
   heads) and of jamba-1.5-large (period 2: attention, then a Mamba
   layer with the MoE FFN of 2 experts; T = 256, two chunks, so the carry
   crosses one), its weights drawn on the card and copied to the CPU,
   whose card logits are held against its CPU logits, with the share of
   the MoE routing choices the two make alike, and the flat model's
   logits bit-equal to its ``"grouped"`` logits on the card;
   flash is first held against its plain version at qwen2-vl's heads
   (group 7) and at whisper's (D = 64: the encoder, non-causal over
   1,500 frames; the decoder's causal self-attention; the cross-
   attention, 32,768 queries on 1,500 keys);
12. ``serve.main`` for the six models and the jamba period with its
   defaults (8 requests, 4 slots, 16 + 24 tokens; whisper against the
   zero cross K/V its decode state starts from, as the reference's
   server), and for qwen3-0.6b with the int8 KV cache (a variant of its
   config), which replays
   ``serve.DecodeGraph`` once per token step, its tok/s, capture time
   and peak memory; the graph's logits bit-equal to the eager
   ``decode_step``'s over 8 steps, the device time, busy share,
   operations and top kernels per replayed step, and the synchronising
   calls per replayed step; the int8 cache's next-token probabilities
   within 1e-2 of the bf16 cache's over 8 steps
   (``tests/test_quant_kv.py``'s rule);
13. training (the dense and ssm families, ``repro_torch.train``): the
   training
   forward (``launch(..., with_lse=True)``) at qwen3-0.6b's training
   heads, timed beside its bound and SDPA; the flash backward kernels
   (``csrc/flash_attention_bwd.cu``, the pair ``ops.route_bwd`` names on
   each line; their ``ptxas`` report, which must hold the four kernels
   and no spill, and SASS in phase 1) against autograd through the plain
   version (``ref.attention_bwd``, ``BWD_TOL``) and the forward's
   log-sum-exp output against the plain one: on the tensor-core kernels
   at qwen3-0.6b's training heads (B 2, Hq 16, Hkv 8, T 4096, D 128,
   bf16) and whisper-base's cross-attention (non-causal, Tq 4096 over Tk
   1500, D 64), both timed beside the bound, the plain version and the
   SDPA backward, the presets' D 64, a ragged T, a non-causal Tq < Tk, a
   group of 7 and granite-20b's MQA (48/1, T 4096); on the CUDA-core
   kernels float32 and bf16 at D 32 (timed); two launches bit-identical;
   ``launch.train.main`` for qwen3-0.6b at full
   width and depth, T 4096 (``train_4k``), B 2 (cut from 256), remat on,
   ``TRAIN_STEPS`` steps twice from one seed: finite losses and norms,
   per step 2 x 28 ``flash_attention`` and 28 x 2 ``flash_attention_bwd``
   launches, the two runs bit-equal in every parameter and moment, the
   step wall, tok/s and peak memory, then one profiled step: busy share,
   device time by kernel and the flash backward's share, the trace
   naming ``flash_bwd_dq_sm90`` and ``flash_bwd_dkdv_sm90``; a 2-layer
   full-width qwen3-0.6b's train-step gradients on the card against the
   CPU (the ``SyntheticLM`` batch bit-equal, the loss, norm and every
   leaf within ``TRAIN_*_TOL``); the SSD backward kernels
   (``csrc/ssd_chunk_bwd.cu``, no atomics; ``ops.route_bwd``: the
   tensor-core ``ssd_bwd_ds``, ``ssd_bwd_dx``, ``ssd_bwd_db`` at the
   forward's tensor-core shapes, the CUDA-core ``ssd_bwd_heads`` then
   ``ssd_bwd_groups`` below them) against autograd through the plain
   version (``ref.ssd_chunk_bwd``, each output within ``SSD_BWD_TOL`` of
   its own max |value|), two launches bit-identical, with the route and
   the heads a block: at mamba2-130m's training shape (B 8, T 4096: M
   192, K 32, L = N = 128, P 64, 24 heads a B/C row) and at
   jamba-1.5-large's (B 1, T 4096: M 128, K 32, L = N = P = 128, one row
   of 128 heads, four slices), both timed beside the bound and the plain
   version, at several slices of a row's heads, at four B/C rows of 4
   heads and at L = N = P = 16; ``launch.train.main`` for mamba2-130m at
   full width and depth, T 4096, B 8 (cut from 256), as for qwen3-0.6b:
   per step 2 x 24 ``ssd_chunk`` and 24 x 3 ``ssd_chunk_bwd`` launches,
   two runs bit-equal, the trace naming ``ssd_bwd_ds``, ``ssd_bwd_dx``
   and ``ssd_bwd_db``; a 2-layer full-width
   mamba2-130m's train step on the card against the CPU; the ``tiny``
   preset's loss drop over 100 steps and a checkpoint resume bit-equal
   to a straight run; then the moe, vlm, encdec and hybrid families: a
   2-layer full-width train step of whisper-base (2 encoder layers),
   qwen2-vl-7b, qwen2-moe-a2.7b, qwen3-moe-30b-a3b and the jamba period
   (attention + SwiGLU, Mamba + MoE with 2 experts, T 256) on the card
   against the CPU (``TRAIN_TWO_LAYER``; the MoE gradients with the CPU's
   expert choices given to the card, the card's own routing for the
   loss, the norm and the share of choices alike), and each family at
   full width, T 4096 (``TRAIN_FAMILIES``: whisper-base at full depth, B
   8, on ``batch_for``'s bf16 frames; qwen2-vl-7b at 8 of 28 layers on
   its bf16 embeds and M-RoPE positions; qwen2-moe-a2.7b at 4 of 24
   layers and the jamba period with 3 of 16 experts through
   ``launch.train.main``), each as qwen3-0.6b's run: the launches a step
   ``train_kernels`` predicts, two runs bit-equal (through
   ``train_digest`` where the state does not fit twice), step wall,
   tok/s, peak memory, a profiled step (and whisper's cross-attention
   backward in it).  The CPU halves of every 2-layer check run in a
   child process (``CPU_SIDE_FLAG``) beside phases 2-10;
14. the distribution layer ("dist"): qwen3-0.6b's full-width train
   state saved with ``CheckpointManager``, loaded on the host, placed by
   ``ckpt.elastic.reshard_tree`` on a (1, 1) ("data", "model") mesh and
   rescaled by ``simulate_failure_and_rescale`` onto (1, 1, 1) ("pod",
   "data", "model") over a world-size-1 NCCL group (``FileStore``, no
   network): every leaf bit-equal, placed as the resolver says, one
   ``train_4k`` step from the rescaled local tensors bit-equal to the step
   from the state never resharded; the GB moved and each stage's wall;
15. the dry run (``launch.dryrun``), computed by a child process
   (``DRYRUN_FLAG``) started with the builds, beside phases 2-10 (no card
   work: fake shards over a fake process group of 256 or 512 ranks):
   qwen3-0.6b's train_4k, prefill_32k and decode_32k cells on 16×16 and
   its train_4k on 2×16×16 must be ``ok``, their argument bytes equal to
   the resolver's (``resolver_bytes``), the 2×16×16 batch split 32 ways
   and the extrapolated FLOPs equal to the direct count; each cell's
   roofline row under the H100 constants; mamba2-130m's train_4k on
   2×16×16 (24 heads the "model" axis does not divide) gated as those;
   the cells that stopped at an op eager DTensor had no rule for,
   repaired (``DRYRUN_REPAIRED``, reduced configs on a fake world of 8,
   mesh (2, 4)): the reduced qwen3-moe-30b-a3b prefill (the expert
   counts' scatter-add) and qwen2-moe-a2.7b train step (the combine's
   backward, an ``index_add``), mamba2-130m's and jamba's prefill (the Mamba
   conv's ``constant_pad_nd`` on torch 2.11), flat phi3-medium-14b's
   prefill (the attention's product over sharded batch and heads), each
   ``ok``; jamba-1.5-large's train_4k at full depth recorded (its state
   per device), not gated;
16. one JSON line with each kernel's launches, times and bound; then the
   card's ``nvidia-smi`` name and power limit; then the result line.

Phase 9 ends with ``examples/torch_llm_serving_sim.py`` on the card
(``run_twin``): both arms at ``TWIN_CLIENTS`` clients over
``TWIN_DURATION`` s, one ``cloudlet_finish`` launch a tick (counted on the
kernels line), requests completed, the HS arm scaling out; then the nine
other twins of ``examples/`` (``run_twins``), each once at its smallest
setting (``TWINS``), each passing its verdict (its ``main`` returns 0),
their kernel launches counted on the kernels line.

Kernel launches are counted by the wrappers; the counts are zeroed just
before each main-path run and read just after.  Launches made to compare
or time a kernel are not counted in the reported launches.
"""
from __future__ import annotations

import os
import sys

# numpy on its baseline code paths, before anything imports it.  The Table
# 2 cases place instances on VMs of equal free capacity, and the
# reference's placement (like the port's) orders them by numpy's default
# argsort, whose order among ties depends on the SIMD sort numpy dispatches
# to and on its version (case2b's 781 tied VMs: three orders on one host);
# the baseline quicksort gives one order on every host.  The pins
# (``tools/chip_smoke_pins.py``) are taken with the same setting.  The one
# exception is the golden scenario's chaos phase, which this script runs
# in a child process (``GOLDEN_CHAOS_FLAG``) on numpy's own code paths:
# ``MATRIX_GOLDEN``'s chaos pins were taken with numpy's SIMD sort, whose
# order among the golden scenario's 4 tied VMs is not the baseline's.
NUMPY_BASELINE = ("AVX2 FMA3 AVX512F AVX512CD AVX512_SKX AVX512_CLX "
                  "AVX512_CNL AVX512_ICL AVX512_SPR")
GOLDEN_CHAOS_FLAG = "--golden-chaos"
CPU_SIDE_FLAG = "--cpu-side"
DRYRUN_FLAG = "--dryrun"
if GOLDEN_CHAOS_FLAG not in sys.argv:
    os.environ["NPY_DISABLE_CPU_FEATURES"] = NUMPY_BASELINE

import dataclasses  # noqa: E402
import json
import math
import re
import shutil
import subprocess
import time
import traceback
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
SM_COUNT = 132                 # H100 SXM
FP32_LANES = 128               # float32 lanes issued per SM and clock
SM_CLOCK_HZ = 1.98e9           # H100 SXM maximum SM clock
SOCKSHOP_DEPTH = 4             # SockShop's service graph: 2 squarings
FLASH_RTOL = 2.0 ** -7         # bf16 output: one bf16 rounding of |plain|
FLASH_ATOL = 1e-4              # ... plus the float32 sums' own error
FLASH_PLAIN_ROWS = 1024        # query rows per block of the plain version
SSD_TOL = 2e-5                 # float32, sums in another order
# the SSD backward against autograd through the plain version: each output
# within SSD_BWD_TOL of its own max |value| (float32, the sums in another
# order, the group's heads summed in ascending order)
SSD_BWD_TOL = 1e-4
JAMBA = "jamba-1.5-large-398b"
JAMBA_EXPERTS = 4              # of 16 (8 once; cut for the run's time)
MODEL_TOL = 5e-2               # 2-layer bf16 logits, card against CPU
SERVE_ARCHS = ("qwen3-0.6b", "mamba2-130m", "qwen3-moe-30b-a3b",
               "qwen2-moe-a2.7b", "whisper-base", "qwen2-vl-7b")
# the served archs prefilled and served cut in depth (layers), at full
# width: the MoE pair, the longest of the model zoo's prefill and serve
# paths (their host work a decode step, eager, profiled and linted, grows
# with the layers), cut to half depth when the whole run had reached
# 1,014.6 of its 1,200 s, then to a quarter and qwen2-vl-7b to half when
# phase 13 took on the moe, vlm, encdec and hybrid families' training
SERVE_DEPTH = {"qwen3-moe-30b-a3b": 12, "qwen2-moe-a2.7b": 6,
               "qwen2-vl-7b": 14}
# served with the int8 KV cache (a variant of the arch's config)
INT8_SERVE_ARCHS = ("qwen3-0.6b",)
# 2-layer full-width card-against-CPU checks (arch, other config fields):
# the served archs (whisper with 2 encoder layers over its 1,500 frames),
# granite-20b's MQA (48 query heads on one KV head in flash_fwd_sm90) and
# phi3-medium-14b's flat formulation (K/V repeated to its 40 heads)
# and jamba: attention, then a Mamba layer with the MoE FFN (2 of its
# experts); T = 256 spans two chunks, so the carry crosses one
TWO_LAYER_CASES = tuple((a, dict(n_enc_layers=2) if a == "whisper-base"
                         else {}) for a in SERVE_ARCHS) + (
    ("granite-20b", {}), ("phi3-medium-14b", dict(attn_impl="flat")),
    (JAMBA, dict(T=256, attn_period=2, n_experts=2)))
GOLDEN = dict(completed=157, spawned=794, finished=789,
              resp_digest=1306795296637)
GOLDEN_FABRIC = dict(completed=163, spawned=830, finished=822,
                     resp_digest=1292572014442, transits=606)
# The JAX reference's results at this script's full-size configurations,
# on the CPU (``tools/chip_smoke_pins.py`` prints them): every leaf of the
# Table 2 final states (``leaf_digests``), and each SockShop run's response
# digest and integer counters (``sockshop_summary``), keyed by clients/
# seconds/policy.
PIN_LEAVES = (
    "alerts.astate", "alerts.ev_drops", "alerts.ev_n", "alerts.ev_rule",
    "alerts.ev_service", "alerts.ev_state", "alerts.ev_time",
    "alerts.fires", "alerts.firing_ticks", "alerts.hold_until",
    "alerts.pending", "alerts.resolves", "alerts.sli_acc", "alerts.sli_win",
    "alerts.win", "clients.wait", "cloudlets.flts", "cloudlets.ints",
    "counters.completed", "counters.dropped_cloudlets",
    "counters.dropped_requests", "counters.finished", "counters.migrations",
    "counters.resp_sum", "counters.scale_down", "counters.scale_in",
    "counters.scale_out", "counters.scale_up", "counters.slo_violations",
    "counters.spawned", "fault.edge_err_ema", "fault.edge_open_until",
    "fault.edge_succ", "fault.host_slow", "fault.host_up",
    "fault.inst_eject_until", "fault.inst_err_ema", "fault.inst_lat_ema",
    "fault.inst_lat_sum", "fault.inst_succ", "fault.nic_factor",
    "fault.nic_ok", "fault.zone_cut", "fstats.breaker_trips",
    "fstats.down_time_s", "fstats.ejections", "fstats.failed_attempts",
    "fstats.failed_requests", "fstats.failfast", "fstats.host_crashes",
    "fstats.host_recoveries", "fstats.inst_kills", "fstats.partitions",
    "fstats.readmissions", "fstats.retries", "fstats.slow_episodes",
    "fstats.slow_time_s", "fstats.zone_faults", "hosts.cpu_scale",
    "hosts.egress_scale", "hosts.ingress_scale", "instances.busy_ticks",
    "instances.bw", "instances.host", "instances.limit_mips",
    "instances.limit_ram", "instances.mips", "instances.n_exec",
    "instances.ram", "instances.request_mips", "instances.service",
    "instances.status", "instances.usage_sum", "instances.used_bw",
    "instances.used_mips", "instances.used_ram", "instances.util_ema",
    "instances.vm", "net.bytes_in", "net.bytes_out", "net.egress_busy",
    "net.hist", "net.ingress_busy", "net.transit_sum", "net.transits",
    "requests.api", "requests.arrival", "requests.count",
    "requests.critical_len", "requests.failed", "requests.finish",
    "requests.outstanding", "requests.response", "requests.spawned", "rng",
    "rr", "sched.inst_of_rank", "sched.svc_replicas", "svc_stats.delay_sum",
    "svc_stats.exec_sum", "svc_stats.finished", "svc_stats.usage_sum",
    "svc_stats.wait_sum", "telemetry.acc", "telemetry.ring",
    "telemetry.sample", "telemetry.span_drops", "telemetry.span_f",
    "telemetry.span_i", "telemetry.span_n", "telemetry.win", "tick", "time",
    "vms.mips", "vms.mips_used", "vms.ram", "vms.ram_used",)
CAPACITY_PINS = {
    "case1b": (
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "4f7988030a00 990ffda621f2 ab45da00286d cee19cda5a70 df3f619804a9 "
        "df3f619804a9 cee19cda5a70 df3f619804a9 dd40a7748e48 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 cee19cda5a70 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc a3e902d34859 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc a3e902d34859 e3b0c44298fc df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 08149ef58087 08149ef58087 "
        "08149ef58087 d6e3119544f0 8c8ef95dda66 53267cbb8711 90a5e16ab5fe "
        "15ba73223892 e271f40b1207 fc19b1997119 9e504c05d5c0 e271f40b1207 "
        "fc19b1997119 ef2d9ea73cb0 0a0bff3f3525 fc19b1997119 fc19b1997119 "
        "fc19b1997119 aea32e5e36ba 53267cbb8711 5dcc1b5872dd 5dcc1b5872dd "
        "5dcc1b5872dd 5341e6b26469 5dcc1b5872dd df3f619804a9 df3f619804a9 "
        "28303a108841 7a47de4cc34f cee19cda5a70 9e94cbbf1036 e3b0c44298fc "
        "f6d5b935a899 560db0b0dacf 2a671ff829f2 9e94cbbf1036 8c988d7c3481 "
        "df3f619804a9 550625f47dc1 79ff7fbc96a0 dd40a7748e48 dd40a7748e48 "
        "cee19cda5a70 d7971c8f6c95 df3f619804a9 e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc 9a0f8ec2df5d 1bfec212884f 3c3c8de91b0e 4e59112073c6 "
        "fba7e9d699f0 3c7aedfc7500"),
    "case1b+net": (
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "4f7988030a00 cf615e67d083 67dddaf9e18e cee19cda5a70 df3f619804a9 "
        "df3f619804a9 cee19cda5a70 df3f619804a9 0084088dbb16 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 cee19cda5a70 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc a3e902d34859 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc a3e902d34859 e3b0c44298fc df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 08149ef58087 08149ef58087 "
        "08149ef58087 d6e3119544f0 8c8ef95dda66 53267cbb8711 90a5e16ab5fe "
        "15ba73223892 e271f40b1207 fc19b1997119 9e504c05d5c0 e271f40b1207 "
        "fc19b1997119 ef2d9ea73cb0 5ec51e99902c fc19b1997119 fc19b1997119 "
        "fc19b1997119 c8c253811ebb 53267cbb8711 4016ab693632 5dcc1b5872dd "
        "5dcc1b5872dd eca41531b26c 70a71bb57120 11592b124773 cee19cda5a70 "
        "28303a108841 f8e092186c81 cee19cda5a70 9e94cbbf1036 e3b0c44298fc "
        "4885bebab95b 560db0b0dacf 0f29f9eb72f9 9e94cbbf1036 75782de5e267 "
        "df3f619804a9 550625f47dc1 79ff7fbc96a0 ffb41dac2857 ffb41dac2857 "
        "cee19cda5a70 2ee8846ff4b9 df3f619804a9 e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc 9a0f8ec2df5d 1bfec212884f 3c3c8de91b0e 4e59112073c6 "
        "fba7e9d699f0 3c7aedfc7500"),
    "case2b": (
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "5341e6b26469 6b9aafdfa476 d4e96950ee82 79ff7fbc96a0 df3f619804a9 "
        "df3f619804a9 63bf4fc52738 df3f619804a9 895abba97fcf df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 63bf4fc52738 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc b192a9874ac4 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc b192a9874ac4 e3b0c44298fc df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 ab5cfde9bc1a ab5cfde9bc1a "
        "ab5cfde9bc1a 9b3ad50ee6bb 0a138936b85b 320800c47922 bdc36ecb22f6 "
        "8963bac332fd 446f06b3a5d5 4cbbd9be0cba 7cb5e31f1e96 446f06b3a5d5 "
        "7c843739479f c71f32cf6ff6 3bbb692b9605 4cbbd9be0cba 4cbbd9be0cba "
        "4cbbd9be0cba 6f9145ba7386 320800c47922 6e53624cb481 6e53624cb481 "
        "6e53624cb481 5341e6b26469 6e53624cb481 df3f619804a9 df3f619804a9 "
        "ab2ed4c7a6dc 4a8be206d6b8 79ff7fbc96a0 fef789449a3c e3b0c44298fc "
        "fcabcb5ccb3c 1e86afc67a97 1b2120bb506d bbc6ce5bca12 8c988d7c3481 "
        "4cbbd9be0cba 7c843739479f c71f32cf6ff6 41f1c9cb0c15 41f1c9cb0c15 "
        "7b73c94b48af 3bbb692b9605 4cbbd9be0cba e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc 9a0f8ec2df5d 1bfec212884f 933dccc013e6 f48fa41d00cd "
        "368e9aabca1a 01a9ff9ad4a6"),
    "case1b+chaos2": (
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "4f7988030a00 d0889dd7dea0 9a181641cc03 cee19cda5a70 df3f619804a9 "
        "df3f619804a9 cee19cda5a70 df3f619804a9 7167e520a3eb df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 19e7f4494456 cee19cda5a70 "
        "af5570f5a181 af5570f5a181 af5570f5a181 4fd1d2ff6c51 a3e902d34859 "
        "fc19b1997119 fc19b1997119 17ebf9fbb644 fc19b1997119 fc19b1997119 "
        "08149ef58087 a3e902d34859 fa807c957eaf df3f619804a9 4f4b9b7d8b86 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 9d9f290527a6 "
        "9d9f290527a6 df3f619804a9 9d9f290527a6 df3f619804a9 df3f619804a9 "
        "32434dc5b0f7 fa72dd1e82ac e8613f5a5bc9 08149ef58087 08149ef58087 "
        "08149ef58087 afea72635a16 8c8ef95dda66 53267cbb8711 90a5e16ab5fe "
        "15ba73223892 e271f40b1207 fc19b1997119 9e504c05d5c0 e271f40b1207 "
        "fc19b1997119 e1dd2d624177 9d1679c5aa9b fc19b1997119 fc19b1997119 "
        "fc19b1997119 93ccf2ea3c2b 53267cbb8711 5dcc1b5872dd 5dcc1b5872dd "
        "5dcc1b5872dd 5341e6b26469 5dcc1b5872dd df3f619804a9 df3f619804a9 "
        "28303a108841 07622e6f2e11 cee19cda5a70 9e94cbbf1036 2d8ab68b400e "
        "2df77297ded1 560db0b0dacf c6826e44264a 9e94cbbf1036 1cb86bba75ce "
        "df3f619804a9 550625f47dc1 79ff7fbc96a0 c9929f20b694 344c2e8430e4 "
        "cee19cda5a70 a5979970b15e f11771e2174f e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc 9a0f8ec2df5d 1bfec212884f 3c3c8de91b0e 4e59112073c6 "
        "fba7e9d699f0 3c7aedfc7500"),
    "case1b+faults": (
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "4f7988030a00 73616bd060ef 14c96f150671 cee19cda5a70 df3f619804a9 "
        "df3f619804a9 cee19cda5a70 df3f619804a9 162d5c594873 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 e4f0233cbbfe cee19cda5a70 "
        "af5570f5a181 af5570f5a181 af5570f5a181 5dcc1b5872dd a3e902d34859 "
        "fc19b1997119 fc19b1997119 964c4a8aa000 fc19b1997119 fc19b1997119 "
        "08149ef58087 a3e902d34859 fa807c957eaf df3f619804a9 4f4b9b7d8b86 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 9d9f290527a6 "
        "9d9f290527a6 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 08149ef58087 08149ef58087 "
        "08149ef58087 f5eb42464752 8c8ef95dda66 53267cbb8711 90a5e16ab5fe "
        "15ba73223892 e271f40b1207 fc19b1997119 9e504c05d5c0 e271f40b1207 "
        "fc19b1997119 e1dd2d624177 ee2d850f18bd fc19b1997119 fc19b1997119 "
        "fc19b1997119 e650a46f1b8e 53267cbb8711 5dcc1b5872dd 5dcc1b5872dd "
        "5dcc1b5872dd 5341e6b26469 5dcc1b5872dd df3f619804a9 df3f619804a9 "
        "28303a108841 07622e6f2e11 cee19cda5a70 9e94cbbf1036 2d8ab68b400e "
        "66c0551e5ded 560db0b0dacf 006d81cb8d29 9e94cbbf1036 1cb86bba75ce "
        "df3f619804a9 550625f47dc1 79ff7fbc96a0 4a34fa9b691d 9fac8ea207d2 "
        "cee19cda5a70 c52d2bba2aa2 17f08f4dfd0c e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc 9a0f8ec2df5d 1bfec212884f 3c3c8de91b0e 4e59112073c6 "
        "fba7e9d699f0 3c7aedfc7500"),
    "case1b+net+chaos2": (
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "4f7988030a00 cab3f62226dd 6516d6233610 cee19cda5a70 df3f619804a9 "
        "df3f619804a9 cee19cda5a70 df3f619804a9 43f97f9b7e06 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 eed72f47b9a4 6e8a30b4a05a "
        "f50dbbf0c280 af5570f5a181 af5570f5a181 5dcc1b5872dd a3e902d34859 "
        "fc19b1997119 fc19b1997119 70448138cea8 fc19b1997119 fc19b1997119 "
        "08149ef58087 a3e902d34859 fa807c957eaf df3f619804a9 41d043a7c0f0 "
        "df3f619804a9 af220e86f3b7 df3f619804a9 df3f619804a9 2594b6a92ebf "
        "2594b6a92ebf df3f619804a9 2594b6a92ebf df3f619804a9 af220e86f3b7 "
        "b01099398ce2 044ff6211dc3 fb5e512425fc 08149ef58087 08149ef58087 "
        "08149ef58087 4369f2ba7d8c 8c8ef95dda66 53267cbb8711 90a5e16ab5fe "
        "15ba73223892 e271f40b1207 fc19b1997119 9e504c05d5c0 e271f40b1207 "
        "fc19b1997119 ef2d9ea73cb0 b5a47706d0ae fc19b1997119 fc19b1997119 "
        "fc19b1997119 2c8e8457dad1 53267cbb8711 1f166fb1a8aa 5dcc1b5872dd "
        "5dcc1b5872dd b59836de47ad e9c8140102cf bca472964bfb 635235589bf9 "
        "28303a108841 ca062df3604b cee19cda5a70 9e94cbbf1036 2d8ab68b400e "
        "5cd21fdf25d4 560db0b0dacf 5c2b745b7973 9927159bee41 24d42edb34cf "
        "af220e86f3b7 550625f47dc1 79ff7fbc96a0 43f97f9b7e06 7c6c88cf9c5a "
        "cee19cda5a70 48930ae6e734 a33eadf8ad0f e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc 9a0f8ec2df5d 1bfec212884f 3c3c8de91b0e 4e59112073c6 "
        "fba7e9d699f0 3c7aedfc7500"),
    "case1b+obs": (
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "4f7988030a00 990ffda621f2 ab45da00286d cee19cda5a70 df3f619804a9 "
        "df3f619804a9 cee19cda5a70 df3f619804a9 dd40a7748e48 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 cee19cda5a70 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc a3e902d34859 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc a3e902d34859 e3b0c44298fc df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 08149ef58087 08149ef58087 "
        "08149ef58087 d6e3119544f0 8c8ef95dda66 53267cbb8711 90a5e16ab5fe "
        "15ba73223892 e271f40b1207 fc19b1997119 9e504c05d5c0 e271f40b1207 "
        "fc19b1997119 ef2d9ea73cb0 0a0bff3f3525 fc19b1997119 fc19b1997119 "
        "fc19b1997119 aea32e5e36ba 53267cbb8711 5dcc1b5872dd 5dcc1b5872dd "
        "5dcc1b5872dd 5341e6b26469 5dcc1b5872dd df3f619804a9 df3f619804a9 "
        "28303a108841 7a47de4cc34f cee19cda5a70 9e94cbbf1036 e3b0c44298fc "
        "f6d5b935a899 560db0b0dacf 2a671ff829f2 9e94cbbf1036 8c988d7c3481 "
        "df3f619804a9 550625f47dc1 79ff7fbc96a0 dd40a7748e48 dd40a7748e48 "
        "cee19cda5a70 d7971c8f6c95 df3f619804a9 af5570f5a181 200342c9c368 "
        "3015b744160e 823b9c3162e7 8e9db6d6f46f dc12fce04fc6 2385b2772b66 "
        "e8a4b2ee7ede 9a0f8ec2df5d 1bfec212884f 3c3c8de91b0e 4e59112073c6 "
        "fba7e9d699f0 3c7aedfc7500"),
    "case1b+slo": (
        "af5570f5a181 df3f619804a9 df3f619804a9 5f70bf18a086 5f70bf18a086 "
        "5f70bf18a086 5f70bf18a086 af5570f5a181 af5570f5a181 df3f619804a9 "
        "af5570f5a181 af5570f5a181 af5570f5a181 66687aadf862 e8a4b2ee7ede "
        "4f7988030a00 990ffda621f2 ab45da00286d cee19cda5a70 df3f619804a9 "
        "df3f619804a9 cee19cda5a70 df3f619804a9 dd40a7748e48 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 cee19cda5a70 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc a3e902d34859 "
        "e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc e3b0c44298fc "
        "e3b0c44298fc a3e902d34859 e3b0c44298fc df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 df3f619804a9 "
        "df3f619804a9 df3f619804a9 df3f619804a9 08149ef58087 08149ef58087 "
        "08149ef58087 d6e3119544f0 8c8ef95dda66 53267cbb8711 90a5e16ab5fe "
        "15ba73223892 e271f40b1207 fc19b1997119 9e504c05d5c0 e271f40b1207 "
        "fc19b1997119 ef2d9ea73cb0 0a0bff3f3525 fc19b1997119 fc19b1997119 "
        "fc19b1997119 aea32e5e36ba 53267cbb8711 5dcc1b5872dd 5dcc1b5872dd "
        "5dcc1b5872dd 5341e6b26469 5dcc1b5872dd df3f619804a9 df3f619804a9 "
        "28303a108841 7a47de4cc34f cee19cda5a70 9e94cbbf1036 e3b0c44298fc "
        "f6d5b935a899 560db0b0dacf 2a671ff829f2 9e94cbbf1036 8c988d7c3481 "
        "df3f619804a9 550625f47dc1 79ff7fbc96a0 dd40a7748e48 dd40a7748e48 "
        "cee19cda5a70 d7971c8f6c95 df3f619804a9 af5570f5a181 200342c9c368 "
        "3015b744160e 823b9c3162e7 8e9db6d6f46f dc12fce04fc6 2385b2772b66 "
        "e8a4b2ee7ede 9a0f8ec2df5d 1bfec212884f 3c3c8de91b0e 4e59112073c6 "
        "fba7e9d699f0 3c7aedfc7500"),
}
SOCKSHOP_PINS = {
    "100/600/1": dict(
        completed=5825, dropped_cloudlets=0, dropped_requests=0,
        finished=25050, migrations=0, requests=5833,
        resp_digest=12384649975803, scale_down=0, scale_in=0, scale_out=0,
        scale_up=0, slo_violations=1070, spawned=25064),
    "300/180/1": dict(
        completed=5041, dropped_cloudlets=0, dropped_requests=0,
        finished=22141, migrations=0, requests=5059,
        resp_digest=11671955311784, scale_down=0, scale_in=5, scale_out=7,
        scale_up=0, slo_violations=1951, spawned=22181),
    "300/600/0": dict(
        completed=17387, dropped_cloudlets=0, dropped_requests=0,
        finished=74563, migrations=0, requests=17489,
        resp_digest=35894184715680, scale_down=0, scale_in=0, scale_out=0,
        scale_up=0, slo_violations=14536, spawned=74690),
}


# ``benchmarks/bench_scaling.py``'s ``sweep8_demo``: SockShop with HS and
# the Fig 11 knobs (a copy: this script imports no part of the JAX
# package; ``tools/chip_smoke_pins.py`` checks it against the benchmark's)
# over 600 s, 8 loads, ``spawn_rate = n / 30``.
FIG11_KNOBS = dict(
    share=4725.0, hs_util_hi=0.03, hs_util_lo=0.002,
    vs_util_hi=0.14, vs_util_lo=0.01, vs_up_factor=1.5, vs_down_factor=0.8,
    util_ema=0.1, idle_mips_frac=0.01, vs_overhead_frac=0.11,
)
SWEEP8_LOADS = (200, 328, 457, 585, 714, 842, 971, 1100)
# The JAX reference's ``run_batch`` of that sweep on the CPU
# (``tools/chip_smoke_pins.py``): each point's response digest and
# integer counters (``sockshop_summary``), in load order.
SWEEP_PINS = (
    dict(completed=11638, dropped_cloudlets=0, dropped_requests=0,
         finished=49569, migrations=0, requests=11651,
         resp_digest=240818220096163, scale_down=0, scale_in=3, scale_out=32,
         scale_up=0, slo_violations=846, spawned=49602),
    dict(completed=19205, dropped_cloudlets=0, dropped_requests=0,
         finished=82875, migrations=0, requests=19226,
         resp_digest=224524409847986, scale_down=0, scale_in=2, scale_out=32,
         scale_up=0, slo_violations=1462, spawned=82920),
    dict(completed=26727, dropped_cloudlets=0, dropped_requests=0,
         finished=115356, migrations=0, requests=26753,
         resp_digest=208327982299731, scale_down=0, scale_in=0, scale_out=36,
         scale_up=0, slo_violations=2132, spawned=115412),
    dict(completed=34144, dropped_cloudlets=0, dropped_requests=0,
         finished=147651, migrations=0, requests=34177,
         resp_digest=192358970736896, scale_down=0, scale_in=0, scale_out=37,
         scale_up=0, slo_violations=2759, spawned=147705),
    dict(completed=41768, dropped_cloudlets=0, dropped_requests=0,
         finished=179760, migrations=0, requests=41819,
         resp_digest=175943387592460, scale_down=0, scale_in=0, scale_out=39,
         scale_up=0, slo_violations=3254, spawned=179852),
    dict(completed=49121, dropped_cloudlets=0, dropped_requests=0,
         finished=210899, migrations=0, requests=49161,
         resp_digest=160112426462726, scale_down=0, scale_in=0, scale_out=39,
         scale_up=0, slo_violations=3931, spawned=210974),
    dict(completed=56642, dropped_cloudlets=0, dropped_requests=0,
         finished=244180, migrations=0, requests=56699,
         resp_digest=143921970845715, scale_down=0, scale_in=0, scale_out=39,
         scale_up=0, slo_violations=4697, spawned=244308),
    dict(completed=64263, dropped_cloudlets=0, dropped_requests=0,
         finished=276777, migrations=0, requests=64330,
         resp_digest=127515916884282, scale_down=0, scale_in=0, scale_out=39,
         scale_up=0, slo_violations=5241, spawned=276913),
)


# ``examples/chaos_study.py``'s sweep with the example's defaults (a copy;
# ``tools/chip_smoke_pins.py`` checks it against the example's): SockShop
# with 2 replicas per service spread over the 10 nodes, zone fail-slow
# chaos, 100 clients over 120 s; blast radii 1, 2 and 5 hosts a zone, each
# with outlier ejection off (threshold 2.0 > 1) and on (0.35), as one
# ``run_batch(apps=)`` whose points differ in ``host_zone``.
CHAOS_STUDY = dict(
    n_clients=100, duration_s=120.0, replicas=2, share=600.0,
    faults="chaos", host_mtbf_s=float("inf"), inst_kill_rate=0.0,
    retry_timeout_s=2.5, retry_budget=2, cb_err_thresh=0.5,
    cb_cooldown_s=5.0, cb_alpha=0.3, zone_slow_rate=0.02,
    host_slow_factor=0.1, host_slow_mttr_s=15.0, eject_cooldown_s=8.0)
CHAOS_RADII = (1, 2, 5)
CHAOS_EJECT = (2.0, 0.35)
CHAOS_HOSTS = 10
# The JAX reference's ``run_batch`` of that sweep on the CPU
# (``tools/chip_smoke_pins.py``): each point's ``chaos_summary``, radius
# by radius, ejection off then on.
CHAOS_PINS = (
    {"completed": 1089, "dropped_cloudlets": 0, "dropped_requests": 0,
     "finished": 3267, "fstats.breaker_trips": 33,
     "fstats.down_time_s": 0, "fstats.ejections": 0,
     "fstats.failed_attempts": 867, "fstats.failed_requests": 586,
     "fstats.failfast": 565, "fstats.host_crashes": 0,
     "fstats.host_recoveries": 0, "fstats.inst_kills": 0,
     "fstats.partitions": 0, "fstats.readmissions": 0,
     "fstats.retries": 111, "fstats.slow_episodes": 22,
     "fstats.slow_time_s": 1130083197, "fstats.zone_faults": 26,
     "migrations": 0, "requests": 1104, "resp_digest": 3182428345586,
     "scale_down": 0, "scale_in": 0, "scale_out": 0, "scale_up": 0,
     "slo_violations": 744, "spawned": 4153},
    {"completed": 1094, "dropped_cloudlets": 0, "dropped_requests": 0,
     "finished": 3383, "fstats.breaker_trips": 22,
     "fstats.down_time_s": 0, "fstats.ejections": 24,
     "fstats.failed_attempts": 831, "fstats.failed_requests": 550,
     "fstats.failfast": 509, "fstats.host_crashes": 0,
     "fstats.host_recoveries": 0, "fstats.inst_kills": 0,
     "fstats.partitions": 0, "fstats.readmissions": 22,
     "fstats.retries": 116, "fstats.slow_episodes": 22,
     "fstats.slow_time_s": 1130083197, "fstats.zone_faults": 26,
     "migrations": 0, "requests": 1104, "resp_digest": 3176017740126,
     "scale_down": 0, "scale_in": 0, "scale_out": 0, "scale_up": 0,
     "slo_violations": 747, "spawned": 4226},
    {"completed": 1081, "dropped_cloudlets": 0, "dropped_requests": 0,
     "finished": 2939, "fstats.breaker_trips": 36,
     "fstats.down_time_s": 0, "fstats.ejections": 0,
     "fstats.failed_attempts": 780, "fstats.failed_requests": 512,
     "fstats.failfast": 488, "fstats.host_crashes": 0,
     "fstats.host_recoveries": 0, "fstats.inst_kills": 0,
     "fstats.partitions": 0, "fstats.readmissions": 0,
     "fstats.retries": 127, "fstats.slow_episodes": 17,
     "fstats.slow_time_s": 1129558972, "fstats.zone_faults": 11,
     "migrations": 0, "requests": 1104, "resp_digest": 3185254167252,
     "scale_down": 0, "scale_in": 0, "scale_out": 0, "scale_up": 0,
     "slo_violations": 660, "spawned": 3750},
    {"completed": 1080, "dropped_cloudlets": 0, "dropped_requests": 0,
     "finished": 3127, "fstats.breaker_trips": 21,
     "fstats.down_time_s": 0, "fstats.ejections": 22,
     "fstats.failed_attempts": 635, "fstats.failed_requests": 426,
     "fstats.failfast": 416, "fstats.host_crashes": 0,
     "fstats.host_recoveries": 0, "fstats.inst_kills": 0,
     "fstats.partitions": 0, "fstats.readmissions": 21,
     "fstats.retries": 91, "fstats.slow_episodes": 17,
     "fstats.slow_time_s": 1129558972, "fstats.zone_faults": 11,
     "migrations": 0, "requests": 1104, "resp_digest": 3191991108030,
     "scale_down": 0, "scale_in": 0, "scale_out": 0, "scale_up": 0,
     "slo_violations": 602, "spawned": 3794},
    {"completed": 1070, "dropped_cloudlets": 0, "dropped_requests": 0,
     "finished": 3194, "fstats.breaker_trips": 27,
     "fstats.down_time_s": 0, "fstats.ejections": 0,
     "fstats.failed_attempts": 540, "fstats.failed_requests": 384,
     "fstats.failfast": 316, "fstats.host_crashes": 0,
     "fstats.host_recoveries": 0, "fstats.inst_kills": 0,
     "fstats.partitions": 0, "fstats.readmissions": 0,
     "fstats.retries": 104, "fstats.slow_episodes": 19,
     "fstats.slow_time_s": 1128621701, "fstats.zone_faults": 4,
     "migrations": 0, "requests": 1104, "resp_digest": 3192304955814,
     "scale_down": 0, "scale_in": 0, "scale_out": 0, "scale_up": 0,
     "slo_violations": 595, "spawned": 3777},
    {"completed": 1076, "dropped_cloudlets": 0, "dropped_requests": 0,
     "finished": 3784, "fstats.breaker_trips": 15,
     "fstats.down_time_s": 0, "fstats.ejections": 20,
     "fstats.failed_attempts": 401, "fstats.failed_requests": 277,
     "fstats.failfast": 241, "fstats.host_crashes": 0,
     "fstats.host_recoveries": 0, "fstats.inst_kills": 0,
     "fstats.partitions": 0, "fstats.readmissions": 17,
     "fstats.retries": 90, "fstats.slow_episodes": 19,
     "fstats.slow_time_s": 1128621701, "fstats.zone_faults": 4,
     "migrations": 0, "requests": 1104, "resp_digest": 3266596732370,
     "scale_down": 0, "scale_in": 0, "scale_out": 0, "scale_up": 0,
     "slo_violations": 562, "spawned": 4221},
)


# The observability cells: Table 2 case1b with streamed telemetry
# (``+obs``) and with burn-rate alerting too (``+slo``), as the
# reference's ``benchmarks/bench_capacity.py`` builds them.
OBS_CASES = ("case1b+obs", "case1b+slo")
# ``examples/telemetry_study.py``'s ``TEL_KW`` (a copy, checked by
# ``tools/chip_smoke_pins.py``): 5 s windows, 1 request in 25 traced.
TEL_KW = dict(telemetry="stream", tel_window_ticks=50, tel_windows=4,
              tel_span_k=25, tel_span_cap=2048)
# ``examples/slo_study.py``'s sweep with the example's defaults (a copy of
# the arguments it gives ``sockshop.make_sim``, checked by
# ``tools/chip_smoke_pins.py``; the placement is spread and the 10 hosts
# form 5 zones of 2): SockShop with 2 replicas, zone fail-slow chaos, HS
# re-evaluated every 5 s, 100 clients over 240 s; its two arms, the util
# gate with plain ejection and the burn gate with ejection tightened to
# 0.3 while alerts fire, as one ``run_batch``.
SLO_STUDY = dict(
    n_clients=100, duration_s=240.0, replicas=2, share=900.0, seed=11,
    scaling_policy=1, hs_util_hi=0.5, hs_util_lo=0.05, faults="chaos",
    host_mtbf_s=float("inf"), inst_kill_rate=0.0, retry_timeout_s=2.5,
    retry_budget=2, cb_err_thresh=0.5, cb_cooldown_s=5.0, cb_alpha=0.3,
    zone_slow_rate=0.015, host_slow_factor=0.1, host_slow_mttr_s=15.0,
    eject_err_thresh=0.35, eject_cooldown_s=8.0, telemetry="stream",
    tel_window_ticks=50, tel_windows=4, tel_span_k=50, tel_span_cap=1024,
    alerting="burn", slo_budget=0.05, slo_short_wins=3, slo_long_wins=12,
    slo_for_ticks=5, slo_stabilize_s=10.0)
SLO_ARMS = (("util", dict(scale_interval=50, hs_mode="util",
                          slo_eject_tighten=1.0)),
            ("slo_burn", dict(scale_interval=50, hs_mode="slo_burn",
                              slo_eject_tighten=0.3)))
# The JAX reference's results for the observability phase
# (``tools/chip_smoke_pins.py``): the streamed metric and alert rows of
# the ``OBS_CASES`` (``rows_summary``, ``alerts_summary``); SockShop 100
# clients HS over 600 s with ``TEL_KW``: its rows and ``verify_traces``
# (``traces_summary``); and each arm of the slo study (``slo_summary``).
ROW_PINS = {
    "case1b+obs": {
        "events": 0, "events_digest": "4f53cda18c2b", "rows": 42,
        "rows_digest": "4af4e812226f",
    },
    "case1b+slo": {
        "events": 0, "events_digest": "4f53cda18c2b", "rows": 42,
        "rows_digest": "4af4e812226f",
    },
}
TRACE_PINS = {
    "checks": 230, "checks_digest": "31c4c2525476", "eligible": 230,
    "exact": 230, "graph": 230, "rows": 120,
    "rows_digest": "1d920628657d",
}
SLO_PINS = (
    {"alerts.ev_drops": 0, "alerts.ev_n": 60, "alerts.fires": 16,
     "alerts.firing_ticks": 1437, "alerts.resolves": 15, "alerts.win": 48,
     "completed": 2272, "dropped_cloudlets": 0, "dropped_requests": 0,
     "events": 60, "events_digest": "315f1be3ba14", "finished": 7217,
     "migrations": 0, "requests": 2283, "resp_digest": 5304697311180,
     "scale_down": 0, "scale_in": 24, "scale_out": 14, "scale_up": 0,
     "slo_violations": 1459, "spawned": 8815},
    {"alerts.ev_drops": 0, "alerts.ev_n": 44, "alerts.fires": 11,
     "alerts.firing_ticks": 856, "alerts.resolves": 11, "alerts.win": 48,
     "completed": 2272, "dropped_cloudlets": 0, "dropped_requests": 0,
     "events": 44, "events_digest": "397085495627", "finished": 7390,
     "migrations": 0, "requests": 2283, "resp_digest": 5380114226336,
     "scale_down": 0, "scale_in": 18, "scale_out": 5, "scale_up": 0,
     "slo_violations": 1397, "spawned": 8846},
)


def study_zones(radius: int) -> np.ndarray:
    """The chaos study's failure domains: contiguous runs of ``radius``
    hosts (the last one ragged)."""
    return (np.arange(CHAOS_HOSTS) // radius).astype(np.int32)


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def cuda_ms(fn, n, torch):
    """Milliseconds per call of ``fn()``: (CUDA events around ``n`` calls
    after two warm-ups, the device time torch.profiler attributes to the
    kernels of ``n`` calls, traced with the CPU and CUDA activities, as
    ``run_train_full``'s profile: with CUDA alone it recorded no kernel
    launched through ctypes by an autograd-free call of the backward).
    The first includes any host launch gap; the second is None when three
    profiles in a row see no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    event_ms = a.elapsed_time(b) / n
    # late in a full run of this script the profiler now and then records
    # no device event for a whole session; profile again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev_us = _device_us(prof)
        if dev_us > 0:
            break
    return event_ms, (dev_us / n / 1e3 if dev_us > 0 else None)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def finish_inputs(C, I, R, seed, torch, dev, skew=None):
    """Pool-shaped inputs; ``skew`` puts 85 % of the lanes on that
    instance."""
    from repro_torch.core.types import Cloudlets, SimParams, resolve_layout
    L = resolve_layout(SimParams())
    g = np.random.default_rng(seed)
    ints = np.zeros((C, len(L.i_fields)), np.int32)
    flts = np.zeros((C, len(L.f_fields)), np.float32)
    ints[:, L.i("status")] = g.choice([0, 1, 2], C, p=[.2, .2, .6])
    ints[:, L.i("inst")] = g.integers(-1, I, C)
    if skew is not None:
        ints[g.random(C) < 0.85, L.i("inst")] = skew
    ints[:, L.i("req")] = g.integers(-1, R, C)
    ints[:, L.i("depth")] = g.integers(0, 5, C)
    flts[:, L.f("rem")] = g.uniform(0.0, 60.0, C)
    flts[:, L.f("arrival")] = g.uniform(0.0, 5.0, C)
    flts[:, L.f("start")] = np.where(g.random(C) < 0.3, -1.0,
                                     g.uniform(5.0, 10.0, C))
    t = lambda a: torch.tensor(a, device=dev)
    cl = Cloudlets(t(ints), t(flts), L)
    rate = t(g.uniform(0.0, 300.0, C).astype(np.float32))
    req = (t(g.uniform(0.0, 10.0, R).astype(np.float32)),
           t(g.integers(0, 3, R).astype(np.int32)),
           t(g.integers(0, 9, R).astype(np.int32)))
    return cl, rate, t(np.float32(10.0)), 0.5, req


def route_text(mode, n_blocks) -> str:
    return "one block" if n_blocks == 1 else f"{mode} of {n_blocks} blocks"


def check_cloudlet_finish(tag, C, I, R, torch, dev, skew=None):
    """The kernel against its plain version run on a CPU copy of the same
    inputs (the serial lane-order path the CPU parity tests hold to the
    reference): every output bit-equal, the instance sums included; two
    launches bit-identical; one device operation a call.  Whether the
    plain version's CUDA branch agrees is printed."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.cloudlet_step import ops, ref
    from torch.profiler import ProfilerActivity, profile
    cl, rate, t0, dt, req = finish_inputs(C, I, R, 11, torch, dev, skew)
    dt_dev = torch.tensor(np.float32(dt), device=dev)
    L = cl.layout
    cols = lambda d: (
        cl.ints[:, L.i("status")].to(d), cl.flts[:, L.f("rem")].to(d),
        cl.ints[:, L.i("inst")].to(d), cl.ints[:, L.i("req")].to(d),
        cl.flts[:, L.f("arrival")].to(d), cl.flts[:, L.f("start")].to(d),
        cl.ints[:, L.i("depth")].to(d))
    fresh = lambda d=dev: tuple(x.clone().to(d) for x in req)
    kern = lambda: ops.cloudlet_finish_pool(cl, rate, t0, dt_dev, *fresh(),
                                            I)
    work = fresh()      # timing only: the kernel updates these in place
    kern_t = lambda: ops.cloudlet_finish_pool(cl, rate, t0, dt_dev, *work,
                                              I)
    plain = lambda d: ref.cloudlet_finish(*cols(d), rate.to(d), t0.to(d),
                                          dt, *fresh(d), n_inst=I)
    saved = dict(counts)
    k1, k2 = kern(), kern()
    p_cpu, p_cuda = plain("cpu"), plain(dev)
    torch.cuda.synchronize()
    for f in p_cpu._fields:
        a, b = getattr(k1, f), getattr(k2, f)
        check(torch.equal(a, b), f"cloudlet_finish {tag}: two launches "
              f"differ in {f}")
        check(torch.equal(a.cpu(), getattr(p_cpu, f)),
              f"cloudlet_finish {tag}: {f} differs from the plain version")
    cuda_plain = [f for f in p_cpu._fields
                  if not torch.equal(getattr(p_cuda, f).cpu(),
                                     getattr(p_cpu, f))]
    check(bool((k1.inst_acc[:, 1] > 0).any()),
          f"cloudlet_finish {tag}: no lane finished")
    max_err = max(float((getattr(k1, f).cpu() - getattr(p_cpu, f))
                        .abs().max()) for f in ("new_rem", "tfin",
                                                 "consumed", "inst_acc",
                                                 "req_finish"))
    # 20 calls: the profiler can miss the events of a single short call
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            kern_t()
        torch.cuda.synchronize()
    ops_seen = sorted(_device_us_by_name(prof))
    check(len(ops_seen) == 1 and "finish_kernel" in ops_seen[0],
          f"cloudlet_finish {tag}: its calls ran {ops_seen} on the device, "
          "not one kernel")
    k_ev, k_dev = cuda_ms(kern_t, 200, torch)
    p_ev, p_dev = cuda_ms(lambda: ref.cloudlet_finish(
        *cols(dev), rate, t0, dt, *req, n_inst=I), 50, torch)
    counts.update(saved)
    bound_ms = _finish_bytes(cl, p_cpu.fin, C, I) / HBM_BYTES_PER_S * 1e3
    mode, tiles = ops.route(ops._lib(), C)
    log(f"cloudlet_finish {tag}: C={C} I={I} R={R} "
        f"({route_text(mode, tiles)})  "
        f"kernel {_ms(k_dev)} ms device / {k_ev:.4f} ms per call  plain "
        f"{_ms(p_dev)} ms device / {p_ev:.4f} ms per call  bound "
        f"{bound_ms:.6f} ms (bytes)  every output bit-equal to the plain "
        f"version on the CPU (max|err| {max_err}); device operations a "
        f"call: {ops_seen}; the plain version's CUDA branch "
        + ("agrees" if not cuda_plain else f"differs in {cuda_plain}"))
    return dict(ms=k_dev or k_ev, plain_ms=p_dev or p_ev,
                bound_ms=bound_ms, max_abs_err=max_err)


def check_launch_floor(torch, dev):
    """An empty kernel launched through the same ctypes path as the
    simulator's kernels: the floor their launch-bound times are read
    against."""
    from repro_torch.kernels.cloudlet_step import ops
    lib = ops._lib()
    lib.cloudlet_finish_empty_launch.argtypes = [ops.ctypes.c_void_p]
    launch = lambda: lib.cloudlet_finish_empty_launch(
        torch.cuda.current_stream(dev).cuda_stream)
    check(launch() == 0, "the empty kernel did not launch")
    ev, dev_ms = cuda_ms(launch, 500, torch)
    log(f"empty kernel (1 block of 32 threads, through ctypes): "
        f"{_ms(dev_ms)} ms device / {ev:.4f} ms per call")


def _finish_bytes(cl, fin, C, I):
    """Bytes one point's ``cloudlet_finish`` must move: 7 pool words and
    the rate per lane read; new_rem, tfin, consumed (4 B) and fin (1 B)
    written; the [I+1,5] sums written; each request row a finishing lane
    touches read and written in 3 arrays."""
    L = cl.layout
    req = cl.ints[:, L.i("req")].cpu()
    n_req = int(req[fin & (req >= 0)].unique().numel())
    return C * (8 * 4 + 3 * 4 + 1) + (I + 1) * 5 * 4 + n_req * 3 * 4 * 2


def check_unpooled(torch, dev, launches):
    """The reference's unpooled APIs at case1b's shape: ``cloudlet_finish``
    and ``cloudlet_step`` over ``[C]`` columns each launch
    ``cloudlet_finish.cu`` once (one call of each as an entry point,
    counted in ``launches``); every output bit-equal to its plain version
    run on a CPU copy; the time a call beside the pooled call's and the
    stacking copy's (the columns into ``[C, 4]`` and ``[C, 3]`` blocks)."""
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.kernels.cloudlet_step import (cloudlet_finish,
                                                   cloudlet_step, ops, ref)
    C, I, R = 8000, 1000, 1016008
    cl, rate, t0, dt, req = finish_inputs(C, I, R, 11, torch, dev)
    dt_dev = torch.tensor(np.float32(dt), device=dev)
    L = cl.layout
    cols = (cl.ints[:, L.i("status")], cl.flts[:, L.f("rem")],
            cl.ints[:, L.i("inst")], cl.ints[:, L.i("req")],
            cl.flts[:, L.f("arrival")], cl.flts[:, L.f("start")],
            cl.ints[:, L.i("depth")])
    host = lambda xs: [x.cpu() for x in xs]
    fresh = lambda d=dev: tuple(x.clone().to(d) for x in req)
    saved = dict(counts)
    reset_counts()
    fin = cloudlet_finish(*cols, rate, t0, dt_dev, *fresh(), n_inst=I)
    n_fin = counts["cloudlet_finish"]
    reset_counts()
    step = cloudlet_step(cols[0], cols[1], cols[2], rate, t0, dt_dev, I)
    n_step = counts["cloudlet_finish"]
    torch.cuda.synchronize()
    check(n_fin == 1 and n_step == 1, f"unpooled APIs: cloudlet_finish "
          f"launched {n_fin} and {n_step} times, not once a call")
    launches["cloudlet_finish"] = launches.get("cloudlet_finish", 0) + 2
    p_fin = ref.cloudlet_finish(*host(cols), rate.cpu(), t0.cpu(), dt,
                                *fresh("cpu"), n_inst=I)
    p_step = ref.cloudlet_step(*host(cols[:3]), rate.cpu(), t0.cpu(), dt,
                               I)
    for f, a, b in zip(p_fin._fields, fin, p_fin):
        check(torch.equal(a.cpu(), b), f"unpooled cloudlet_finish: {f} "
              "differs from the plain version")
    for f, a, b in zip(("new_rem", "fin", "tfin", "consumed", "used"),
                       step, p_step):
        check(torch.equal(a.cpu(), b), f"unpooled cloudlet_step: {f} "
              "differs from the plain version")
    check(bool((p_step[4] > 0).any()), "unpooled cloudlet_step: no "
          "instance used MI/s")
    work = fresh()      # timing only: the kernel updates these in place
    f_ev, f_dev = cuda_ms(lambda: cloudlet_finish(
        *cols, rate, t0, dt_dev, *work, n_inst=I), 200, torch)
    s_ev, s_dev = cuda_ms(lambda: cloudlet_step(
        cols[0], cols[1], cols[2], rate, t0, dt_dev, I), 200, torch)
    k_ev, k_dev = cuda_ms(lambda: ops.cloudlet_finish_pool(
        cl, rate, t0, dt_dev, *work, I), 200, torch)
    c_ev, c_dev = cuda_ms(lambda: (
        torch.stack([cols[0], cols[2], cols[3], cols[6]], dim=1),
        torch.stack([cols[1], cols[4], cols[5]], dim=1)), 200, torch)
    counts.update(saved)
    share = (c_dev / f_dev) if c_dev and f_dev else None
    log(f"unpooled APIs at case1b (C={C} I={I} R={R}): cloudlet_finish "
        f"{_ms(f_dev)} ms device / {f_ev:.4f} ms per call, cloudlet_step "
        f"{_ms(s_dev)} / {s_ev:.4f}, the pooled call {_ms(k_dev)} / "
        f"{k_ev:.4f}, the stacking copy {_ms(c_dev)} / {c_ev:.4f} ("
        + ("not measured" if share is None else f"{share:.3f}")
        + " of cloudlet_finish's device time); one launch a call, every "
        f"output bit-equal to the plain version on the CPU  ({gpu_line()})")
    return dict(finish_ms=f_dev, finish_call_ms=f_ev, step_ms=s_dev,
                step_call_ms=s_ev, pool_ms=k_dev, copy_ms=c_dev)


def check_cloudlet_finish_batched(tag, B, C, I, R, torch, dev):
    """``B`` points of one pool shape in one launch (the batched tick's
    call): every point's outputs bit-equal to that point's unbatched
    launch and to the plain version on a CPU copy of its inputs, with its
    own time and dt; one launch and one device operation a call."""
    from repro_torch.core.types import Cloudlets
    from repro_torch.kernels import counts
    from repro_torch.kernels.cloudlet_step import ops, ref
    from torch.profiler import ProfilerActivity, profile
    pts = [finish_inputs(C, I, R, 11 + b, torch, dev) for b in range(B)]
    L = pts[0][0].layout
    cl = Cloudlets(torch.stack([p[0].ints for p in pts]),
                   torch.stack([p[0].flts for p in pts]), L)
    rate = torch.stack([p[1] for p in pts])
    time_b = torch.tensor([10.0 + 0.5 * b for b in range(B)],
                          dtype=torch.float32, device=dev)
    dt_b = torch.tensor([0.5 if b % 2 == 0 else 0.1 for b in range(B)],
                        dtype=torch.float32, device=dev)
    req = tuple(torch.stack([p[4][k] for p in pts]) for k in range(3))
    fresh = lambda: tuple(x.clone() for x in req)
    saved = dict(counts)
    n0 = counts["cloudlet_finish"]
    got = ops.cloudlet_finish_pool(cl, rate, time_b, dt_b, *fresh(), I)
    check(counts["cloudlet_finish"] == n0 + 1,
          f"cloudlet_finish batched {tag}: not one launch a call")
    col = lambda c, n, d: (c.ints[..., L.i(n)] if n in L.i_fields
                           else c.flts[..., L.f(n)]).to(d)
    names = ("status", "rem", "inst", "req", "arrival", "start", "depth")
    max_err, nbytes = 0.0, 0
    for b, (pcl, prate, _, _, preq) in enumerate(pts):
        one = ops.cloudlet_finish_pool(pcl, prate, time_b[b], dt_b[b],
                                       *[x.clone() for x in preq], I)
        plain = ref.cloudlet_finish(
            *[col(pcl, n, "cpu") for n in names], prate.cpu(),
            time_b[b].cpu(), float(dt_b[b]), *[x.cpu() for x in preq],
            n_inst=I)
        torch.cuda.synchronize()
        for f in plain._fields:
            g = getattr(got, f)[b]
            check(torch.equal(g, getattr(one, f)), f"cloudlet_finish "
                  f"batched {tag}: point {b}'s {f} differs from its "
                  "unbatched launch")
            check(torch.equal(g.cpu(), getattr(plain, f)), f"cloudlet_finish"
                  f" batched {tag}: point {b}'s {f} differs from the plain "
                  "version")
        max_err = max(max_err, max(
            float((getattr(got, f)[b].cpu() - getattr(plain, f)).abs().max())
            for f in ("new_rem", "tfin", "consumed", "inst_acc",
                      "req_finish")))
        nbytes += _finish_bytes(pcl, plain.fin, C, I)
    work = fresh()
    kern_t = lambda: ops.cloudlet_finish_pool(cl, rate, time_b, dt_b, *work,
                                              I)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            kern_t()
        torch.cuda.synchronize()
    ops_seen = sorted(_device_us_by_name(prof))
    check(len(ops_seen) == 1 and "finish_kernel" in ops_seen[0],
          f"cloudlet_finish batched {tag}: its calls ran {ops_seen}")
    k_ev, k_dev = cuda_ms(kern_t, 100, torch)
    cols_b = [col(cl, n, dev) for n in names]
    dt_host = dt_b.cpu()
    p_ev, p_dev = cuda_ms(lambda: ref.cloudlet_finish_batched(
        *cols_b, rate, time_b, dt_host, *req, n_inst=I), 5, torch)
    counts.update(saved)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    mode, tiles = ops.route(ops._lib(), C)
    log(f"cloudlet_finish batched {tag}: B={B} x (C={C} I={I} R={R}) "
        f"({route_text(mode, tiles)} a point, one launch)  kernel "
        f"{_ms(k_dev)} ms device / {k_ev:.4f} ms per call  plain (point by "
        f"point) {_ms(p_dev)} ms device / {p_ev:.4f} ms per call  bound "
        f"{bound_ms:.6f} ms (bytes)  every point bit-equal to its "
        f"unbatched launch and to the plain version on the CPU (max|err| "
        f"{max_err}); device operations a call: {ops_seen}")
    return dict(ms=k_dev or k_ev, plain_ms=p_dev or p_ev,
                bound_ms=bound_ms, max_abs_err=max_err)


def check_link_share_batched(tag, B, C, H, torch, dev, iters=2):
    """``B`` points of one fabric shape in one launch, each over its own
    capacities: every point's rates bit-equal to its unbatched launch and
    to the plain version on a CPU copy; one launch a call."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.link_share import ops, ref
    pts = [link_inputs(C, H, 13 + 7 * b, torch, dev) for b in range(B)]
    args = [torch.stack([p[k] for p in pts]) for k in range(5)]
    saved = dict(counts)
    n0 = counts["link_share"]
    got = ops.link_share(*args, iters=iters)
    check(counts["link_share"] == n0 + 1,
          f"link_share batched {tag}: not one launch a call")
    max_err = 0.0
    for b, p in enumerate(pts):
        one = ops.link_share(*p, iters=iters)
        plain = ref.waterfill(*[x.cpu() for x in p], iters)
        torch.cuda.synchronize()
        check(torch.equal(got[b], one), f"link_share batched {tag}: point "
              f"{b} differs from its unbatched launch")
        check(torch.equal(got[b].cpu(), plain), f"link_share batched {tag}:"
              f" point {b} differs from the plain version")
        max_err = max(max_err, float((got[b].cpu() - plain).abs().max()))
    k_ev, k_dev = cuda_ms(lambda: ops.link_share(*args, iters=iters), 100,
                          torch)
    p_ev, p_dev = cuda_ms(lambda: ref.link_share_batched(*args, iters), 3,
                          torch)
    counts.update(saved)
    nbytes = B * (C * (4 + 4 + 1 + 4) + 2 * H * 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    per = -(-C // 16384)
    route = ("one block a point" if per == 1 else
             f"cooperative grid, {per} blocks a point")
    log(f"link_share batched {tag}: B={B} x (C={C} H={H}) iters={iters} "
        f"({route}, one launch)  kernel {_ms(k_dev)} ms device / "
        f"{k_ev:.4f} ms per call  plain (point by point) {_ms(p_dev)} ms "
        f"device / {p_ev:.4f} ms per call  bound {bound_ms:.6f} ms (bytes)"
        f"  every point bit-equal to its unbatched launch and to the plain "
        f"version on the CPU (max|err| {max_err})")
    return dict(ms=k_dev or k_ev, plain_ms=p_dev or p_ev,
                bound_ms=bound_ms, max_abs_err=max_err)


def tropical_inputs(B, S, seed, torch, dev):
    g = np.random.default_rng(seed)
    w = g.uniform(0.0, 5.0, (B, S, S)).astype(np.float32)
    keep = np.triu(g.random((B, S, S)) < 0.3, k=1)
    a = np.where(keep, w, -np.inf).astype(np.float32)
    a = np.maximum(a, np.where(np.eye(S, dtype=bool), 0.0, -np.inf))
    return torch.tensor(a.astype(np.float32), device=dev)


def tropical_floor_ms(terms):
    """The issue floor of ``terms`` (max, +) terms: an FADD and an FMNMX
    each, at 128 lanes a clock on each SM."""
    return 2.0 * terms / (SM_COUNT * FP32_LANES * SM_CLOCK_HZ) * 1e3


def tropical_bound(terms, nbytes):
    """(bound ms, what bounds it): 2 operations a term at the float32 peak,
    or the bytes at the memory rate."""
    return max((2.0 * terms / FP32_OPS_PER_S * 1e3, "operations"),
               (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))


def check_tropical_product(tag, B, S, torch, dev):
    """The product kernel against its plain version (bit for bit, through
    the int32 view; the inputs hold no -0), and the closure at the same
    shape (its route: the closure kernel up to ``ops.CLOSURE_MAX_S``, the
    repeated products above) against the plain squarings."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.tropical import ops, ref
    x = tropical_inputs(B, S, 5, torch, dev)
    saved = dict(counts)
    k = ops.tropical_matmul(x, x)
    p = ref.tropical_matmul(x, x)
    torch.cuda.synchronize()
    check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
          f"tropical_matmul {tag}: differs from the plain version")
    kc = ops.tropical_closure(x, depth=S)
    pc = ref.tropical_closure(x, S)
    check(torch.equal(kc.view(torch.int32), pc.view(torch.int32)),
          f"tropical_closure {tag} ({ops.closure_route(S)}): differs from "
          "the plain squarings")
    del kc, pc
    k_ev, k_dev = cuda_ms(lambda: ops.tropical_matmul(x, x), 50, torch)
    p_ev, p_dev = cuda_ms(lambda: ref.tropical_matmul(x, x), 3, torch)
    counts.update(saved)
    terms = float(B) * S * S * S
    bound_ms, by = tropical_bound(terms, 4.0 * 3 * B * S * S)
    floor_ms = tropical_floor_ms(terms)
    k_ms = k_dev or k_ev
    log(f"tropical_matmul {tag}: B={B} S={S}  kernel {_ms(k_dev)} ms "
        f"device / {k_ev:.4f} ms per call  plain {_ms(p_dev)} ms device / "
        f"{p_ev:.4f} ms per call  bound {bound_ms:.6f} ms ({by}), "
        f"{bound_ms / k_ms:.3f} of it  issue floor {floor_ms:.6f} ms, "
        f"{floor_ms / k_ms:.3f} of it  bit-equal; the closure "
        f"({ops.closure_route(S)}) bit-equal to the plain squarings")
    return dict(ms=k_ms, plain_ms=p_dev or p_ev, bound_ms=bound_ms,
                bound_by=by, max_abs_err=float(
                    (k - p).abs().nan_to_num(0.0).max()))


def check_tropical_closure(tag, B, S, depth, torch, dev):
    """The closure kernel (one launch: max(A, I) and every squaring)
    against the plain squarings, bit for bit; ``depth`` is the service
    graph's."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.tropical import ops, ref
    check(ops.closure_route(S) == ops.CLOSURE,
          f"tropical_closure {tag}: S={S} is not on the closure kernel")
    x = tropical_inputs(B, S, 6, torch, dev)
    saved = dict(counts)
    k = ops.tropical_closure(x, depth=depth)
    n = {name: counts[name] - saved[name] for name in counts}
    p = ref.tropical_closure(x, depth)
    torch.cuda.synchronize()
    check(n["tropical_closure"] == 1 and n["tropical_matmul"] == 0,
          f"tropical_closure {tag}: launched {n}")
    check(torch.equal(k.view(torch.int32), p.view(torch.int32)),
          f"tropical_closure {tag}: differs from the plain squarings")
    k_ev, k_dev = cuda_ms(lambda: ops.tropical_closure(x, depth=depth), 200,
                          torch)
    p_ev, p_dev = cuda_ms(lambda: ref.tropical_closure(x, depth), 50, torch)
    counts.update(saved)
    n_sq = ops.squarings(S, depth)
    terms = float(n_sq) * B * S * S * S
    bound_ms, by = tropical_bound(terms, 4.0 * 2 * B * S * S)
    floor_ms = tropical_floor_ms(terms)
    log(f"tropical_closure {tag}: B={B} S={S} depth={depth} ({n_sq} "
        f"squarings, one launch)  kernel {_ms(k_dev)} ms device / "
        f"{k_ev:.4f} ms per call  plain {_ms(p_dev)} ms device / "
        f"{p_ev:.4f} ms per call  bound {bound_ms:.6f} ms ({by})  issue "
        f"floor {floor_ms:.6f} ms  bit-equal")
    return dict(ms=k_dev or k_ev, plain_ms=p_dev or p_ev, bound_ms=bound_ms,
                bound_by=by, max_abs_err=float(
                    (k - p).abs().nan_to_num(0.0).max()))


def link_inputs(C, H, seed, torch, dev):
    """Transfers over random ports: a tenth client uploads, a twentieth
    with no destination, a quarter inactive, capacities 0.5-100 MB/s."""
    g = np.random.default_rng(seed)
    src = g.integers(0, H, C).astype(np.int32)
    src[g.random(C) < 0.1] = -1
    dst = g.integers(0, H, C).astype(np.int32)
    dst[g.random(C) < 0.05] = -1
    active = g.random(C) < 0.75
    cap_e = g.uniform(0.5, 100.0, H).astype(np.float32)
    cap_i = g.uniform(0.5, 100.0, H).astype(np.float32)
    return [torch.tensor(a, device=dev)
            for a in (src, dst, active, cap_e, cap_i)]


def check_link_share(tag, C, H, torch, dev, iters=2):
    from repro_torch.kernels import counts
    from repro_torch.kernels.link_share import ops, ref
    args = link_inputs(C, H, 13, torch, dev)
    saved = dict(counts)
    k1 = ops.link_share(*args, iters=iters)
    k2 = ops.link_share(*args, iters=iters)
    p = ref.waterfill(*args, iters)
    torch.cuda.synchronize()
    check(torch.equal(k1, k2), f"link_share {tag}: two launches differ")
    check(torch.equal(k1, p), f"link_share {tag}: differs from the plain "
          "version")
    check(bool((k1 > 0).any()), f"link_share {tag}: no transfer moved")
    k_ev, k_dev = cuda_ms(lambda: ops.link_share(*args, iters=iters), 200,
                          torch)
    p_ev, p_dev = cuda_ms(lambda: ref.waterfill(*args, iters), 20, torch)
    counts.update(saved)
    # bytes: src, dst (4 B) and active (1 B) per lane and both capacity
    # tables read once, one float rate per lane written
    nbytes = C * (4 + 4 + 1 + 4) + 2 * H * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    max_err = float((k1 - p).abs().max())
    # one block of 1024 threads per 16,384 transfers, a cooperative grid
    # when there are more
    route = route_text("cooperative grid", -(-C // 16384))
    log(f"link_share {tag}: C={C} H={H} iters={iters} ({route})  kernel "
        f"{_ms(k_dev)} ms device / {k_ev:.4f} ms per call  plain "
        f"{_ms(p_dev)} ms device / {p_ev:.4f} ms per call  bound "
        f"{bound_ms:.6f} ms (bytes)  max|err| {max_err}")
    return dict(ms=k_dev or k_ev, plain_ms=p_dev or p_ev,
                bound_ms=bound_ms, max_abs_err=max_err)


def check_link_share_cut(tag, C, H, torch, dev, iters=2):
    """``link_share`` on chaos mode's new inputs: a quarter of the egress
    and a fifth of the ingress ports at capacity 0 (a brownout of severity
    0) and a fifth of the transfers cut out of ``flowing`` (a zone-pair
    partition), bit-equal to the plain version on the card and on a CPU
    copy of the inputs."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.link_share import ops, ref
    src, dst, active, cap_e, cap_i = link_inputs(C, H, 29, torch, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    cap_e[::4] = 0.0
    cap_i[1::5] = 0.0
    active &= torch.rand(C, generator=g, device=dev) >= 0.2
    args = (src, dst, active, cap_e, cap_i)
    saved = dict(counts)
    k1 = ops.link_share(*args, iters=iters)
    k2 = ops.link_share(*args, iters=iters)
    p = ref.waterfill(*args, iters)
    cpu = ref.waterfill(*[a.cpu() for a in args], iters)
    torch.cuda.synchronize()
    counts.update(saved)
    check(torch.equal(k1, k2), f"link_share {tag}: two launches differ")
    check(torch.equal(k1, p), f"link_share {tag}: differs from the plain "
          "version on the card")
    check(torch.equal(k1.cpu(), cpu), f"link_share {tag}: differs from the "
          "plain version on the CPU")
    starved = (active & (dst >= 0) & (cap_i[dst.clamp_min(0)] == 0))
    check(bool((k1[starved] == 0).all()), f"link_share {tag}: a transfer "
          "into a zero-capacity port moved")
    check(bool((k1 > 0).any()), f"link_share {tag}: no transfer moved")
    k_ev, k_dev = cuda_ms(lambda: ops.link_share(*args, iters=iters), 200,
                          torch)
    p_ev, p_dev = cuda_ms(lambda: ref.waterfill(*args, iters), 20, torch)
    counts.update(saved)
    log(f"link_share {tag}: C={C} H={H} iters={iters}, "
        f"{int((cap_e == 0).sum())} egress and {int((cap_i == 0).sum())} "
        f"ingress ports at capacity 0, {int((~active).sum())} transfers "
        "out of the water-fill: bit-equal to the plain version on the card "
        f"and on the CPU, two launches bit-identical  kernel {_ms(k_dev)} ms"
        f" device / {k_ev:.4f} ms per call  plain {_ms(p_dev)} ms device / "
        f"{p_ev:.4f} ms per call")


def flash_inputs(B, Hq, Hkv, T, D, torch, dev, seed=17, Tk=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda H, n: torch.randn((B, H, n, D), generator=g, device=dev) \
        .to(torch.bfloat16)
    Tk = T if Tk is None else Tk
    return mk(Hq, T), mk(Hkv, Tk), mk(Hkv, Tk)


def flash_plain(q, k, v, rows, causal=True):
    """The plain version over query blocks of ``rows`` rows: block
    [q0, q1) against keys [0, q1 + Tk - Tq) is ``ref.attention``'s
    end-aligned causal rule for those rows (against every key when not
    causal), so the result is the plain version's, with one block's
    float32 logits (not Tq x Tk of them) alive at a time."""
    from repro_torch.kernels.flash_attention import ref
    Tq, Tk = q.shape[2], k.shape[2]
    if rows >= Tq:
        return ref.attention(q, k, v, causal=causal)
    assert not causal or Tq == Tk, (Tq, Tk)
    out = q.new_empty(q.shape)
    for q0 in range(0, Tq, rows):
        q1 = min(q0 + rows, Tq)
        k1 = q1 if causal else Tk
        out[:, :, q0:q1] = ref.attention(q[:, :, q0:q1], k[:, :, :k1],
                                         v[:, :, :k1], causal=causal)
    return out


def check_flash(tag, B, Hq, Hkv, T, D, torch, dev, n_time, causal=True,
                Tk=None, lse=False):
    """The flash kernel at a model's prefill heads against its plain
    version (and SDPA timed beside it as the yardstick), causal or not,
    T query rows on ``Tk`` keys (T unless given).  Each output element
    must lie within one bfloat16 rounding of the plain version's
    (``FLASH_RTOL`` of its magnitude) plus ``FLASH_ATOL``.  With ``lse``
    the timed call is the training forward, ``launch(..., with_lse=True)``
    (its output bit-equal to the serving launch's, its log-sum-exp within
    1e-4 of ``ref.logsumexp``), and the bound counts the rows' log-sum-exp
    written."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attention import ops
    Tk = T if Tk is None else Tk
    q, k, v = flash_inputs(B, Hq, Hkv, T, D, torch, dev, Tk=Tk)
    rows = FLASH_PLAIN_ROWS
    saved = dict(counts)
    k1 = ops.attention(q, k, v, causal=causal)
    k2 = ops.attention(q, k, v, causal=causal)
    p = flash_plain(q, k, v, rows, causal)
    torch.cuda.synchronize()
    check(torch.equal(k1, k2), f"flash_attention {tag}: two launches differ")
    call = lambda: ops.attention(q, k, v, causal=causal)
    if lse:
        from repro_torch.kernels.flash_attention import ref
        call = lambda: ops.launch(q, k, v, causal, None, with_lse=True)
        out, rows_lse = call()
        lse_err = float((rows_lse - ref.logsumexp(q, k, causal=causal))
                        .abs().max())
        check(torch.equal(out, k1) and lse_err <= 1e-4,
              f"flash_attention {tag}: the output with the log-sum-exp "
              f"differs from the serving launch's, or its lse is off by "
              f"{lse_err}")
        del out, rows_lse
    diff = (k1.float() - p.float()).abs()
    err = float(diff.max())
    excess = float((diff - FLASH_RTOL * p.float().abs()).max())
    check(bool(torch.isfinite(k1).all()) and excess <= FLASH_ATOL,
          f"flash_attention {tag}: max|err| {err}, an element off by "
          f"{excess} beyond {FLASH_RTOL}·|plain| (tolerance {FLASH_ATOL})")
    del diff
    k_ev, k_dev = cuda_ms(call, n_time, torch)
    p_ev, p_dev = cuda_ms(lambda: flash_plain(q, k, v, rows, causal), 1,
                          torch)
    counts.update(saved)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    torch.cuda.synchronize()
    lib_err = float((lib.float() - p.float()).abs().max())
    del lib
    l_ev, l_dev = cuda_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                       enable_gqa=True), 5, torch)
    lib_ms = l_dev or l_ev
    # operations: QK and PV over the visible pairs (causal: the end-
    # aligned triangle, T = Tk), 2 per multiply-add, at the bf16
    # tensor-core peak of the inputs' type; bytes: q, k, v read once and
    # the output written once (bf16)
    pairs = T * (T + 1) // 2 if causal else T * Tk
    ops_n = 4.0 * B * Hq * pairs * D
    nbytes = 2.0 * B * D * (2 * Hq * T + 2 * Hkv * Tk) \
        + (4.0 * B * Hq * T if lse else 0.0)
    bound_ms, by = max((ops_n / BF16_OPS_PER_S * 1e3, "operations"),
                       (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    k_ms = k_dev or k_ev
    log(f"flash_attention {tag}: B={B} Hq={Hq} Hkv={Hkv} Tq={T} Tk={Tk} "
        f"D={D} {'causal' if causal else 'non-causal'} bf16"
        f"{' with the log-sum-exp' if lse else ''}  "
        f"kernel {_ms(k_dev)} ms device / {k_ev:.4f} ms per call  "
        f"{ops_n / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s  "
        f"{bound_ms / k_ms:.3f} of the bound  {k_ms / lib_ms:.3f}x SDPA  "
        f"plain ({min(rows, T)}-row query blocks) {_ms(p_dev)} ms device / "
        f"{p_ev:.4f} ms per call  SDPA {_ms(lib_ms)} ms (max|err| "
        f"{lib_err:.3g})  bound {bound_ms:.6f} ms ({by})  max|err| "
        f"{err:.3g} (worst excess over {FLASH_RTOL}·|plain|: {excess:.3g})")
    del q, k, v, k1, k2, p
    torch.cuda.empty_cache()
    return dict(ms=k_ms, plain_ms=p_dev or p_ev,
                bound_ms=bound_ms, bound_by=by, max_abs_err=err,
                library_ms=lib_ms)


def ptxas_report(name):
    """Each kernel of the build of ``csrc/<name>.cu`` (mangled name) with
    its registers and spill bytes, from the ``ptxas -v`` report the build
    keeps."""
    from repro_torch.kernels import _build
    out, fn = {}, None
    for ln in _build.log(name).splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", ln)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn:
            out[fn]["spills"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def sass_ops(path, tool):
    """Each kernel of a built library (mangled name) with the count of
    each SASS opcode (modifiers kept: ``FMNMX.NAN``)."""
    sass = subprocess.run([tool, "--dump-sass", str(path)],
                          capture_output=True, text=True, timeout=300).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", ln)
        if m and fn:
            out[fn][m.group(1)] = out[fn].get(m.group(1), 0) + 1
    return out


def check_tropical_build(tool):
    """The tropical kernels spill nothing, and each term of their unrolled
    inner loops is one FADD and one FMNMX (``max.NaN.f32``): as many FMNMX
    as FADD in each kernel's SASS."""
    from repro_torch.kernels import _build
    report = ptxas_report("tropical")
    log("tropical ptxas: " + (" | ".join(
        f"{k}: {v.get('registers', '?')} registers, "
        f"{v.get('spills', '?')} bytes spilled"
        for k, v in report.items()) or "no report"))
    check(len(report) == 2 and all(v.get("spills") == 0
                                   for v in report.values()),
          "tropical: the ptxas report lacks a kernel, or one spills")
    for fn, ops in sass_ops(_build.library("tropical"), tool).items():
        n = {k: sum(v for op, v in ops.items() if op.split(".")[0] == k)
             for k in ("FADD", "FMNMX", "FSETP", "FSEL", "LDS", "LDGSTS")}
        log(f"tropical SASS {fn}: " + "  ".join(f"{k} {v}"
                                                for k, v in n.items())
            + f"  (FMNMX forms: {sorted(op for op in ops if 'FMNMX' in op)})")
        check(n["FADD"] > 0 and n["FMNMX"] == n["FADD"],
              f"tropical {fn}: {n['FMNMX']} FMNMX for {n['FADD']} FADD, not "
              "one max instruction a term")


def check_builds():
    """The ``ptxas`` registers and spills per kernel of the simulator's
    redesigned builds (``tropical``, ``cloudlet_finish``, ``link_share``)
    and of the
    model-zoo builds (``flash_attention``, ``ssd_chunk``); the latter's
    SASS must hold wgmma (``HGMMA``) and TMA loads (``UTMALDG``) and their
    tensor-core kernels (``*_sm90``) must spill nothing."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check_tropical_build(tool)
    for name in ("cloudlet_finish", "link_share"):
        log(f"{name} ptxas: " + " | ".join(
            f"{k}: {v.get('registers', '?')} registers, "
            f"{v.get('spills', '?')} bytes spilled"
            for k, v in ptxas_report(name).items()))
    for name in ("flash_attention", "ssd_chunk"):
        report = ptxas_report(name)
        log(f"{name} ptxas: " + (" | ".join(
            f"{k}: {v.get('registers', '?')} registers, "
            f"{v.get('spills', '?')} bytes spilled"
            for k, v in report.items()) or "no report"))
        sm90 = {k: v for k, v in report.items() if "_sm90" in k}
        check(sm90 and all(v.get("spills") == 0 for v in sm90.values()),
              f"{name}: no tensor-core kernel in the ptxas report, or one "
              "that spills")
        sass = subprocess.run(
            [tool, "--dump-sass", str(_build.library(name))],
            capture_output=True, text=True, timeout=300).stdout
        n = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
        log(f"{name} SASS: " + "  ".join(f"{k} {v}" for k, v in n.items()))
        check(n["HGMMA"] > 0 and n["UTMALDG"] > 0,
              f"{name}: the built library holds no wgmma (HGMMA) or no "
              "TMA load (UTMALDG)")


def check_ssd(tag, M, K, L, P, N, torch, dev, group=None):
    """The SSD-chunk kernel against its plain version, ``group`` heads to
    a B/C row (all M heads, one row, unless given: mamba2-130m's prefill);
    ``ops.route`` names the kernel the shape takes."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.ssd_scan import ops, ref
    g = torch.Generator(device=dev).manual_seed(19)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    dt = r(M, K, L, 1) * 0.25 + 0.05
    group = group or M
    G = M // group
    args = (n(M, K, L, P), dt, dt * -(r(M, 1, 1, 1) * 15.0 + 1.0),
            n(G, K, L, N) / N ** 0.5, n(G, K, L, N) / N ** 0.5)
    saved = dict(counts)
    k1 = ops.ssd_chunk(*args, group=group)
    k2 = ops.ssd_chunk(*args, group=group)
    p = ref.ssd_chunk(*args, group=group)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          f"ssd_chunk {tag}: two launches differ")
    err = max(float((a - b).abs().max()) for a, b in zip(k1, p))
    check(err <= SSD_TOL, f"ssd_chunk {tag}: max|err| {err} against the "
          f"plain version (tolerance {SSD_TOL})")
    k_ev, k_dev = cuda_ms(lambda: ops.ssd_chunk(*args, group=group), 50,
                          torch)
    p_ev, p_dev = cuda_ms(lambda: ref.ssd_chunk(*args, group=group), 5,
                          torch)
    counts.update(saved)
    # the function's least operations: C·Bᵀ once per chunk and B/C group
    # (G groups) over its causal half, S·(Δ⊙X) over the causal half
    # and the state product per head, 2 per multiply-add, at the TF32
    # tensor-core peak; bytes: x, Δ, log a, the group's B and C read, y,
    # state, in_decay and total written (float32).  The float32-pipe
    # figure (C·Bᵀ per head at the float32 peak) was this row's bound
    # before the tensor-core kernel and is printed beside it.
    tri = L * (L + 1) // 2
    ops_n = 2.0 * (G * K * tri * N + M * K * (tri * P + N * P * L))
    nbytes = 4.0 * (M * K * L * (P + 2) + 2 * G * K * L * N
                    + M * K * (L * P + N * P + L + 1))
    bound_ms, by = max((ops_n / TF32_OPS_PER_S * 1e3, "operations"),
                       (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    f32_ms = max(2.0 * M * K * (tri * (N + P) + N * P * L)
                 / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    k_ms = k_dev or k_ev
    if ops.route(L, N, P) == ops.TENSOR_CORES:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        kernel = (f"ssd_chunk_sm90, "
                  f"{ops.heads_per_block(K, G, group, sms)} heads a block")
    else:
        kernel = "ssd_chunk_kernel"
    log(f"ssd_chunk {tag}: M={M} K={K} L={L} P={P} N={N} group={group} "
        f"({kernel})  "
        f"kernel {_ms(k_dev)} ms device / {k_ev:.4f} ms per call  "
        f"{ops_n / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s  "
        f"{bound_ms / k_ms:.3f} of the bound  plain {_ms(p_dev)} ms device "
        f"/ {p_ev:.4f} ms per call  bound {bound_ms:.6f} ms ({by}; "
        f"float32-pipe figure {f32_ms:.6f} ms)  max|err| {err:.3g}")
    return dict(ms=k_ms, plain_ms=p_dev or p_ev,
                bound_ms=bound_ms, bound_by=by, max_abs_err=err)


# The golden scenario's chaos pins (``tests/test_layouts.py``
# ``MATRIX_GOLDEN``; ``tools/chip_smoke_pins.py`` checks the copy).
GOLDEN_CHAOS = {
    "uniform": dict(completed=54, spawned=1002, finished=296,
                    resp_digest=1530248430121, transits=0,
                    failed_attempts=517, retries=388),
    "fabric": dict(completed=78, spawned=803, finished=626,
                   resp_digest=1477918938445, transits=289,
                   failed_attempts=80, retries=79),
}
# the golden scenario's chaos knobs (``matrix_sim``'s)
GOLDEN_CHAOS_KNOBS = dict(faults="chaos", host_mtbf_s=20.0, host_mttr_s=5.0,
                          retry_timeout_s=3.0, retry_budget=2,
                          inst_kill_rate=0.01)


def golden_sim(network, dev, chaos=False):
    """The reference's golden scenario (``tests/test_layouts.py``
    ``matrix_sim``) in either network mode, with or without chaos."""
    from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,
                                  Simulation, diamond)
    caps = SimCaps(n_clients=16, max_requests=512, max_cloudlets=512,
                   max_instances=8, n_vms=4, d_max=2, max_replicas=2)
    net = (dict(network="fabric", nic_egress_mbps=50.0,
                nic_ingress_mbps=50.0) if network == "fabric"
           else dict(net_latency_s=0.05))
    if chaos:
        net.update(GOLDEN_CHAOS_KNOBS)
    params = SimParams(dt=0.05, n_ticks=300, n_clients=12, spawn_rate=5.0,
                       wait_lo=0.5, wait_hi=1.5, seed=3, **net)
    return Simulation(diamond(mi=400.0), caps=caps, params=params,
                      default_template=InstanceTemplate(
                          mips=8000.0, limit_mips=16000.0, replicas=2),
                      vm_mips=np.full(4, 64000.0, np.float32), device=dev)


def check_golden(torch, dev):
    """The reference's golden scenarios (uniform network and the fabric,
    no faults): their integer counters and response digests are
    pinned."""
    from repro_torch.kernels import counts
    for network, pins in (("uniform", GOLDEN), ("fabric", GOLDEN_FABRIC)):
        saved = dict(counts)
        st = golden_sim(network, dev).run().state
        n_link = counts["link_share"] - saved["link_share"]
        counts.update(saved)
        resp = st.requests.response.cpu().numpy()
        got = dict(completed=int(st.counters.completed),
                   spawned=int(st.counters.spawned),
                   finished=int(st.counters.finished),
                   resp_digest=int(resp.view(np.uint32).astype(np.uint64)
                                   .sum()))
        if network == "fabric":
            got["transits"] = int(st.net.transits)
            check(n_link == 300, f"fabric golden scenario: link_share "
                  f"launched {n_link} times in 300 ticks")
        log(f"golden scenario ({network}) on the card: {got}")
        check(got == pins, f"golden scenario ({network}) differs from its "
              f"pins {pins}")


class GoldenChaos:
    """``check_golden_chaos`` in a child process on numpy's own code paths
    (see ``GOLDEN_CHAOS_FLAG``): ``start()`` spawns it while the kernels
    build (it waits on the simulator libraries' build locks; its card
    work is small), ``result()`` relays its output and fails if it does,
    ``stop()`` ends it."""

    def __init__(self):
        self.proc = None

    def start(self):
        env = {k: v for k, v in os.environ.items()
               if k != "NPY_DISABLE_CPU_FEATURES"}
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), GOLDEN_CHAOS_FLAG],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def result(self):
        out, err = self.proc.communicate(timeout=600)
        for line in out.splitlines():
            log(line)
        check(self.proc.returncode == 0, "golden chaos phase failed:\n"
              + err[-3000:])

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


GOLDEN_CHAOS_RUN = GoldenChaos()


def check_golden_chaos(torch, dev):
    """The golden scenario's chaos combos on the card: the pinned fields
    of ``MATRIX_GOLDEN``, the chaos conservation law, one kernel launch a
    tick, and every leaf and trace equal to the same run on the CPU."""
    from repro_torch.kernels import counts
    for network, pins in GOLDEN_CHAOS.items():
        saved = dict(counts)
        res = golden_sim(network, dev, chaos=True).run()
        n = {k: counts[k] - saved[k] for k in ("cloudlet_finish",
                                                "link_share")}
        counts.update(saved)
        st = res.state
        got = dict(completed=int(st.counters.completed),
                   spawned=int(st.counters.spawned),
                   finished=int(st.counters.finished),
                   resp_digest=sockshop_summary(st)["resp_digest"],
                   transits=int(st.net.transits),
                   failed_attempts=int(st.fstats.failed_attempts),
                   retries=int(st.fstats.retries))
        want = dict(cloudlet_finish=300,
                    link_share=300 if network == "fabric" else 0)
        check(n == want, f"golden chaos ({network}): launches {n}, want "
              f"{want}")
        laws = conservation(st)
        check(got == pins, f"golden chaos ({network}) on the card: {got} "
              f"differs from its pins {pins}")
        t0 = time.perf_counter()
        cpu = golden_sim(network, "cpu", chaos=True).run()
        same_run(f"golden chaos ({network}): the card against the CPU",
                 run_bits(res, torch), run_bits(cpu, torch))
        log(f"golden chaos ({network}) on the card: {got} equal the pins; "
            f"every leaf and trace equal to the CPU run "
            f"({time.perf_counter() - t0:.1f} s); launches {n}; {laws}")


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

def state_digest(state, torch) -> dict:
    """Every leaf of a state as bytes, for bit-identity checks."""
    from repro_torch.core.convert import state_to_numpy
    out = {}

    def walk(d, pre):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, pre + k + ".")
            else:
                out[pre + k] = np.ascontiguousarray(v).tobytes()
    walk(state_to_numpy(state), "")
    return out


def leaf_digests(state) -> dict:
    """``state_digest`` with each leaf's bytes cut to the first 12 hex
    digits of their SHA-256: what ``CAPACITY_PINS`` holds."""
    import hashlib
    return {k: hashlib.sha256(v).hexdigest()[:12]
            for k, v in state_digest(state, None).items()}


def _host(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


SOCKSHOP_COUNTERS = ("spawned", "finished", "dropped_cloudlets",
                     "dropped_requests", "completed", "slo_violations",
                     "migrations", "scale_out", "scale_in", "scale_up",
                     "scale_down")


def sockshop_summary(state) -> dict:
    """A SockShop run's response digest (the sum of the response words)
    and integer counters, of the port's state or the reference's: what
    ``SOCKSHOP_PINS`` holds."""
    resp = _host(state.requests.response).astype(np.float32)
    out = {"resp_digest": int(resp.view(np.uint32).astype(np.uint64).sum()),
           "requests": int(_host(state.requests.count))}
    for k in SOCKSHOP_COUNTERS:
        out[k] = int(_host(getattr(state.counters, k)))
    return out


FSTATS_FLOATS = ("down_time_s", "slow_time_s")


def chaos_summary(state) -> dict:
    """``sockshop_summary`` and every ``FaultStats`` counter (the two
    float sums as their float32 bits): what ``CHAOS_PINS`` holds."""
    out = sockshop_summary(state)
    for k, v in state.fstats._asdict().items():
        v = _host(v)
        out["fstats." + k] = int(v.astype(np.float32).view(np.uint32)) \
            if k in FSTATS_FLOATS else int(v)
    return out


def _digest(data: bytes) -> str:
    import hashlib
    return hashlib.sha256(data).hexdigest()[:12]


def rows_summary(rows) -> dict:
    """Streamed metric rows (dicts of ``TEL_METRIC_COLUMNS``), of the
    port's exporter or the reference's: their number and a digest of
    their float32 words, sorted by tag and window."""
    from repro_torch.core.types import TEL_METRIC_COLUMNS
    a = np.array([[r[n] for n in TEL_METRIC_COLUMNS] for r in rows],
                 np.float32).reshape(-1, len(TEL_METRIC_COLUMNS))
    a = a[np.lexsort((a[:, 0], a[:, 2]))]
    return {"rows": len(a), "rows_digest": _digest(a.tobytes())}


def alerts_summary(rows) -> dict:
    """Alert-transition rows: their number and a digest of them sorted
    by tag, time, service and rule (the times as float32 words)."""
    key = lambda r: (r["tag"], r["time_s"], r["service"], r["rule"])
    text = json.dumps([[float(r["tag"]),
                        int(np.float32(r["time_s"]).view(np.uint32)),
                        int(r["service"]), r["rule"], r["state"]]
                       for r in sorted(rows, key=key)])
    return {"events": len(rows), "events_digest": _digest(text.encode())}


def traces_summary(checks) -> dict:
    """``obs.spans.verify_traces``'s checks, of either package: how many,
    how many are exact, eligible (completed, not failed, retry-free) and
    carry a graph-level Alg 2, and a digest of every check's fields but
    that float32 Alg 2 (the floats as their words)."""
    bits = lambda x: int(np.float32(x).view(np.uint32))
    text = json.dumps([[int(c.req), int(c.api), int(c.n_spans),
                        bool(c.retry_free), bool(c.failed),
                        bits(c.response), bits(c.tree), bits(c.tropical)]
                       for c in checks])
    count = lambda xs: int(sum(bool(x) for x in xs))
    return {"checks": len(checks), "exact": count(c.exact for c in checks),
            "eligible": count(not c.failed and c.retry_free
                              for c in checks),
            "graph": count(c.graph is not None for c in checks),
            "checks_digest": _digest(text.encode())}


def slo_summary(state, events) -> dict:
    """An slo study arm: ``sockshop_summary``, its alert counters and
    its alert-transition rows (``alerts_summary``)."""
    al = state.alerts
    out = sockshop_summary(state)
    for k in ("fires", "resolves", "firing_ticks"):
        out["alerts." + k] = int(_host(getattr(al, k)).sum())
    for k in ("ev_n", "ev_drops", "win"):
        out["alerts." + k] = int(_host(getattr(al, k)).reshape(-1)[0])
    out.update(alerts_summary(events))
    return out


def check_pins(what, got, pins, say=log):
    """Fail on the first key of ``pins`` where ``got`` differs."""
    bad = [k for k in pins if got.get(k) != pins[k]]
    check(not bad, f"{what}: differs from the JAX reference in {bad[:5]} "
          f"({len(bad)} of {len(pins)} pinned values differ)")
    say(f"{what}: all {len(pins)} pinned values equal the JAX reference's")


def conservation(state, n_requests=None):
    """The conservation laws of the reference's engine invariants test,
    and under chaos its chaos law: every spawned cloudlet finished, in
    flight or a counted failed attempt, ``n_exec`` equal to the pool and
    the failed requests counted once."""
    st = state
    cls = st.cloudlets.status.cpu().numpy()
    in_flight = int((cls != 0).sum())
    spawned, finished = int(st.counters.spawned), int(st.counters.finished)
    failed = int(st.fstats.failed_attempts)
    check(spawned == finished + in_flight + failed,
          f"spawned {spawned} != finished {finished} + in flight "
          f"{in_flight} + failed attempts {failed}")
    if st.requests.failed.numel():
        inst = st.cloudlets.inst.cpu().numpy()
        n_exec = st.instances.n_exec.cpu().numpy()
        check((np.bincount(inst[cls == 2], minlength=len(n_exec))
               [:len(n_exec)] == n_exec).all(),
              "instance n_exec counts differ from the executing pool")
        resp = st.requests.response.cpu().numpy()
        fl = st.requests.failed.cpu().numpy()
        check(int(st.fstats.failed_requests)
              == int(((resp >= 0) & (fl > 0)).sum()),
              "failed requests not counted once each")
    n = int(st.requests.count)
    out = st.requests.outstanding.cpu().numpy()[:n]
    check((out >= 0).all() and int(out.sum()) == in_flight,
          "request outstanding counts do not sum to the in-flight pool")
    resp = st.requests.response.cpu().numpy()[:n]
    done = resp >= 0
    check(int(st.counters.completed) == int(done.sum()),
          "completed counter != responses recorded")
    if n_requests is not None:
        check(n == n_requests, f"{n} requests admitted, expected "
              f"{n_requests}")
    out = dict(spawned=spawned, finished=finished, in_flight=in_flight,
               requests=n, completed=int(st.counters.completed))
    if st.requests.failed.numel():
        out.update({k: int(getattr(st.fstats, k)) for k in (
            "host_crashes", "retries", "failed_attempts", "failed_requests",
            "slow_episodes", "partitions", "ejections")})
    return out


class PhaseTimer:
    """Per-phase device time: a CUDA event at each phase boundary."""

    def __init__(self, torch):
        self.torch = torch
        self.marks = []

    def __call__(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def totals(self):
        self.torch.cuda.synchronize()
        tot = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if name != "end":
                tot[name] = tot.get(name, 0.0) + a.elapsed_time(b)
        return tot


def _runner(sim, sweeps, apps=None):
    """``run(state, n, first_tick)``: the solo run, or with ``sweeps`` the
    batched one over those points (and ``apps``)."""
    if sweeps is None:
        return lambda st, n, first: sim.run_state(st, n_ticks=n,
                                                  first_tick=first)
    return lambda st, n, first: sim.run_batch_state(
        st, sweeps, n, first_tick=first, apps=apps)


def sync_calls_per_tick(sim, torch, n_ticks=10, first_tick=0, sweeps=None,
                        apps=None):
    """Synchronising CUDA calls per tick under sync debug mode "warn" over
    ticks ``first_tick`` .. ``first_tick + n_ticks - 1`` replayed from
    the tick's graphs (the capture and the ticks before run unwatched),
    with the port's call sites that made them; with ``sweeps`` (and
    ``apps``), of the batched tick over those points."""
    run = _runner(sim, sweeps, apps)
    state = sim.init_state()
    if first_tick:
        state, _ = run(state, first_tick, 0)
    else:
        run(state, 1, 0)                 # captures; state stays at tick 0
    torch.cuda.synchronize()
    n, counts = op_lint().sync_sites(lambda: run(state, n_ticks,
                                                  first_tick))
    return n / n_ticks, counts


def device_busy(sim, torch, n_ticks=20, sweeps=None, apps=None):
    """Over ``n_ticks`` replayed ticks (the run's own copies in and out
    included): the device busy share, the summed device time
    (torch.profiler) over the window's wall time, None if the profiler saw
    no device time; the ms per tick under the profiler; and the device
    operations (kernels, copies, fills) per tick.  With ``sweeps`` (and
    ``apps``), of the batched tick over those points."""
    from torch.profiler import ProfilerActivity, profile
    run = _runner(sim, sweeps, apps)
    state = sim.init_state()
    state, _ = run(state, 2, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state, n_ticks, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _device_us(prof) / 1e6
    return ((busy / wall if busy > 0 else None), wall / n_ticks * 1e3,
            _device_ops(prof) / n_ticks)


def _device_us_by_name(prof) -> dict:
    """Microseconds of device time in a profile, by kernel name: the self
    time of the device-side events (kernels, copies) only; a CPU
    operator's own ``self_device_time_total`` repeats the time of the
    kernels it launched, so summing over every event counts those
    twice."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        v = getattr(e, "self_device_time_total", None)
        if v is None:
            v = getattr(e, "self_cuda_time_total", 0.0)
        if v > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + v
    return by_name


def traced(fn, symbols, torch, tries=3, keep=None):
    """``fn()`` under torch.profiler (CPU and CUDA activities), again up
    to ``tries`` times while the device trace lacks one of ``symbols``.
    Each session first runs 64 short ``torch.cuda._sleep`` kernels and
    synchronises: a session's first device events can go unrecorded (a
    kernel launched through ctypes first in a session was missing from
    its trace, and late in a full run of this script the jamba prefill's
    one flash launch, some twenty kernels in, was missing from every try
    without the warm-up).  Returns the device microseconds by kernel name,
    the warm-up's ``spin_kernel`` left out, and the traced call's
    wall; the profile itself goes into ``keep``, where given."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = {k: v for k, v in _device_us_by_name(prof).items()
                   if "spin_kernel" not in k}
        if all(any(s in k for k in by_name) for s in symbols):
            break
    if keep is not None:
        keep.append(prof)
    return by_name, wall


def replay_figures(sim, torch, sweeps=None, apps=None, out=None) -> str:
    """``device_busy``'s figures over 20 replayed ticks, as a phrase (and
    into ``out``, where given)."""
    share, ms_tick, ops = device_busy(sim, torch, sweeps=sweeps, apps=apps)
    if out is not None:
        out.update(busy=share, profiled_ms=ms_tick, ops=ops)
    return (f"device busy share "
            f"{'not measured' if share is None else f'{share:.3f}'} over 20 "
            f"replayed ticks ({ms_tick:.3f} ms/tick under the profiler, "
            f"{ops:.1f} device operations per tick)")


def _device_ops(prof) -> int:
    """The device operations (kernels, copies, fills) in a profile."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type != DeviceType.CPU
               and (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0)) > 0)


def _device_us(prof) -> float:
    """Microseconds of device time in a profile (``_device_us_by_name``
    summed)."""
    return sum(_device_us_by_name(prof).values())


def op_lint():
    """``repro_torch.analysis.op_lint``: ``sync_sites`` and
    ``tick_ops_by_site`` live there."""
    from repro_torch.analysis import op_lint as mod
    return mod


def cpu_ops_by_site(tag, scale=0.005):
    """``op_lint.tick_ops_by_site`` of one tick of ``tag`` on the CPU at
    ``scale`` of its size (the kernels' plain versions there, which the
    card runs as one launch each)."""
    from repro_torch.configs import capacity
    sim, _ = capacity.build_tagged(tag, scale=scale, device="cpu")
    return op_lint().tick_ops_by_site(sim)


def new_cell():
    """Drop every captured tick: the capture cache is shared by every
    ``Simulation`` (``Simulation._graphs``), and a cell's peak memory
    holds only its own captures."""
    from repro_torch.core import Simulation
    Simulation.clear_captures()


def obs_counts(state) -> str:
    """A final state's telemetry and alert counters, as a phrase."""
    tel, al = state.telemetry, state.alerts
    first = lambda t: int(_host(t).reshape(-1)[0])
    out = (f"windows {first(tel.win)}, spans {first(tel.span_n)} (dropped "
           f"{first(tel.span_drops)})")
    if al.fires.numel():
        out += (f", alert fires {int(_host(al.fires).sum())} resolves "
                f"{int(_host(al.resolves).sum())} events {first(al.ev_n)} "
                f"(dropped {first(al.ev_drops)})")
    return out


def run_capacity(tag, repeats, torch, dev, launches):
    """One Table 2 case at full size (see the module docstring, phase 3);
    returns its replay figures: the replayed ms per tick of the last run,
    and ``device_busy``'s."""
    new_cell()
    from repro_torch.configs import capacity
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.obs import export, telemetry
    t_build = time.perf_counter()
    sim, meta = capacity.build_tagged(tag, device=dev)
    log(f"{tag}: built in {time.perf_counter() - t_build:.1f} s  {meta}")
    path = ["cloudlet_finish"] + (["link_share"]
                                  if sim.params.network == "fabric" else [])
    obs = sim.params.telemetry == "stream"
    alerting = obs and sim.params.alerting == "burn"
    digests = []
    for rep in range(repeats):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with export.collecting() as rows, export.alert_collecting() as ev:
            res = sim.run()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = {k: counts[k] for k in path}
        check(rep == 0 or res.compile_time_s == 0.0,
              f"{tag}: run {rep + 1} captured the tick anew")
        for k in path:
            launches.setdefault(k, n[k])
            check(n[k] == meta["n_ticks"], f"{tag}: {k} launched {n[k]} "
                  f"times in {meta['n_ticks']} ticks")
        laws = conservation(res.state, meta["n_requests"])
        if sim.params.network == "fabric":
            laws["transits"] = int(res.state.net.transits)
            check(laws["transits"] > 0, f"{tag}: no transfer arrived")
        digests.append(state_digest(res.state, torch))
        fig = dict(ms=res.wall_time_s / meta["n_ticks"] * 1e3)
        log(f"{tag} run {rep + 1}: wall {res.wall_time_s:.3f} s  "
            f"{meta['n_ticks'] / res.wall_time_s:.2f} ticks/s  capture "
            f"{res.compile_time_s:.3f} s  peak memory {peak:.2f} GiB  "
            f"launches {n}  {laws}")
    if repeats > 1:
        bad = [k for k in digests[0] if digests[0][k] != digests[1][k]]
        check(not bad, f"{tag}: the two runs differ in {bad[:5]}")
        log(f"{tag}: the two runs are bit-identical "
            f"({len(digests[0])} leaves)")
    pins = dict(zip(PIN_LEAVES, CAPACITY_PINS[tag].split()))
    check_pins(f"{tag} final state", leaf_digests(res.state), pins)
    if obs:
        # telemetry and alerting observe only: the simulation leaves are
        # the case's without them
        case = tag.partition("+")[0]
        base = dict(zip(PIN_LEAVES, CAPACITY_PINS[case].split()))
        sim_leaves = [k for k in PIN_LEAVES
                      if not k.startswith(("telemetry.", "alerts."))]
        bad = [k for k in sim_leaves if pins[k] != base[k]]
        check(not bad, f"{tag}: simulation leaves pinned unlike {case}'s "
              f"in {bad[:5]}")
        export.validate_rows(rows.rows)
        export.validate_alert_rows(ev.rows)
        check_pins(f"{tag} streamed metric and alert rows",
                   dict(rows_summary(rows.rows), **alerts_summary(ev.rows)),
                   ROW_PINS[tag])
        log(f"{tag}: the {len(sim_leaves)} simulation leaves equal "
            f"{case}'s pins; {len(rows.rows)} metric rows and "
            f"{len(ev.rows)} alert transitions streamed; "
            + obs_counts(res.state))
    # per-phase times over the first 100 ticks of an eager run (the
    # probes keep the tick eager), and the same 100 ticks replayed
    n = 100
    timer = PhaseTimer(torch)
    state = sim.init_state()
    torch.cuda.synchronize()
    eager, eager_tr = sim.run_state(state, n_ticks=n, probe=timer)
    tot = timer.totals()
    log(f"{tag} per-phase CUDA-event ms/tick (eager, ticks 0-{n - 1}): " +
        "  ".join(f"{k} {v / n:.3f}" for k, v in tot.items()))
    if sim.params.faults == "chaos":
        check("Disruption" in tot, f"{tag}: no Disruption phase timed")
    if obs:
        check("Telemetry" in tot and ("Alerting" in tot or not alerting),
              f"{tag}: no Telemetry or Alerting phase timed")
    replayed, replayed_tr = sim.run_state(state, n_ticks=n)
    a, b = state_digest(eager, torch), state_digest(replayed, torch)
    bad = [k for k in a if a[k] != b[k]] + [
        f for f, x, y in zip(eager_tr._fields, eager_tr, replayed_tr)
        if not torch.equal(x, y)]
    check(not bad, f"{tag}: the replayed 100 ticks differ from the eager "
          f"ones in {bad[:5]}")
    log(f"{tag}: 100 replayed ticks equal 100 eager ticks in all {len(a)} "
        f"leaves and {len(eager_tr)} traces")
    # with telemetry on, ten ticks around the first flush of the ring
    first = telemetry.flush_ticks(sim.params) - 5 if obs else 0
    per_tick, sites = sync_calls_per_tick(sim, torch, first_tick=first)
    flushed = telemetry.flush_after(sim.params, first, 10)
    check(bool(flushed) == obs, f"{tag}: the window holds no flush")
    where = f", the ring flushed after tick {first + flushed[0]}" \
        if obs else ""
    log(f"{tag}: synchronising calls per replayed tick {per_tick:.2f} "
        f"(ticks {first}-{first + 9}{where}) {sites}")
    check(per_tick == 0, f"{tag}: {per_tick} synchronising calls per tick")
    log(f"{tag}: {replay_figures(sim, torch, out=fig)}")
    sites = cpu_ops_by_site(tag)
    fig["cpu_ops"] = sum(sites.values())
    log(f"{tag}: {sum(sites.values())} operations a tick by call site "
        "(the port's tick on the CPU at 1/200 of the size; plain kernels "
        "there): " + ", ".join(f"{k} {v}" for k, v in sites.most_common()))
    return fig


SOCKSHOP_CASES = ((100, 600.0, 1), (300, 600.0, 0), (300, 180.0, 1))


def run_sockshop(launches):
    """Paper §6.3: the testbed comparisons at 100 and 300 clients over
    600 s, and a 300-client run with HS over 180 s that must scale out,
    one after another (each has the card to itself)."""
    for case in SOCKSHOP_CASES:
        lines, n_trop = sockshop_run(*case)
        for line in lines:
            log(line)
        launches.setdefault("tropical_closure", n_trop)


def sockshop_run(n_clients, duration, policy):
    """One SockShop run; returns its log lines and the
    ``tropical_closure`` launches of its Alg 2 call.  The HS run ends with
    the synchronising calls per tick over a window that holds a scaling
    tick."""
    new_cell()
    import torch
    from repro_torch.configs import sockshop
    dev = torch.device("cuda")
    lines = []
    sim = sockshop.make_sim(n_clients, duration, scaling_policy=policy,
                            device=dev)
    rep, n_trop = run_sockshop_case(
        sim, n_clients, torch, dev, testbed=duration == 600.0,
        pins=SOCKSHOP_PINS[f"{n_clients}/{duration:.0f}/{policy}"],
        say=lines.append)
    if policy and n_clients == 300:
        check(rep.scale_out > 0, f"sockshop {n_clients} HS over "
              f"{duration:.0f} s never scaled out")
        si = int(sim.params.scale_interval)
        per_tick, sites = sync_calls_per_tick(sim, torch, n_ticks=20,
                                              first_tick=si - 10)
        lines.append(f"sockshop {n_clients} HS: synchronising calls per "
                     f"tick {per_tick:.2f} (ticks {si - 10}-{si + 9}, "
                     f"scaling tick {si - 1}) {sites}")
    return lines, n_trop


FABRIC_LOADS = (10, 50, 100)


def run_sockshop_fabric(launches):
    """``examples/network_saturation.py``'s sweep: SockShop's 10 nodes at
    8 Mbit/s NICs with spread placement, 10, 50 and 100 clients over
    120 s, one after another.  The transit p95 must rise with the
    load."""
    results = [sockshop_fabric_run(n) for n in FABRIC_LOADS]
    p95 = []
    for lines, n_link, rep_p95, _ in results:
        for line in lines:
            log(line)
        p95.append(rep_p95)
    log("sockshop fabric: transit p95 ms by load "
        f"{dict(zip(FABRIC_LOADS, p95))}")
    check(all(b >= a for a, b in zip(p95, p95[1:])) and p95[-1] > p95[0],
          f"sockshop fabric: transit p95 {p95} does not rise with the load")
    return {n: r[3] for n, r in zip(FABRIC_LOADS, results)}


def sockshop_fabric_run(n_clients):
    """One fabric SockShop run; returns its log lines, its ``link_share``
    launches, its transit p95 and its final state's and traces' bits."""
    new_cell()
    import dataclasses
    import torch
    from repro_torch.configs import sockshop
    from repro_torch.core import policies, qos
    from repro_torch.kernels import counts, reset_counts
    dev = torch.device("cuda")
    # one client pool sized for the largest load, as the example's sweep
    sim = sockshop.make_sim(max(FABRIC_LOADS), 120.0, network="fabric",
                            nic_egress_mbps=8.0, nic_ingress_mbps=8.0,
                            placement_policy=policies.PLACE_SPREAD,
                            device=dev)
    sim.params = dataclasses.replace(sim.params, n_clients=n_clients,
                                     spawn_rate=n_clients / 10.0)
    T = sim.params.n_ticks
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = sim.run()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = dict(counts)
    tag = f"sockshop fabric {n_clients} clients"
    for k in ("cloudlet_finish", "link_share"):
        check(n[k] == T, f"{tag}: {k} launched {n[k]} times in {T} ticks")
    laws = conservation(res.state)
    rep = qos.summarize(sim, res)
    check(rep.net_transits > 0 and math.isfinite(rep.transit_p95_ms)
          and rep.completed_requests > 0, f"{tag}: no transits/responses")
    check(float(res.state.net.bytes_out.sum()) > 0,
          f"{tag}: no cross-host hop")
    resp = res.state.requests.response.cpu().numpy()
    digest = int(resp.view(np.uint32).astype(np.uint64).sum())
    line = (f"{tag}: {T} ticks  wall {res.wall_time_s:.2f} s  "
            f"{T / res.wall_time_s:.1f} ticks/s  capture "
            f"{res.compile_time_s:.3f} s  launches "
            f"{dict((k, n[k]) for k in ('cloudlet_finish', 'link_share'))}"
            f"  transits {rep.net_transits}  transit p50 "
            f"{rep.transit_p50_ms:.1f} ms p95 {rep.transit_p95_ms:.1f} ms  "
            f"ingress util {rep.avg_ingress_util:.4f}  avg response "
            f"{rep.avg_response_ms:.1f} ms  response digest {digest}  {laws}")
    return ([line, f"{tag}: peak memory {peak:.2f} GiB; "
             f"{replay_figures(sim, torch)}"],
            n["link_share"], rep.transit_p95_ms, run_bits(res, torch))


def run_sockshop_case(sim, n_clients, torch, dev, testbed, pins, say=log):
    """Run ``sim`` in 10 s windows, check it (its response digest and
    integer counters against the reference's ``pins``), and hold Alg 2
    through the closure kernel (one launch, no product) over its
    per-window node delays against the DP critical path.  Returns the QoS
    report and the ``tropical_closure`` launches."""
    from repro_torch import random as rnd
    from repro_torch.configs import sockshop
    from repro_torch.core import qos
    from repro_torch.core.engine import carry_path
    from repro_torch.core.critical_path import (critical_path,
                                                response_times_batched)
    from repro_torch.core.engine import SimResult
    from repro_torch.core.types import TickTrace
    from repro_torch.kernels import counts, reset_counts
    window_ticks = 100                   # 10 s windows at dt = 0.1 s
    tag = (f"sockshop {n_clients} clients "
           f"{'HS' if sim.params.scaling_policy else 'NS'}")
    state = sim.init_state()
    T = sim.params.n_ticks
    snaps, traces = [], []
    prev_d = torch.zeros_like(state.svc_stats.delay_sum)
    prev_n = torch.zeros_like(state.svc_stats.finished)
    compile_s = sim.compile(state)
    # the host's key schedule for the whole run, as the windows build it
    keys = sim.captured(state).loop.keys
    t0 = time.perf_counter()
    roots, _ = rnd.chain(state.rng, T, carry_path(sim.params))
    t1 = time.perf_counter()
    keys.derive(roots)
    t2 = time.perf_counter()
    say(f"{tag}: key schedule of {T} ticks on the host: the root chain "
        f"{(t1 - t0) * 1e3:.1f} ms, {len(keys.columns)} streams "
        f"{(t2 - t1) * 1e3:.1f} ms")
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for w0 in range(0, T, window_ticks):
        state, tr = sim.run_state(state, min(window_ticks, T - w0),
                                  first_tick=w0)
        traces.append(tr)
        d, n = state.svc_stats.delay_sum, state.svc_stats.finished
        snaps.append((d - prev_d) / torch.clamp_min(
            (n - prev_n).float(), 1.0))
        prev_d, prev_n = d, n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_fin = counts["cloudlet_finish"]
    check(n_fin == T, f"{tag}: cloudlet_finish launched {n_fin} times in "
          f"{T} ticks")
    trace = TickTrace(*[torch.cat(f) for f in zip(*traces)])
    res = SimResult(state=state, trace=trace, wall_time_s=wall,
                    compile_time_s=compile_s)
    laws = conservation(state)
    rep = qos.summarize(sim, res)
    check(math.isfinite(rep.avg_response_ms) and rep.avg_response_ms > 0
          and rep.completed_requests > 0, f"{tag}: no finite responses")
    digest = sockshop_summary(state)["resp_digest"]
    vs = ""
    if testbed:
        ref_ms = sockshop.TESTBED_MS[n_clients]
        vs = (f" vs testbed {ref_ms:.0f} ms "
              f"({100 * (rep.avg_response_ms / ref_ms - 1):+.1f}%)")
    say(f"{tag}: {T} ticks  wall {wall:.2f} s  {T / wall:.1f} ticks/s  "
        f"capture {compile_s:.3f} s  cloudlet_finish launches {n_fin}  "
        f"avg response "
        f"{rep.avg_response_ms:.1f} ms{vs}  p95 {rep.p95_response_ms:.1f} "
        f"ms  scale_out {rep.scale_out}  scale_in {rep.scale_in}  "
        f"response digest {digest}  {laws}")
    check_pins(f"{tag} response digest and counters",
               sockshop_summary(state), pins, say)
    say(f"{tag}: peak memory {peak:.2f} GiB; {replay_figures(sim, torch)}")
    # Alg 2 over the per-window node delays, through the closure kernel
    delays = torch.stack(snaps).cpu().numpy().astype(np.float32)
    reset_counts()
    rt = response_times_batched(sim.graph, delays, device=dev)
    n_trop = counts["tropical_closure"]
    check(n_trop == 1 and counts["tropical_matmul"] == 0,
          f"{tag}: Alg 2 launched tropical_closure {n_trop} times and "
          f"tropical_matmul {counts['tropical_matmul']} times, not 1 and 0")
    check(rt.shape == (delays.shape[0], sim.graph.n_apis)
          and np.isfinite(rt).all(), "Alg 2 output malformed")
    for b in range(delays.shape[0]):
        for api in range(sim.graph.n_apis):
            want, _ = critical_path(sim.graph, delays[b], api)
            check(np.isclose(rt[b, api], want, rtol=1e-5),
                  f"Alg 2 window {b} api {api}: {rt[b, api]} != DP {want}")
    mean_rt = rt.mean(axis=0) * 1000.0
    say(f"{tag}: Alg 2 over {delays.shape[0]} windows ({n_trop} "
        "tropical_closure launch) agrees with the DP critical path; mean critical-path ms "
        "per API: " + ", ".join(f"{a} {v:.1f}" for a, v in
                                zip(sim.graph.api_names, mean_rt)))
    return rep, n_trop


def run_bits(res, torch) -> dict:
    """A run's final state and traces as bytes, leaf by leaf: what two
    runs must share to be the same run."""
    out = state_digest(res.state, torch)
    for f, v in res.trace._asdict().items():
        out["trace." + f] = v.cpu().numpy().tobytes()
    return out


def same_run(what, a, b):
    bad = [k for k in a if a[k] != b.get(k)]
    check(a.keys() == b.keys() and not bad,
          f"{what}: differ in {bad[:5]} ({len(bad)} of {len(a)} leaves)")


def run_sweep8(launches):
    """``benchmarks/bench_scaling.py``'s ``sweep8_demo`` at full width:
    SockShop, HS, ``FIG11_KNOBS``, 8 loads from 200 to 1100 clients over
    600 s (6,000 ticks) as one ``run_batch``: one replayed batched tick a
    tick.  Against a solo replayed run at the largest load: the wall, the
    reference's two ratios, the device operations a tick (below 2x the
    solo tick's), 0 synchronising calls a replayed batched tick over a
    scaling tick, one ``cloudlet_finish`` launch a tick, every point's
    response digest and counters against the JAX reference's ``run_batch``
    (``SWEEP_PINS``), points 0 and 7 equal to their solo runs on the card,
    and 100 replayed batched ticks equal to the eager ones."""
    new_cell()
    import dataclasses
    import torch
    from repro_torch.configs import sockshop
    from repro_torch.core import batch_item, policies, qos
    from repro_torch.kernels import counts, reset_counts
    dev = torch.device("cuda")
    loads = SWEEP8_LOADS
    B = len(loads)
    sim = sockshop.make_sim(n_clients=max(loads), duration_s=600.0,
                            scaling_policy=policies.SCALE_HORIZONTAL,
                            device=dev, **FIG11_KNOBS)
    base = sim.params
    T = base.n_ticks
    sweeps = [dataclasses.replace(base, n_clients=int(nc),
                                  spawn_rate=float(nc) / 30.0)
              for nc in loads]
    check(sweeps[-1] == base, "sweep8: the largest load is not the solo run")
    tag = "sweep8"
    # the solo run at the largest load: captured, then replayed
    solo = [sim.run(), sim.run()]
    check(solo[1].compile_time_s == 0.0, f"{tag}: solo run captured anew")
    solo_wall = min(r.wall_time_s for r in solo)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = sim.run_batch(sweeps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = dict(counts)
    check(n["cloudlet_finish"] == T, f"{tag}: cloudlet_finish launched "
          f"{n['cloudlet_finish']} times in {T} batched ticks")
    wall = res.wall_time_s
    log(f"{tag}: {B} points x {T} ticks as one run_batch  wall {wall:.3f} s"
        f"  {T / wall:.2f} ticks/s  {B * T / wall:.1f} point-ticks/s  "
        f"{wall / T * 1e3:.3f} ms per batched tick  capture "
        f"{res.compile_time_s:.3f} s  peak memory {peak:.2f} GiB  "
        f"cloudlet_finish launches {n['cloudlet_finish']}")
    log(f"{tag}: solo replayed run at {max(loads)} clients {solo_wall:.3f} s"
        f" ({T / solo_wall:.2f} ticks/s, capture "
        f"{solo[0].compile_time_s:.3f} s);  batch_over_solo "
        f"{wall / solo_wall:.3f}  batch_over_sequential "
        f"{wall / (B * solo_wall):.3f}  ({gpu_line()})")
    rows = []
    for b, nc in enumerate(loads):
        item = batch_item(res, b)
        got = sockshop_summary(item.state)
        if SWEEP_PINS:
            check_pins(f"{tag} point {b} ({nc} clients) response digest and "
                       "counters", got, SWEEP_PINS[b])
        rep = qos.summarize(sim, item, params=sweeps[b])
        rows.append(f"{nc}: avg {rep.avg_response_ms:.1f} ms p95 "
                    f"{rep.p95_response_ms:.1f} ms, {rep.avg_milicores:.1f} "
                    f"mc/inst, scale_out {rep.scale_out}, completed "
                    f"{rep.completed_requests}")
    check(bool(SWEEP_PINS), f"{tag}: no SWEEP_PINS to hold the points to")
    log(f"{tag} per point: " + "; ".join(rows))
    # points 0 and 7 against their own solo runs on the card
    same_run(f"{tag} point {B - 1} against its solo run",
             run_bits(batch_item(res, B - 1), torch), run_bits(solo[1],
                                                               torch))
    sim.params = sweeps[0]
    solo0 = sim.run()
    sim.params = base
    same_run(f"{tag} point 0 against its solo run",
             run_bits(batch_item(res, 0), torch), run_bits(solo0, torch))
    log(f"{tag}: points 0 and {B - 1} equal their solo runs on the card in "
        f"every leaf and trace")
    # the batched tick against the solo one, over 20 replayed ticks
    share_b, ms_b, ops_b = device_busy(sim, torch, sweeps=sweeps)
    share_s, ms_s, ops_s = device_busy(sim, torch)
    fmt = lambda x: "not measured" if x is None else f"{x:.3f}"
    log(f"{tag}: 20 replayed ticks: batched {ops_b:.1f} device operations a"
        f" tick, busy share {fmt(share_b)}, {ms_b:.3f} ms/tick under the "
        f"profiler; solo {ops_s:.1f}, {fmt(share_s)}, {ms_s:.3f} ms/tick;"
        f" ratio of operations {ops_b / ops_s:.3f}")
    check(ops_b < 2 * ops_s, f"{tag}: {ops_b:.1f} device operations a "
          f"batched tick, at least twice the solo tick's {ops_s:.1f}")
    si = int(base.scale_interval)
    per_tick, sites = sync_calls_per_tick(sim, torch, n_ticks=20,
                                          first_tick=si - 10, sweeps=sweeps)
    log(f"{tag}: synchronising calls per replayed batched tick "
        f"{per_tick:.2f} (ticks {si - 10}-{si + 9}, scaling tick "
        f"{si - 1}) {sites}")
    check(per_tick == 0, f"{tag}: {per_tick} synchronising calls per tick")
    # 100 batched ticks eager (per-phase times) and replayed
    timer = PhaseTimer(torch)
    state = sim.init_state()
    torch.cuda.synchronize()
    eager = sim.run_batch_state(state, sweeps, 100, probe=timer)
    tot = timer.totals()
    log(f"{tag} per-phase CUDA-event ms per batched tick (eager, ticks "
        "0-99): " + "  ".join(f"{k} {v / 100:.3f}" for k, v in tot.items()))
    replayed = sim.run_batch_state(state, sweeps, 100)
    a = run_bits(_result(*eager), torch)
    same_run(f"{tag}: 100 replayed batched ticks against the eager ones", a,
             run_bits(_result(*replayed), torch))
    log(f"{tag}: 100 replayed batched ticks equal the eager ones in all "
        f"{len(a)} leaves and traces")


def _result(state, trace):
    from repro_torch.core.engine import SimResult
    return SimResult(state=state, trace=trace, wall_time_s=0.0,
                     compile_time_s=0.0)


def run_chaos_study(launches):
    """``examples/chaos_study.py``'s sweep as the example runs it
    (``CHAOS_STUDY``): radii 1, 2 and 5 x ejection off and on, 6 points,
    as one ``run_batch(apps=)`` whose points differ in ``host_zone``.
    Every point's response digest, integer counters and ``FaultStats``
    against the JAX reference's ``run_batch`` (``CHAOS_PINS``), one
    ``cloudlet_finish`` launch a batched tick, 0 synchronising calls a
    replayed batched tick, and the study's table."""
    new_cell()
    import dataclasses
    import torch
    from repro_torch.configs import sockshop
    from repro_torch.core import batch_item, policies, qos
    from repro_torch.kernels import counts, reset_counts
    dev = torch.device("cuda")
    tag = "chaos study"
    sim = sockshop.make_sim(placement_policy=policies.PLACE_SPREAD,
                            host_zone=study_zones(CHAOS_RADII[0]),
                            device=dev, **CHAOS_STUDY)
    points, apps, labels = [], [], []
    for r in CHAOS_RADII:
        app_r = sim.app._replace(host_zone=torch.as_tensor(
            study_zones(r), device=dev))
        for thresh in CHAOS_EJECT:
            points.append(dataclasses.replace(sim.params,
                                              eject_err_thresh=thresh))
            apps.append(app_r)
            labels.append((r, thresh < 1.0))
    T = sim.params.n_ticks
    torch.cuda.synchronize()
    reset_counts()
    res = sim.run_batch(points, apps=apps)
    n = counts["cloudlet_finish"]
    check(n == T, f"{tag}: cloudlet_finish launched {n} times in {T} "
          "batched ticks")
    check(len(CHAOS_PINS) == len(points), f"{tag}: no CHAOS_PINS to hold "
          "the points to")
    rows = []
    for b, ((r, ej), p) in enumerate(zip(labels, points)):
        item = batch_item(res, b)
        conservation(item.state)
        check_pins(f"{tag} point {b} (radius {r}, ejection "
                   f"{'on' if ej else 'off'}) response digest, counters and "
                   "FaultStats", chaos_summary(item.state), CHAOS_PINS[b])
        rep = qos.summarize(sim, item, params=p)
        rows.append(f"radius {r} eject {'on' if ej else 'off'}: avail "
                    f"{rep.availability:.3f} err {rep.error_rate:.3f} "
                    f"failed {rep.failed_requests} slow_eps "
                    f"{rep.slow_episodes} ejects {rep.ejections} readmit "
                    f"{rep.readmissions} trips {rep.breaker_trips} p95 "
                    f"{rep.p95_response_ms:.0f} ms")
    log(f"{tag}: {len(points)} points x {T} ticks as one run_batch(apps=)  "
        f"wall {res.wall_time_s:.3f} s  {T / res.wall_time_s:.1f} ticks/s  "
        f"capture {res.compile_time_s:.3f} s  cloudlet_finish launches {n}"
        f"  ({gpu_line()})")
    log(f"{tag} table: " + "; ".join(rows))
    per_tick, sites = sync_calls_per_tick(sim, torch, sweeps=points,
                                          apps=apps)
    log(f"{tag}: synchronising calls per replayed batched tick "
        f"{per_tick:.2f} (first 10 ticks) {sites}; "
        f"{replay_figures(sim, torch, points, apps)}")
    check(per_tick == 0, f"{tag}: {per_tick} synchronising calls per tick")


def run_obs(figs, torch, dev, launches):
    """The observability phase (see the module docstring, phase 7)."""
    for tag in OBS_CASES:
        figs[tag] = run_capacity(tag, 2, torch, dev, launches)
    overhead(figs, OBS_CASES)
    run_obs_profile(torch, dev)
    run_sockshop_traces(torch, dev, launches)
    run_slo_study(torch, dev)


def run_obs_profile(torch, dev):
    """``obs.profile.phase_breakdown`` of case1b+slo over 50 eager ticks
    (CUDA events at the phase probes), as a table."""
    new_cell()
    from repro_torch.configs import capacity
    from repro_torch.obs import profile
    sim, _ = capacity.build_tagged("case1b+slo", device=dev)
    costs = profile.phase_breakdown(sim, reps=1, n_ticks=50)
    labels = [c.label for c in costs]
    check(labels == profile.tick_phases(sim) + ["Trace+rest"]
          and "Alerting" in labels, f"case1b+slo profile labels {labels}")
    check(all(math.isfinite(c.delta_s) and c.delta_s >= 0 for c in costs),
          "case1b+slo profile: a phase's time is not finite")
    log("case1b+slo phase_breakdown over 50 eager ticks (CUDA events, "
        f"{gpu_line()}):\n" + profile.format_table(costs, "tick phase"))


def run_sockshop_traces(torch, dev, launches):
    """SockShop, 100 clients with HS over 600 s, with
    ``examples/telemetry_study.py``'s telemetry (``TEL_KW``): the run
    equal to the telemetry-free one's pins (``SOCKSHOP_PINS``), its
    streamed rows and ``verify_traces`` on the card equal to the JAX
    reference's (``TRACE_PINS``), every completed, not failed, retry-free
    trace exact, and each graph-level Alg 2 one ``tropical_closure``
    launch."""
    new_cell()
    from repro_torch.configs import sockshop
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.obs import export, spans
    tag = "sockshop 100 clients HS with telemetry"
    sim = sockshop.make_sim(100, 600.0, scaling_policy=1, device=dev,
                            **TEL_KW)
    T = sim.params.n_ticks
    torch.cuda.synchronize()
    reset_counts()
    with export.collecting() as rows:
        res = sim.run()
    n = counts["cloudlet_finish"]
    check(n == T, f"{tag}: cloudlet_finish launched {n} times in {T} ticks")
    check_pins(f"{tag}: response digest and counters",
               sockshop_summary(res.state), SOCKSHOP_PINS["100/600/1"])
    export.validate_rows(rows.rows)
    reset_counts()
    t0 = time.perf_counter()
    checks = spans.verify_traces(res.state, sim.graph,
                                 int(sim.app.succ.shape[1]))
    t_verify = time.perf_counter() - t0
    n_trop = counts["tropical_closure"]
    got = dict(rows_summary(rows.rows), **traces_summary(checks))
    check_pins(f"{tag}: streamed rows and trace checks", got, TRACE_PINS)
    check(got["eligible"] > 0 and got["exact"] == got["eligible"],
          f"{tag}: {got['eligible'] - got['exact']} of {got['eligible']} "
          "eligible traces are not exact")
    check(n_trop == got["graph"] > 0 and counts["tropical_matmul"] == 0,
          f"{tag}: {n_trop} tropical_closure launches for {got['graph']} "
          "graph-level Alg 2 checks")
    err = max(abs(float(c.graph) / float(c.response) - 1.0)
              for c in checks if c.graph is not None)
    launches["tropical_closure"] = launches.get("tropical_closure", 0) \
        + n_trop
    log(f"{tag}: {T} ticks  wall {res.wall_time_s:.2f} s  capture "
        f"{res.compile_time_s:.3f} s  {got['rows']} rows  "
        f"{obs_counts(res.state)};  verify_traces {t_verify:.2f} s: "
        f"{got['checks']} traces, {got['exact']} of {got['eligible']} "
        f"eligible exact, {got['graph']} graph-level Alg 2 through "
        f"{n_trop} tropical_closure launches (largest relative gap to the "
        f"response {err:.2e})  ({gpu_line()})")


def run_slo_study(torch, dev):
    """``examples/slo_study.py`` at its defaults (``SLO_STUDY``): its two
    arms as one ``run_batch``, each point's counters, alert counters and
    alert rows equal to the JAX reference's (``SLO_PINS``), the burn arm's
    SLO violation rate below the util arm's at no more replica-seconds,
    as the example asserts, 0 synchronising calls a replayed batched tick
    over a tick that flushes the ring and scales, and the wall."""
    new_cell()
    import dataclasses
    from repro_torch.configs import sockshop
    from repro_torch.core import batch_item, policies, qos
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.obs import export
    tag = "slo study"
    sim = sockshop.make_sim(placement_policy=policies.PLACE_SPREAD,
                            host_zone=slo_zones(), device=dev, **SLO_STUDY)
    points = [dataclasses.replace(sim.params, **arm) for _, arm in SLO_ARMS]
    T = sim.params.n_ticks
    torch.cuda.synchronize()
    reset_counts()
    with export.alert_collecting() as events, export.collecting() as rows:
        res = sim.run_batch(points)
    n = counts["cloudlet_finish"]
    check(n == T, f"{tag}: cloudlet_finish launched {n} times in {T} "
          "batched ticks")
    export.validate_alert_rows(events.rows)
    export.validate_rows(rows.rows)
    check(len(SLO_PINS) == len(points), f"{tag}: no SLO_PINS")
    table, rates, cost = [], [], []
    for b, ((name, _), p) in enumerate(zip(SLO_ARMS, points)):
        item = batch_item(res, b)
        mine = [r for r in events.rows if int(r["tag"]) == b]
        check_pins(f"{tag} arm {name}: counters, alert counters and alert "
                   "rows", slo_summary(item.state, mine), SLO_PINS[b])
        rep = qos.summarize(sim, item, params=p)
        rs = float(_host(item.trace.active_instances).astype(
            np.float64).sum()) * p.dt
        rates.append(rep.slo_violation_rate)
        cost.append(rs)
        table.append(f"{name}: violation rate {rep.slo_violation_rate:.3f}"
                     f" replica-s {rs:.0f} out {rep.scale_out} in "
                     f"{rep.scale_in} fires {rep.alert_fires} firing "
                     f"{rep.alert_firing_time_s:.1f} s ejections "
                     f"{rep.ejections} p95 {rep.p95_response_ms:.0f} ms")
    check(rates[1] < rates[0] and cost[1] <= cost[0] * 1.001,
          f"{tag}: the burn arm (violation rate {rates[1]:.3f}, "
          f"{cost[1]:.0f} replica-s) does not beat the util arm "
          f"({rates[0]:.3f}, {cost[0]:.0f})")
    log(f"{tag}: {len(points)} arms x {T} ticks as one run_batch  wall "
        f"{res.wall_time_s:.3f} s  {T / res.wall_time_s:.1f} ticks/s  "
        f"capture {res.compile_time_s:.3f} s  cloudlet_finish launches {n}"
        f"  ({gpu_line()})")
    log(f"{tag} table: " + "; ".join(table))
    first = 95                  # ticks 95-104: tick 99 flushes and scales
    per_tick, sites = sync_calls_per_tick(sim, torch, first_tick=first,
                                          sweeps=points)
    log(f"{tag}: synchronising calls per replayed batched tick "
        f"{per_tick:.2f} (ticks {first}-{first + 9}) {sites}; "
        f"{replay_figures(sim, torch, points)}")
    check(per_tick == 0, f"{tag}: {per_tick} synchronising calls per tick")


def slo_zones() -> np.ndarray:
    """The slo study's failure domains: 5 zones of 2 hosts."""
    return (np.arange(CHAOS_HOSTS) // 2).astype(np.int32)


FABRIC_SWEEP = (10, 25, 50, 100)


def run_fabric_sweep(solo_bits):
    """``examples/network_saturation.py``'s sweep as the example runs it:
    one ``run_batch`` over 10, 25, 50 and 100 clients (8 Mbit/s NICs,
    spread placement, 120 s): one ``link_share`` launch a tick, the points
    at 10, 50 and 100 clients equal to phase 7's solo runs in every leaf
    and trace, the transit p95 rising with the load."""
    new_cell()
    import dataclasses
    import torch
    from repro_torch.configs import sockshop
    from repro_torch.core import batch_item, policies, qos
    from repro_torch.kernels import counts, reset_counts
    dev = torch.device("cuda")
    sim = sockshop.make_sim(max(FABRIC_SWEEP), 120.0, network="fabric",
                            nic_egress_mbps=8.0, nic_ingress_mbps=8.0,
                            placement_policy=policies.PLACE_SPREAD,
                            device=dev)
    sweeps = [dataclasses.replace(sim.params, n_clients=nc,
                                  spawn_rate=nc / 10.0)
              for nc in FABRIC_SWEEP]
    T = sim.params.n_ticks
    tag = "sockshop fabric sweep"
    torch.cuda.synchronize()
    reset_counts()
    res = sim.run_batch(sweeps)
    n = {k: counts[k] for k in ("cloudlet_finish", "link_share")}
    for k, v in n.items():
        check(v == T, f"{tag}: {k} launched {v} times in {T} batched ticks")
    p95 = []
    for b, nc in enumerate(FABRIC_SWEEP):
        item = batch_item(res, b)
        p95.append(qos.summarize(sim, item, params=sweeps[b]).transit_p95_ms)
        if nc in solo_bits:
            same_run(f"{tag}: the point at {nc} clients against its solo "
                     "run", run_bits(item, torch), solo_bits[nc])
    log(f"{tag}: {len(FABRIC_SWEEP)} points x {T} ticks as one run_batch  "
        f"wall {res.wall_time_s:.3f} s  {T / res.wall_time_s:.1f} ticks/s  "
        f"capture {res.compile_time_s:.3f} s  launches {n}  transit p95 ms "
        f"by load {dict(zip(FABRIC_SWEEP, p95))}; the points at "
        f"{sorted(solo_bits)} clients equal their solo runs; "
        f"{replay_figures(sim, torch, sweeps)}")
    check(all(b >= a for a, b in zip(p95, p95[1:])) and p95[-1] > p95[0],
          f"{tag}: transit p95 {p95} does not rise with the load")


SIMCHECK_CASES = (("case1b", ("uniform", "none", False, False)),
                  ("case1b+net+chaos2", ("fabric", "chaos", False, False)))


def run_simcheck(figs, torch, dev):
    """The simcheck phase (see the module docstring, phase 10): the five
    sections of ``python -m repro_torch.analysis`` on the card, the lint
    and the layout replay at full size, case1b in checked mode, and two
    SockShop runs on fresh ``Simulation``s sharing one capture."""
    from repro_torch.analysis import layout_check, simcheck
    from repro_torch.configs import capacity, sockshop
    t_phase = time.perf_counter()
    new_cell()
    t0 = time.perf_counter()
    rep = simcheck.run_simcheck(device=dev)
    for sec, probs in rep.sections.items():
        log(f"simcheck {sec}: "
            + ("clean" if not probs else f"{len(probs)} violation(s)"))
    for combo, digest in rep.stream_digests.items():
        log(f"simcheck stream topology {combo}: {digest}")
    sen = rep.sentinel
    log(f"simcheck sentinel: captures warm {sen.warm.captures} counting "
        f"{sen.counting.captures}, kernel builds warm {sen.warm.builds} "
        f"counting {sen.counting.builds}; the five sections in "
        f"{time.perf_counter() - t0:.1f} s")
    check(rep.ok, f"simcheck on the card: {rep.problems[:5]}")
    check(sen.counting.captures == 0 and sen.counting.builds == 0,
          "simcheck: the sentinel's counting pass captured or built")
    # the shardability audit: the card's report is the CPU's (the kernel
    # wrappers count as their plain versions' ops on both), every op and
    # site included
    t0 = time.perf_counter()
    on_card, _ = simcheck.check_shardability(device=dev)
    t_card = time.perf_counter() - t0
    on_cpu, _ = simcheck.check_shardability(device="cpu")
    for combo, r in on_card.items():
        c = on_cpu[combo]
        if r.to_json() != c.to_json() or r.entries != c.entries:
            check(False, f"shardability {combo}: the card's report differs "
                  f"from the CPU's: {r.summary()} against {c.summary()}; "
                  "ops (phase, op, site) on one side only: "
                  + shard_diff(*combo.split("+"), dev))
        log(f"simcheck shardability {r.summary()}, equal to the CPU's")
    log(f"simcheck shardability: the four golden combos on the card in "
        f"{t_card:.1f} s, clean against the committed baseline "
        f"({gpu_line()})")
    for tag, combo in SIMCHECK_CASES:
        new_cell()
        sim, _ = capacity.build_tagged(tag, device=dev)
        t0 = time.perf_counter()
        problems, ops = op_lint().lint_sim(sim)
        check(not problems, f"{tag}: op lint at full size: {problems[:5]}")
        bad = layout_check.replay_problems(layout_check.replay_sim(sim),
                                           *combo)
        check(not bad, f"{tag}: layout at full size: {bad[:5]}")
        sites = op_lint().tick_ops_by_site(sim)
        log(f"{tag}: op lint ({len(ops)} operations recorded) and "
            f"layout replay clean at full size in "
            f"{time.perf_counter() - t0:.1f} s; {sum(sites.values())} "
            "operations a tick by call site (one eager tick on the card): "
            + ", ".join(f"{k} {v}" for k, v in sites.most_common()))
    # case1b under REPRO_CHECKED=1: the same leaves, no synchronising call
    # inside the replayed loop (the run reads its error word once after)
    new_cell()
    os.environ["REPRO_CHECKED"] = "1"
    try:
        sim, meta = capacity.build_tagged("case1b", device=dev)
        res = sim.run()
        pins = dict(zip(PIN_LEAVES, CAPACITY_PINS["case1b"].split()))
        check_pins("case1b checked final state", leaf_digests(res.state),
                   pins)
        state = sim.init_state()
        n, sites = op_lint().sync_sites(lambda: sim.run_state(state, 10))
        reads = sum(v for k, v in sites.items() if "annotate.py" in k)
        check(reads == 1 and n == reads, f"case1b checked: {n} "
              f"synchronising calls in 10 replayed ticks: {sites}")
        ms = res.wall_time_s / meta["n_ticks"] * 1e3
        log(f"case1b checked: every leaf equals CAPACITY_PINS; replayed "
            f"{ms:.3f} ms/tick checked against {figs['case1b']['ms']:.3f} "
            f"unchecked ({ms / figs['case1b']['ms']:.3f}x), capture "
            f"{res.compile_time_s:.3f} s; synchronising calls per replayed "
            f"checked tick {(n - reads) / 10:.2f} (ticks 0-9; the error "
            f"word's one read after the loop apart) ({gpu_line()})")
    finally:
        del os.environ["REPRO_CHECKED"]
    # two fresh Simulations of one structure: the second replays the
    # first's capture
    new_cell()
    captures = []
    for i in range(2):
        sim = sockshop.make_sim(100, 600.0, scaling_policy=1, device=dev)
        res = sim.run()
        check_pins(f"sockshop 100 HS, Simulation {i + 1}",
                   sockshop_summary(res.state), SOCKSHOP_PINS["100/600/1"])
        captures.append(res.compile_time_s)
        log(f"sockshop 100 HS, Simulation {i + 1}: capture "
            f"{res.compile_time_s:.3f} s, wall {res.wall_time_s:.3f} s")
    check(captures[1] == 0.0, "sockshop 100 HS: the second Simulation "
          f"captured anew ({captures[1]:.3f} s)")
    new_cell()
    log(f"simcheck phase: {time.perf_counter() - t_phase:.1f} s "
        f"({gpu_line()})")


def shard_diff(network, faults, dev) -> str:
    """The ops of the shardability audit's tick recorded on one device
    only, (phase, op, site) with their counts, card then CPU."""
    import collections
    from repro_torch.analysis import shardability
    key = lambda o: (o.phase, o.name, o.site)
    got = {d: collections.Counter(map(key, shardability.record_tick(
        shardability._audit_sim(network, faults, d)))) for d in (dev, "cpu")}
    return (f"card {dict(got[dev] - got['cpu'])}, "
            f"CPU {dict(got['cpu'] - got[dev])}")


FLEET = dict(services=1024, max_calls=4, apis=4, windows=8, seed=23)


def fleet_graph(services, max_calls, apis, seed):
    """A seeded service DAG at fleet scale: each service calls up to
    ``max_calls`` higher-numbered services, and ``apis`` APIs enter at
    services drawn from the first 64."""
    from repro_torch.core import build_graph
    g = np.random.default_rng(seed)
    names = [f"s{i}" for i in range(services)]
    calls = {}
    for i in range(services - 1):
        n = min(int(g.integers(0, max_calls + 1)), services - 1 - i)
        if n:
            calls[names[i]] = [names[j] for j in sorted(
                g.choice(np.arange(i + 1, services), n, replace=False))]
    entries = sorted(g.choice(min(64, services), apis, replace=False))
    return build_graph(names, calls,
                       [(f"api{k}", names[e], 1.0)
                        for k, e in enumerate(entries)],
                       {nm: 100.0 for nm in names}), g


def run_fleet_alg2(torch, dev, launches):
    """Alg 2 at fleet scale: ``response_times_batched`` over a seeded
    1024-service DAG's delays in 8 windows, through the product kernel
    (⌈log₂ depth⌉ launches), held against the DP critical path for every
    window and API."""
    from repro_torch.core.critical_path import (critical_path,
                                                response_times_batched)
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.kernels.tropical import ops
    graph, g = fleet_graph(FLEET["services"], FLEET["max_calls"],
                           FLEET["apis"], FLEET["seed"])
    S, B = graph.n_services, FLEET["windows"]
    delays = g.uniform(0.5, 5.0, (B, S)).astype(np.float32)
    check(ops.closure_route(S) == ops.PRODUCTS,
          f"fleet Alg 2: S={S} is not on the product route")
    response_times_batched(graph, delays[:1], device=dev)       # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rt = response_times_batched(graph, delays, device=dev)
    wall = time.perf_counter() - t0
    n = dict(counts)
    n_sq = ops.squarings(S, graph.depth)
    launches.setdefault("tropical_matmul", n["tropical_matmul"])
    check(n["tropical_matmul"] == n_sq and n["tropical_closure"] == 0,
          f"fleet Alg 2: tropical_matmul launched {n['tropical_matmul']} "
          f"times (depth {graph.depth}: {n_sq}), tropical_closure "
          f"{n['tropical_closure']}")
    check(rt.shape == (B, graph.n_apis) and np.isfinite(rt).all(),
          "fleet Alg 2: output malformed")
    for b in range(B):
        for api in range(graph.n_apis):
            want, _ = critical_path(graph, delays[b], api)
            check(np.isclose(rt[b, api], want, rtol=1e-5),
                  f"fleet Alg 2 window {b} api {api}: {rt[b, api]} != DP "
                  f"{want}")
    log(f"fleet Alg 2: {S} services, depth {graph.depth}, {graph.n_apis} "
        f"APIs, {B} windows  {n['tropical_matmul']} tropical_matmul "
        f"launches  wall {wall:.4f} s (the host's adjacency and copies "
        f"included)  every (window, API) equal to the DP critical path; "
        f"mean critical path {rt.mean():.3f}")


# ---------------------------------------------------------------------------
# phases 9-10: the model zoo's serving path
# ---------------------------------------------------------------------------

def prefill_len() -> int:
    """``prefill_32k``'s sequence length."""
    from repro_torch.configs import SHAPES
    return next(s.seq_len for s in SHAPES if s.name == "prefill_32k")


def mrope_positions(T):
    """``[3, 1, T]`` int32 M-RoPE positions of a prompt that holds an
    image: T/32 text tokens (t = h = w), a square grid of about T/8
    patches (t held at the image's start, h and w counting its rows and
    columns from there, as Qwen2-VL numbers them; 64 x 64 at T = 32,768),
    then text again from one past the image's largest position."""
    text = T // 32
    h = w = math.isqrt(T // 8)
    pos = np.zeros((3, T), np.int32)
    pos[:, :text] = np.arange(text)
    n_img = min(h * w, T - text)
    r, c = np.divmod(np.arange(n_img), w)
    pos[0, text:text + n_img] = text
    pos[1, text:text + n_img] = text + r
    pos[2, text:text + n_img] = text + c
    pos[:, text + n_img:] = text + max(h, w) + np.arange(T - text - n_img)
    return pos[:, None]


def prefill_batch(cfg, T, torch, dev, seed):
    """The prefill program's inputs for one sequence of T tokens, from
    ``seed``: ``tokens`` (and for encdec ``frames`` [1, n_frames, d]), or
    for vlm ``embeds`` [1, T, d] and ``positions`` [3, 1, T] whose rows
    differ (``mrope_positions``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if cfg.family == "vlm":
        return {"embeds": torch.randn((1, T, cfg.d_model), generator=g,
                                      device=dev).to(torch.bfloat16),
                "positions": torch.from_numpy(mrope_positions(T)).to(dev)}
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, T), generator=g,
                                     device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((1, cfg.n_frames, cfg.d_model),
                                      generator=g, device=dev) \
            .to(torch.bfloat16)
    return batch


def mixer_launches(cfg) -> dict:
    """Launches of the mixers' kernels in one prefill, and the kernel
    symbol each must show in the device trace: one a layer (flash, or the
    SSD kernel for ssm), for encdec one an encoder layer and two (self,
    cross) a decoder layer, for the hybrid one flash and attn_period - 1
    SSD launches a period (the SSD kernel ``ops.route`` names: jamba's
    head width 128 on ``ssd_chunk_sm90``)."""
    if cfg.family == "ssm":
        return {"ssd_chunk": (cfg.n_layers, "ssd_chunk_sm90")}
    if cfg.family == "hybrid":
        periods = cfg.n_layers // cfg.attn_period
        from repro_torch.kernels.ssd_scan import ops
        dims = cfg.mamba
        symbol = ("ssd_chunk_sm90" if ops.route(
            cfg.ssd_chunk, dims.d_state, dims.headdim) == ops.TENSOR_CORES
            else "ssd_chunk_kernel")
        return {"flash_attention": (periods, "flash_fwd_sm90"),
                "ssd_chunk": (periods * (cfg.attn_period - 1), symbol)}
    n = cfg.n_layers
    if cfg.family == "encdec":
        n = cfg.n_enc_layers + 2 * cfg.n_layers
    return {"flash_attention": (n, "flash_fwd_sm90")}


def served_cfg(arch):
    """The config an arch is prefilled and served with: its own, cut to
    ``SERVE_DEPTH``'s layers where that names it."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    return cfg


def served_tag(arch):
    if arch not in SERVE_DEPTH:
        return arch
    from repro_torch.configs import get_config
    return (f"{arch} ({SERVE_DEPTH[arch]} of "
            f"{get_config(arch).n_layers} layers)")


def jamba_period():
    """jamba-1.5-large at full width, cut to one period (8 of its 72
    layers) and ``JAMBA_EXPERTS`` of its 16 experts (top-2 kept): 32.4
    GB of bf16 weights at 4 experts (51.6 at 8, which one card also
    holds beside a 32,768-token prefill; 16 experts would be 90 GB)."""
    from repro_torch.configs import get_config
    cfg = get_config(JAMBA)
    return dataclasses.replace(
        cfg, n_layers=cfg.attn_period,
        moe=dataclasses.replace(cfg.moe, n_experts=JAMBA_EXPERTS))


def run_prefill(arch, torch, dev, launches, cfg=None):
    """``serve.prefill_step`` at full width and depth (``cfg``, where
    given, in place of the arch's: the jamba period), at
    ``prefill_32k``'s sequence length with its batch of 32 cut to 1, on
    seeded random weights: finite logits, the mixer kernels' launches
    (``mixer_launches``), the time of one prefill, and where its device
    time goes (torch.profiler over a second one)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch.serve import prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.common import n_params as n_params_of
    T = prefill_len()
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    want = mixer_launches(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    n_params = n_params_of(model.schema())
    batch = prefill_batch(cfg, T, torch, dev, 1)
    prefill_step(model, params, batch)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = prefill_step(model, params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: counts[k] for k in want}
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    check(got == {k: v[0] for k, v in want.items()},
          f"{arch} prefill: kernel launches {got}, not {want}")
    check(tuple(out.shape) == (1, 1, cfg.vocab) and out.dtype ==
          torch.float32 and bool(torch.isfinite(out).all()),
          f"{arch} prefill: logits {tuple(out.shape)} {out.dtype} not "
          "finite or malformed")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_name, wall_p = traced(lambda: prefill_step(model, params, batch),
                             [sym for _, sym in want.values()], torch)
    busy = sum(by_name.values()) / 1e6
    check(busy > 0, f"{arch} prefill: the profiler recorded no device time")
    for _, symbol in want.values():
        check(any(symbol in k for k in by_name),
              f"{arch} prefill: no {symbol} kernel in the device trace "
              f"(its {len(by_name)} kernels: "
              + "; ".join(k[:50] for k in sorted(by_name)) + ")")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    dev_s = lambda sym: sum(v for k, v in by_name.items() if sym in k) / 1e6
    log(f"{arch} prefill_step: {n_params / 1e6:.1f} M parameters, "
        f"{cfg.n_layers} layers"
        + (f" (+{cfg.n_enc_layers} encoder layers over {cfg.n_frames} "
           "frames)" if cfg.family == "encdec" else "")
        + (f" ({cfg.moe.n_experts} experts)" if cfg.moe else "")
        + f", T={T} B=1  wall {wall:.3f} s "
        f"({T / wall:.0f} tok/s)  launches {got}  peak "
        f"memory {peak:.2f} GiB  logits |max| "
        f"{float(out.abs().max()):.4f}")
    # the busy share divides by the unprofiled prefill's wall: the
    # profiler's own host cost stretches the profiled run's wall
    log(f"{arch} prefill device time {busy:.3f} s (profiled run, "
        f"{wall_p:.3f} s wall); busy share {busy / wall:.3f} of the "
        f"unprofiled {wall:.3f} s wall; "
        + "; ".join(f"{sym} {dev_s(sym):.3f} s" for _, sym in want.values())
        + "; top kernels: "
        + "; ".join(f"{k[:60]} {v / 1e6:.3f} s" for k, v in top))
    del params, out, batch
    torch.cuda.empty_cache()


class routing_record:
    """Within the block, each call of the LM's or the hybrid's
    ``moe_apply`` appends its tokens' top-K experts (in the router's
    order, on the host) to ``self.chosen`` and their sets (sorted) to
    ``self.sets``."""

    def __enter__(self):
        from repro_torch.models import hybrid, transformer
        from repro_torch.models.moe import route
        self.sets, self.chosen, self.mods = [], [], (transformer, hybrid)
        self.inner = transformer.moe_apply

        def recorded(p, x, cfg):
            top_e = route(p, x.reshape(-1, x.shape[-1]), cfg)[1].cpu()
            self.chosen.append(top_e)
            self.sets.append(top_e.sort(dim=-1).values)
            return self.inner(p, x, cfg)
        for mod in self.mods:
            mod.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.moe_apply = self.inner


class given_routing:
    """Within the block the MoE layers route, call by call, to the
    experts of ``chosen`` (one ``[n, K]`` tensor a call, in call order:
    another run's ``routing_record.chosen``), each weighted by this run's
    own router probability, as ``moe.route`` weights its choices."""

    def __init__(self, chosen):
        self.chosen, self.calls = chosen, 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.moe, self.inner = moe, moe.route

        def given(p, xf, cfg):
            top_e = self.chosen[self.calls].to(xf.device)
            self.calls += 1
            probs = torch.softmax(xf.float() @ p["router"], dim=-1)
            top_p = torch.gather(probs, 1, top_e)
            if cfg.norm_topk:
                top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
            return top_p, top_e
        moe.route = given
        return self

    def __exit__(self, *exc):
        self.moe.route = self.inner


def routing_agreement(a, b):
    """The share of (token, k) routing choices of one run (``a``, a list of
    ``[n, K]`` expert sets a layer) that the other run (``b``) also made."""
    same = total = 0
    for x, y in zip(a, b):
        hit = (x[:, :, None] == y[:, None, :]).any(-1)
        same += int(hit.sum())
        total += hit.numel()
    return same, total


# The CPU halves of the 2-layer checks (prefill logits, train steps) run
# in a child process (``CPU_SIDE_FLAG``) from the end of the builds on,
# beside the simulator's phases, on CPU_SIDE_THREADS of the host's cores
# at the lowest priority;
# the checks then take its results from files.  Its first act draws every
# check's weights on the card and copies them to the host (the 2-layer
# weights are drawn on the card: the CPU's generator takes seconds a GB),
# so it holds no card memory by the time the big training runs start.
CPU_SIDE_THREADS = 6
# the files it may hold at once: it waits for the checks to take some
# before it writes past this many bytes
CPU_SIDE_BYTES = 24 << 30


def cpu_jobs():
    """The CPU halves in the order the checks take them: (kind, arch,
    keyword arguments with their defaults filled in)."""
    jobs = [("prefill", a, dict(kw, T=kw.get("T", 300)))
            for a, kw in TWO_LAYER_CASES]
    train = ((TRAIN_ARCH, {}), (SSM_TRAIN_ARCH, {})) + TRAIN_TWO_LAYER
    jobs += [("train", a, dict(kw, T=kw.get("T", 256), B=kw.get("B", 2)))
             for a, kw in train]
    return jobs


def _job_file(out_dir, kind, arch, kw):
    import hashlib
    key = repr((kind, arch, sorted(kw.items())))
    return os.path.join(out_dir, hashlib.sha1(key.encode()).hexdigest()[:16]
                        + ".pt")


class CpuSide:
    """The child process of the CPU halves: ``start()`` spawns it,
    ``result(kind, arch, **kw)`` waits for one job's file and takes it
    (the file is removed), ``stop()`` ends the child and removes its
    directory."""

    def __init__(self):
        self.proc = self.dir = None

    def start(self):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
        self.log = open(os.path.join(self.dir, "child.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), CPU_SIDE_FLAG,
             self.dir], stdout=self.log, stderr=subprocess.STDOUT)

    def result(self, kind, arch, **kw):
        import torch
        path = _job_file(self.dir, kind, arch, kw)
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                with open(os.path.join(self.dir, "child.log")) as f:
                    tail = f.read()[-3000:]
                check(False, "the CPU-side process ended (exit code "
                      f"{self.proc.returncode}) without {kind} {arch} "
                      f"{kw}:\n" + tail)
            time.sleep(0.2)
        out = torch.load(path, weights_only=False)
        os.remove(path)
        return out

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        if self.proc is not None:
            self.proc.wait()
            self.log.close()
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
        self.proc = self.dir = None


CPU_SIDE = CpuSide()


def cpu_side_main(out_dir) -> int:
    """The child process: every job of ``cpu_jobs`` in order, each result
    saved (through a temporary name) for ``CpuSide.result``."""
    import gc
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_to
    from repro_torch.tree import tree_leaves
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    os.nice(19)
    torch.set_num_threads(CPU_SIDE_THREADS)
    dev = torch.device("cuda")
    try:
        weights = []
        for kind, arch, kw in cpu_jobs():
            cfg = two_layer_cfg(arch, **{k: v for k, v in kw.items()
                                         if k not in ("T", "B")})
            weights.append(tree_to(two_layer_params(
                build_model(cfg), 2 if kind == "prefill" else 4, torch,
                dev), "cpu"))
            torch.cuda.empty_cache()
        for (kind, arch, kw), i in zip(cpu_jobs(), range(len(weights))):
            t0 = time.perf_counter()
            fn = two_layer_cpu if kind == "prefill" else train_two_layer_cpu
            params, weights[i] = weights[i], None
            res = fn(arch, params, torch, **kw)
            res["seconds"] = time.perf_counter() - t0
            del params
            size = sum(t.numel() * t.element_size()
                       for t in tree_leaves(res.get("grads", {})))
            while sum(os.path.getsize(os.path.join(out_dir, f))
                      for f in os.listdir(out_dir) if f.endswith(".pt")) \
                    + size > CPU_SIDE_BYTES:
                time.sleep(0.5)
            path = _job_file(out_dir, kind, arch, kw)
            torch.save(res, path + ".part")
            os.replace(path + ".part", path)
            del res
            gc.collect()
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def two_layer_cfg(arch, n_experts=None, **over):
    """``arch``'s config cut to 2 layers, with ``over``'s fields and its
    MoE layers cut to ``n_experts`` experts, where given."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=2, **over)
    if n_experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=n_experts))
    return cfg


def two_layer_params(model, seed, torch, dev):
    """The 2-layer checks' weights: drawn on the card (the CPU's
    generator takes seconds a GB) from ``seed``; both sides of a check
    draw them alike."""
    return model.init_params(torch.Generator(device=dev).manual_seed(seed),
                             dev)


def two_layer_cpu(arch, params, torch, T=300, **kw):
    """The CPU side of ``check_two_layer`` (``cpu_side_main`` runs it) on
    the check's weights copied to the CPU: the prefill logits and the
    routing records."""
    from repro_torch.launch.serve import prefill_step
    from repro_torch.models import build_model
    cfg = two_layer_cfg(arch, **kw)
    model = build_model(cfg)
    batch = prefill_batch(cfg, T, torch, torch.device("cpu"), 3)
    with routing_record() as rec:
        want = prefill_step(model, params, batch)
    return {"want": want, "sets": rec.sets}


def check_two_layer(arch, torch, dev, T=300, **kw):
    """A 2-layer model at the architecture's full width (``kw``: other
    fields of its config, ``n_experts``): the card's prefill logits
    (through the kernels) against the CPU's (``two_layer_cpu``, computed
    by the CPU-side process); for the moe family also the share of
    routing choices the two make alike; at ``attn_impl="flat"`` the card's
    logits bit-equal to the same model's ``"grouped"`` logits on the card
    (the kernel's arithmetic for one query head does not depend on
    Hkv)."""
    import gc
    from repro_torch.launch.serve import prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_to
    cfg = two_layer_cfg(arch, **kw)
    model = build_model(cfg)
    t0 = time.perf_counter()
    on_card = two_layer_params(model, 2, torch, dev)
    batch = tree_to(prefill_batch(cfg, T, torch, torch.device("cpu"), 3),
                    dev)
    with routing_record() as card_rec:
        got = prefill_step(model, on_card, batch)
    cpu = CPU_SIDE.result("prefill", arch, T=T, **kw)
    want = cpu["want"]
    err = float((got.cpu() - want).abs().max())
    routed = ""
    if cfg.moe is not None:
        same, total = routing_agreement(card_rec.sets, cpu["sets"])
        routed = (f"; routing choices alike on card and CPU {same} of "
                  f"{total} ({same / total:.5f})")
    if cfg.attn_impl != "grouped":
        grouped = prefill_step(build_model(dataclasses.replace(
            cfg, attn_impl="grouped")), on_card, batch)
        check(torch.equal(got, grouped), f"{arch} 2-layer: attn_impl "
              f"{cfg.attn_impl!r} logits differ from 'grouped' on the card "
              f"by {float((got - grouped).abs().max())}")
        routed += (f"; attn_impl {cfg.attn_impl!r} bit-equal to 'grouped' "
                   "on the card")
    what = "".join(f" {k}={v}" for k, v in kw.items())
    log(f"{arch} 2-layer{what} full width, T={T}: card logits against CPU "
        f"logits max|err| {err:.4g} (|logits| max "
        f"{float(want.abs().max()):.3f}, tolerance {MODEL_TOL}){routed}  "
        f"(card {time.perf_counter() - t0:.1f} s, CPU "
        f"{cpu['seconds']:.1f} s in the CPU-side process)")
    check(err <= MODEL_TOL, f"{arch} 2-layer: card logits differ from the "
          f"CPU's by {err}{routed}")
    del on_card, got, batch
    gc.collect()
    torch.cuda.empty_cache()


QTOL = 1e-2       # int8 against bf16 cache: next-token probabilities


def check_int8_tracks_bf16(tag, model, params, dev, torch, steps=8):
    """``tests/test_quant_kv.py``'s rule on the card: the int8 cache's
    next-token probabilities within ``QTOL`` of the bf16 cache's each
    step, the bf16 argmax kept where it leads by more than 2·QTOL and
    near-maximal elsewhere (same weights, same tokens)."""
    from repro_torch.models import build_model
    bf16 = build_model(dataclasses.replace(model.cfg, kv_dtype="bf16"))
    st = bf16.init_decode_state(4, 64, device=dev)
    st_q = model.init_decode_state(4, 64, device=dev)
    tok = torch.randint(0, model.cfg.vocab, (4, steps), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(4))
    worst, n_decisive = 0.0, 0
    for t in range(steps):
        a = torch.softmax(bf16.decode_step(params, tok[:, t:t + 1], st)[0]
                          [:, 0], -1).cpu().numpy()
        b = torch.softmax(model.decode_step(params, tok[:, t:t + 1], st_q)[0]
                          [:, 0], -1).cpu().numpy()
        worst = max(worst, float(np.abs(a - b).max()))
        srt = np.sort(a, axis=-1)
        for i in range(a.shape[0]):
            if srt[i, -1] - srt[i, -2] > 2 * QTOL:
                n_decisive += 1
                check(a[i].argmax() == b[i].argmax(), f"{tag}: step {t} "
                      f"slot {i}: the int8 cache changed a decisive argmax")
            else:
                check(b[i, a[i].argmax()] >= b[i].max() - 2 * QTOL,
                      f"{tag}: step {t} slot {i}: the bf16 winner is not "
                      "near-maximal under the int8 cache")
    check(worst < QTOL, f"{tag}: next-token probabilities {worst} apart "
          f"from the bf16 cache's (tolerance {QTOL})")
    log(f"{tag}: {steps} steps, next-token probabilities within {worst:.3g} "
        f"of the bf16 cache's (tolerance {QTOL}); {n_decisive} decisive "
        "argmaxes kept")


def run_serve(arch, torch, dev, cfg=None, tag=None):
    """``serve.main`` with its defaults (8 requests, 4 slots, 16 + 24
    tokens) on the card, which replays the decode graph (``cfg``, where
    given, in place of the arch's: its int8 KV cache, the jamba period;
    ``tag`` names it in the log); then the graph
    against the eager ``decode_step`` (logits bit-equal over 8 steps),
    its device time per step and the synchronising calls per replayed
    step; for the int8 cache, its probabilities against the bf16
    cache's (``check_int8_tracks_bf16``)."""
    import contextlib
    import gc
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from torch.profiler import ProfilerActivity, profile
    cfg = cfg or get_config(arch)
    arch = tag or arch
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(buf):
        outputs = serve.main(["--arch", cfg.name], cfg=cfg)
    for line in buf.getvalue().splitlines():
        log(f"{arch} serve: {line}")
    log(f"{arch} serve: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    # serve.main's weights and graph are garbage now: one model's weights
    # on the card at a time
    gc.collect()
    torch.cuda.empty_cache()
    check(len(outputs) == 8 and all(len(o) == 24 for o in outputs)
          and all(0 <= t < cfg.vocab for o in outputs for t in o),
          f"{arch} serve: malformed outputs")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    graph = serve.DecodeGraph(model, params, 4, 64, dev)
    state = model.init_decode_state(4, 64, device=dev)
    tok = torch.randint(0, cfg.vocab, (4, 8), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    for t in range(8):
        want, state = model.decode_step(params, tok[:, t:t + 1], state)
        got = graph.step(tok[:, t:t + 1])
        check(torch.equal(got, want), f"{arch} decode graph: step {t}'s "
              "logits differ from the eager decode_step's")
    log(f"{arch} decode graph: captured in {graph.compile_time_s:.3f} s; "
        "8 replayed steps' logits bit-equal to the eager decode_step's")
    if cfg.kv_dtype == "int8":
        check_int8_tracks_bf16(f"{arch} decode", model, params, dev, torch)
    box = [tok[:, :1]]

    def steps(n):
        for _ in range(n):
            logits = graph.step(box[0])
            box[0] = torch.argmax(logits[:, 0], dim=-1)[:, None]
    graph.reset()
    steps(2)
    torch.cuda.synchronize()
    n_steps = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _device_us(prof) / 1e6
    top = sorted(_device_us_by_name(prof).items(),
                 key=lambda kv: -kv[1])[:4]
    log(f"{arch} decode graph: {wall / n_steps * 1e3:.3f} ms/step under "
        f"the profiler, device {busy / n_steps * 1e3:.3f} ms/step, busy "
        f"share {busy / wall:.3f}, {_device_ops(prof) / n_steps:.1f} device "
        f"operations per step; top kernels a step: "
        + "; ".join(f"{k[:60]} {v / n_steps / 1e3:.3f} ms" for k, v in top))
    graph.reset()
    steps(2)
    torch.cuda.synchronize()
    n_steps = 8
    n, sites = op_lint().sync_sites(lambda: steps(n_steps))
    log(f"{arch} decode: synchronising calls per replayed step "
        f"{n / n_steps:.2f} ({n_steps} steps) {sites}")
    check(n == 0, f"{arch} decode: {n} synchronising calls in {n_steps} "
          "steps")
    del params, state, box, graph, want, got
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: training (the dense family)
# ---------------------------------------------------------------------------

# the backward kernel against autograd through the plain version: each
# output element within rtol·|plain| + frac·max|plain| (float32: the sums in
# another order; bfloat16: the outputs' own bf16 rounding, 2^-8, and
# Δ = Σ dO·O from the forward's bf16 output, whose rounding reaches dS
# where dP - Δ cancels)
BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -6, 2.0 ** -7)}
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEQ, TRAIN_BATCH = 4096, 2       # train_4k's T; its batch 256 cut to 2
TRAIN_STEPS = 3                        # step 0 warms up; 1-2 are timed
# 2-layer full-width train step, card against CPU (bf16 weights: the
# activations and the bf16 gradients round at other places): the loss
# within TRAIN_LOSS_TOL, the global norm within TRAIN_NORM_RTOL of its
# value, each gradient leaf within TRAIN_GRAD_TOL of its own max |grad|
TRAIN_LOSS_TOL = 1e-2
TRAIN_NORM_RTOL = 2e-2
TRAIN_GRAD_TOL = 2.0 ** -4


def check_flash_bwd(tag, B, Hq, Hkv, Tq, Tk, D, dtype, causal, torch, dev,
                    n_time=0):
    """The backward kernels of ``ops.route_bwd``'s pair (bf16 at D 64 or
    128: ``flash_bwd_dq_sm90``, ``flash_bwd_dkdv_sm90``; float32 and bf16
    at 16 or 32: ``flash_bwd_dq``, ``flash_bwd_dkdv``) against
    ``ref.attention_bwd`` on the same inputs; with ``n_time``, their time
    beside the plain version's, the SDPA backward's at the same shape (the
    yardstick, never on the path) and the bound."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attention import ops, ref
    dt = getattr(torch, dtype)
    kernels = ("flash_bwd_dq_sm90 + flash_bwd_dkdv_sm90"
               if ops.route_bwd(dt, D) == ops.TENSOR_CORES
               else "flash_bwd_dq + flash_bwd_dkdv")
    g = torch.Generator(device=dev).manual_seed(29)
    mk = lambda H, n: torch.randn((B, H, n, D), generator=g, device=dev) \
        .to(dt)
    q, k, v, dout = mk(Hq, Tq), mk(Hkv, Tk), mk(Hkv, Tk), mk(Hq, Tq)
    saved = dict(counts)
    out, lse = ops.launch(q, k, v, causal, None, with_lse=True)
    a = ops.launch_bwd(q, k, v, out, dout, lse, causal, None)
    b = ops.launch_bwd(q, k, v, out, dout, lse, causal, None)
    want = ref.attention_bwd(q, k, v, dout, causal=causal)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"flash_attention_bwd {tag}: two launches differ")
    rtol, frac = BWD_TOL[dtype]
    errs = []
    for name, x, w in zip(("dq", "dk", "dv"), a, want):
        check(x.dtype == w.dtype and bool(torch.isfinite(x).all()),
              f"flash_attention_bwd {tag}: {name} not finite or mistyped")
        scale = float(w.float().abs().max())
        diff = (x.float() - w.float()).abs()
        excess = float((diff - rtol * w.float().abs()).max())
        errs.append(float(diff.max()))
        check(excess <= frac * scale, f"flash_attention_bwd {tag}: {name} "
              f"max|err| {errs[-1]}, an element off by {excess} beyond "
              f"{rtol}·|plain| (tolerance {frac}·{scale:.4g})")
    lse_err = float((lse - ref.logsumexp(q, k, causal=causal)).abs().max())
    check(lse_err <= 1e-4, f"flash_attention {tag}: log-sum-exp off by "
          f"{lse_err}")
    line = (f"flash_attention_bwd {tag} ({kernels}): B={B} Hq={Hq} "
            f"Hkv={Hkv} Tq={Tq} Tk={Tk} D={D} "
            f"{'causal' if causal else 'non-causal'} {dtype}"
            f"  max|err| dq {errs[0]:.3g} dk {errs[1]:.3g} dv "
            f"{errs[2]:.3g}  lse max|err| {lse_err:.3g}")
    res = dict(max_abs_err=max(errs))
    if n_time:
        k_ev, k_dev = cuda_ms(lambda: ops.launch_bwd(
            q, k, v, out, dout, lse, causal, None), n_time, torch)
        p_ev, p_dev = cuda_ms(lambda: ref.attention_bwd(
            q, k, v, dout, causal=causal), 1, torch)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        lib = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, enable_gqa=True)
        l_ev, l_dev = cuda_ms(lambda: torch.autograd.grad(
            lib, (qs, ks, vs), dout, retain_graph=True), 5, torch)
        del lib, qs, ks, vs
        # the least work: the five products of the backward (S again,
        # dP = dO·Vᵀ, dS·K, dSᵀ·Q, Pᵀ·dO) over the visible pairs, 2
        # operations a multiply-add, at the peak of the inputs' type;
        # bytes: q, k, v, o, dO and lse read once, dq, dk, dv written once
        pairs = Tq * (Tq + 1) // 2 + Tq * (Tk - Tq) if causal else Tq * Tk
        ops_n = 10.0 * B * Hq * pairs * D
        peak = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
        esz = 2 if dtype == "bfloat16" else 4
        nbytes = esz * B * D * (6 * Hq * Tq + 4 * Hkv * Tk) + 4 * B * Hq * Tq
        bound_ms, by = max((ops_n / peak * 1e3, "operations"),
                           (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        k_ms = k_dev or k_ev
        lib_ms = l_dev or l_ev
        line += (f"  kernel {_ms(k_dev)} ms device / {k_ev:.4f} ms per call"
                 f"  {ops_n / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s  "
                 f"{bound_ms / k_ms:.4f} of the bound  {k_ms / lib_ms:.2f}x "
                 f"the SDPA backward  plain {_ms(p_dev)} ms device / "
                 f"{p_ev:.4f} ms per call  SDPA backward {_ms(lib_ms)} ms  "
                 f"bound {bound_ms:.4f} ms ({by})")
        res.update(ms=k_ms, plain_ms=p_dev or p_ev, bound_ms=bound_ms,
                   bound_by=by, library_ms=lib_ms)
    counts.update(saved)
    log(line)
    del q, k, v, dout, out, lse, a, b, want
    torch.cuda.empty_cache()
    return res


BWD_KERNELS = ("flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90", "flash_bwd_dq",
               "flash_bwd_dkdv")
# the SSD backward's kernels: the tensor-core three, then the CUDA-core
# pair
SSD_BWD_SM90 = ("ssd_bwd_ds", "ssd_bwd_dx", "ssd_bwd_db")
SSD_BWD_KERNELS = SSD_BWD_SM90 + ("ssd_bwd_heads", "ssd_bwd_groups")
# mamba2-130m at train_4k's T = 4,096, the batch of 256 cut to 8 (one
# card: the float32 logits alone are 6.6 GB)
SSM_TRAIN_ARCH = "mamba2-130m"
SSM_TRAIN_BATCH = 8
# the moe, vlm, encdec and hybrid families at train_4k's T = 4,096, full
# width, cut to one card (PERF.md §4): (arch, batch, config fields
# replaced, the batches: "main" is launch.train.main's SyntheticLM tokens,
# "batch_for" data.batch_for's (bf16 frames, bf16 embeds and [3, B, T]
# positions) through make_train_step, as the driver would feed them).
# A step holds 12 bytes a parameter (a bf16 weight and gradient, two
# float32 moments: the update writes in place, as launch.train's does)
# beside the float32 logits, their log-softmax and gradient, and the
# float32 unembedding and its gradient.  whisper-base: its batch of 256
# cut to 8 (the float32 logits [8, 4096, 51865] are 6.8 GB); the deepest
# cuts that fit, from measured peaks on an H100 80GB (14 layers of
# qwen2-vl-7b 59.37 GiB, 6 of qwen2-moe-a2.7b 56.89, the jamba period at 4
# experts 61.04 and 5 experts 70.04; 18 layers of qwen2-vl-7b did not
# fit): qwen2-vl-7b 16 of 28 layers (4.82 B parameters), qwen2-moe-a2.7b 8
# of 24 (5.18 B), the jamba period cut to attention + SwiGLU, Mamba + MoE
# with 5 of its 16 experts, top-2 kept (5.27 B; a period of 8 layers
# holds 6.6 B parameters without its experts, 79 GB of state).  Since the
# dist phase and the dry run joined the run, half those cuts for time:
# qwen2-vl-7b 8 layers, qwen2-moe-a2.7b 4, the jamba period 3 experts
JAMBA_TRAIN_EXPERTS = 3
TRAIN_FAMILIES = (
    ("whisper-base", 8, {}, "batch_for"),
    ("qwen2-vl-7b", 1, dict(n_layers=8), "batch_for"),
    ("qwen2-moe-a2.7b", 1, dict(n_layers=4), "main"),
    (JAMBA, 1, dict(n_layers=2, attn_period=2), "main"),
)
# 2-layer full-width train steps of the families, card against CPU (arch,
# keyword arguments of check_train_two_layer): whisper with 2 encoder
# layers over its 1,500 frames; qwen3-moe-30b-a3b for its qk-norm,
# norm_topk and GQA group 8, which no full run reaches; jamba at period 2
# with 2 experts (top-2: its routing cannot differ), T 256 (two chunks:
# the SSD carry crosses one in both directions)
TRAIN_TWO_LAYER = (
    ("whisper-base", dict(n_enc_layers=2)),
    ("qwen2-vl-7b", dict(B=1)),
    ("qwen2-moe-a2.7b", dict(B=1)),
    ("qwen3-moe-30b-a3b", dict(B=1)),
    (JAMBA, dict(B=1, attn_period=2, n_experts=2)),
)
# above this many bytes of parameters and moments, two runs' states are
# compared through ``train_digest`` (the state does not fit twice)
EXACT_STATE_BYTES = 24 << 30


def check_ssd_bwd(tag, M, K, L, P, N, group, torch, dev, n_time=0):
    """The SSD backward kernels (``csrc/ssd_chunk_bwd.cu``) against
    autograd through the plain version (``ref.ssd_chunk_bwd``) on the
    same inputs and output gradients, each output within ``SSD_BWD_TOL``
    of its own max |value|, two launches bit-identical; the route and, on
    the tensor cores, the heads a block; with ``n_time``, their time
    beside the plain version's and the bound (no PyTorch call computes
    the SSD backward)."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.ssd_scan import ops, ref
    G = M // group
    if ops.route_bwd(L, N, P) == ops.TENSOR_CORES:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        hpb = ops.heads_per_block(K, G, group, sms, P // 64)
        route = (f"{' + '.join(SSD_BWD_SM90)}, {hpb} heads a block, "
                 f"{-(-group // hpb)} slices a B/C row")
    else:
        route = " + ".join(SSD_BWD_KERNELS[len(SSD_BWD_SM90):])
    g = torch.Generator(device=dev).manual_seed(31)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    dt = r(M, K, L, 1) * 0.25 + 0.05
    args = (n(M, K, L, P), dt, dt * -(r(M, 1, 1, 1) * 15.0 + 1.0),
            n(G, K, L, N) / N ** 0.5, n(G, K, L, N) / N ** 0.5)
    grads = (n(M, K, L, P), n(M, K, N, P), n(M, K, L, 1), n(M, K, 1, 1))
    saved = dict(counts)
    a = ops.launch_bwd(*args, *grads, group)
    b = ops.launch_bwd(*args, *grads, group)
    want = ref.ssd_chunk_bwd(*args, *grads, group=group)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"ssd_chunk_bwd {tag}: two launches differ")
    errs, rels = [], []
    for name, x, w in zip(("dx", "ddt", "dla", "db", "dc"), a, want):
        check(bool(torch.isfinite(x).all()),
              f"ssd_chunk_bwd {tag}: {name} not finite")
        errs.append(float((x - w).abs().max()))
        rels.append(errs[-1] / float(w.abs().max()))
        check(rels[-1] <= SSD_BWD_TOL, f"ssd_chunk_bwd {tag}: {name} off by "
              f"{errs[-1]}, {rels[-1]:.3g} of its max |value| (tolerance "
              f"{SSD_BWD_TOL})")
    line = (f"ssd_chunk_bwd {tag} ({route}): M={M} "
            f"K={K} L={L} P={P} N={N} group={group}  max|err| / max|value| "
            + " ".join(f"{k} {v:.3g}" for k, v in zip(
                ("dx", "ddt", "dla", "db", "dc"), rels)))
    res = dict(max_abs_err=max(errs))
    if n_time:
        k_ev, k_dev = cuda_ms(lambda: ops.launch_bwd(*args, *grads, group),
                              n_time, torch)
        p_ev, p_dev = cuda_ms(lambda: ref.ssd_chunk_bwd(
            *args, *grads, group=group), 1, torch)
        # the least work: the causal half of dM and dU and the whole of R
        # and dX's state term per head, the causal half of C·Bᵀ, dC and
        # dB once per chunk and B/C row, 2 operations a multiply-add, at
        # the TF32 tensor-core peak; bytes: x, dy, dstate, Δ, log a,
        # ddec, dtot and the rows' B and C read once, dx, dΔ, dla, dB and
        # dC written once (float32)
        tri = L * (L + 1) // 2
        ops_n = 2.0 * (M * K * (2 * tri * P + 2 * L * N * P)
                       + G * K * 3 * tri * N)
        nbytes = 4.0 * (M * K * L * (3 * P + 5) + M * K * N * P + M * K
                        + 4 * G * K * L * N)
        bound_ms, by = max((ops_n / TF32_OPS_PER_S * 1e3, "operations"),
                           (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        f32_ms = max(ops_n / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        k_ms = k_dev or k_ev
        # the plain version is a chain of some fifty PyTorch kernels, whose
        # profile late in a full run lost most of its device events (0.553
        # ms device against 12.06 ms per call on an H100): its time is the
        # per-call events'
        line += (f"  kernels {_ms(k_dev)} ms device / {k_ev:.4f} ms per "
                 f"call  {ops_n / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s  "
                 f"{bound_ms / k_ms:.4f} of the bound  plain {_ms(p_dev)} "
                 f"ms device / {p_ev:.4f} ms per call  bound "
                 f"{bound_ms:.4f} ms ({by}; float32-pipe figure "
                 f"{f32_ms:.4f} ms)")
        res.update(ms=k_ms, plain_ms=p_ev, bound_ms=bound_ms,
                   bound_by=by, library_ms=None)
    counts.update(saved)
    log(line)
    del args, grads, a, b, want
    torch.cuda.empty_cache()
    return res


def check_ssd_bwd_build():
    """The SSD backward build's ``ptxas`` report must hold each of
    ``SSD_BWD_KERNELS`` and no kernel may spill; its SASS must hold wgmma
    (``HGMMA``) and TMA loads (``UTMALDG``)."""
    from repro_torch.kernels import _build
    report = ptxas_report("ssd_chunk_bwd")
    log("ssd_chunk_bwd ptxas: " + (" | ".join(
        f"{k}: {v.get('registers', '?')} registers, "
        f"{v.get('spills', '?')} bytes spilled"
        for k, v in report.items()) or "no report"))
    # mangled names carry the name's length: 10ssd_bwd_dsILi128E...,
    # 13ssd_bwd_headsEPKf...
    missing = [n for n in SSD_BWD_KERNELS
               if not any(f"{len(n)}{n}E" in k or f"{len(n)}{n}I" in k
                          for k in report)]
    check(report and not missing
          and all(v.get("spills") == 0 for v in report.values()),
          f"ssd_chunk_bwd: kernels missing from the ptxas report {missing}, "
          "or a kernel that spills")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "--dump-sass", str(_build.library("ssd_chunk_bwd"))],
        capture_output=True, text=True, timeout=300).stdout
    n = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log("ssd_chunk_bwd SASS: " + "  ".join(f"{k} {v}" for k, v in n.items()))
    check(n["HGMMA"] > 0 and n["UTMALDG"] > 0,
          "ssd_chunk_bwd: the built library holds no wgmma (HGMMA) or no "
          "TMA load (UTMALDG)")


def check_bwd_build():
    """The backward build's ``ptxas`` registers and spills per kernel: the
    report must hold each of ``BWD_KERNELS`` and no kernel may spill; its
    SASS must hold wgmma (``HGMMA``) and TMA loads (``UTMALDG``)."""
    from repro_torch.kernels import _build
    report = ptxas_report("flash_attention_bwd")
    log("flash_attention_bwd ptxas: " + (" | ".join(
        f"{k}: {v.get('registers', '?')} registers, "
        f"{v.get('spills', '?')} bytes spilled"
        for k, v in report.items()) or "no report"))
    # mangled names carry the name's length: 17flash_bwd_dq_sm90I...
    missing = [n for n in BWD_KERNELS
               if not any(f"{len(n)}{n}I" in k for k in report)]
    check(report and not missing
          and all(v.get("spills") == 0 for v in report.values()),
          f"flash_attention_bwd: kernels missing from the ptxas report "
          f"{missing}, or a kernel that spills")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "--dump-sass", str(_build.library("flash_attention_bwd"))],
        capture_output=True, text=True, timeout=300).stdout
    n = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG")}
    log("flash_attention_bwd SASS: " + "  ".join(f"{k} {v}"
                                                 for k, v in n.items()))
    check(n["HGMMA"] > 0 and n["UTMALDG"] > 0,
          "flash_attention_bwd: the built library holds no wgmma (HGMMA) or "
          "no TMA load (UTMALDG)")


def train_kernels(cfg):
    """The mixers' kernels of a train step: each one's launches a step
    (the forward twice, for the remat recompute; the backward's launches
    once a call), the device-trace symbols of the forwards and of the
    backwards' passes.  Flash runs once an attention layer (encdec: once
    an encoder layer and twice, self and cross, a decoder layer), the SSD
    kernel once a Mamba layer (hybrid: attn_period - 1 a period)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    L = cfg.n_layers
    n_attn = {"ssm": 0, "hybrid": L // max(cfg.attn_period, 1),
              "encdec": cfg.n_enc_layers + 2 * L}.get(cfg.family, L)
    n_ssd = {"ssm": L, "hybrid": L - n_attn}.get(cfg.family, 0)
    want, fwd, bwd = {}, (), ()
    if n_attn:
        want.update(flash_attention=2 * n_attn,
                    flash_attention_bwd=n_attn * fops.BWD_LAUNCHES)
        fwd += ("flash_fwd",)
        bwd += ("flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90")
    if n_ssd:
        shape = (cfg.ssd_chunk, cfg.mamba.d_state, cfg.mamba.headdim)
        sm90 = sops.route_bwd(*shape) == sops.TENSOR_CORES
        want.update(ssd_chunk=2 * n_ssd,
                    ssd_chunk_bwd=n_ssd * sops.bwd_launches(*shape))
        fwd += ("ssd_chunk_sm90",)
        bwd += (SSD_BWD_SM90 if sm90
                else SSD_BWD_KERNELS[len(SSD_BWD_SM90):])
    return want, fwd, bwd


def train_cfg(arch, over=None):
    """``arch``'s config with the fields of ``over`` replaced; the jamba
    period's MoE cut to ``JAMBA_TRAIN_EXPERTS`` experts."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), **(over or {}))
    if arch == JAMBA:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=JAMBA_TRAIN_EXPERTS))
    return cfg


def train_tag(arch, cfg):
    """The run's name with its cuts."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    cuts = []
    if cfg.n_layers != full.n_layers:
        cuts.append(f"{cfg.n_layers} of {full.n_layers} layers")
    if cfg.attn_period != full.attn_period:
        cuts.append(f"attn_period {cfg.attn_period}")
    if cfg.moe is not None and cfg.moe.n_experts != full.moe.n_experts:
        cuts.append(f"{cfg.moe.n_experts} of {full.moe.n_experts} "
                    "experts")
    return arch + (f" ({', '.join(cuts)})" if cuts else "")


def train_digest(tree, torch):
    """The bits of every leaf of ``tree`` as int64 sums, one a chunk of
    2^24 elements, each element's bits (as an integer of its width) times
    an odd multiplier of its position, wrapping: one element that differs
    changes its chunk's sum.  Two runs whose parameters and moments do
    not fit twice on the card compare through it."""
    from repro_torch.tree import tree_leaves
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for leaf in tree_leaves(tree):
        bits = leaf.detach().reshape(-1)
        bits = bits.view(ints[bits.element_size()])
        sums = []
        for a in range(0, bits.numel(), 1 << 24):
            c = bits[a:a + (1 << 24)].long()
            pos = torch.arange(a, a + c.numel(), dtype=torch.int64,
                               device=c.device)
            sums.append((c * ((pos * -7046029254386353131) | 1)).sum())
        out.append(torch.stack(sums))
    return out


def batch_for_run(cfg, steps, batch_size, dev, on_step, torch):
    """``launch.train.main``'s loop for a config its token batches cannot
    train (encdec's frames) or that trains on ``data.batch_for``'s inputs
    (vlm's embeds and M-RoPE positions): the driver's optimizer config,
    seed and in-place update, ``batch_for``'s batch each step.  Returns
    the losses."""
    from repro_torch.configs import SHAPES
    from repro_torch.data import batch_for
    from repro_torch.models import build_model
    from repro_torch.train import AdamWCfg, adamw_init, make_train_step
    shape = dataclasses.replace(
        next(s for s in SHAPES if s.name == "train_4k"),
        seq_len=TRAIN_SEQ, global_batch=batch_size)
    model = build_model(cfg)
    step_fn = make_train_step(model, AdamWCfg(
        lr=1e-3, warmup_steps=max(steps // 20, 5), total_steps=steps),
        donate=True)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    opt = adamw_init(params)
    losses = []
    for step in range(steps):
        params, opt, metrics = step_fn(params, opt, batch_for(
            cfg, shape, step, device=dev))
        losses.append(float(metrics["loss"]))
        on_step(step, params, opt, metrics)
    return losses


def cross_bwd_ms(prof, cfg):
    """Device ms of whisper's cross-attention backward in a train step's
    profile: the backward reaches each decoder layer's cross-attention
    before its self-attention, so the flash backward's kernels come in
    that order, two a call (dq, dk/dv), decoder layers first (None where
    the trace holds another count)."""
    from torch.autograd import DeviceType
    ev = sorted((e for e in prof.events() if e.device_type != DeviceType.CPU
                 and "flash_bwd" in e.name),
                key=lambda e: e.time_range.start)
    n = 2 * (cfg.n_enc_layers + 2 * cfg.n_layers)
    if len(ev) != n:
        return None
    return sum(e.time_range.elapsed_us() for i, e in
               enumerate(ev[:4 * cfg.n_layers]) if i % 4 < 2) / 1e3


def run_train_full(torch, dev, launches, arch=TRAIN_ARCH,
                   batch_size=TRAIN_BATCH, over=None, batches="main"):
    """``arch`` at full width (its config with ``over``'s fields: the cut
    in depth or experts), T = 4096, B = ``batch_size``, trained twice from
    the same seed through ``launch.train.main`` (``batches="main"``) or
    the driver's loop on ``data.batch_for``'s batches (``"batch_for"``):
    finite losses and gradient norms, per step the mixer kernels'
    launches (``train_kernels``: for qwen3-0.6b 2 x 28 ``flash_attention``
    launches, the forward and the remat recompute, and 28 x
    ``BWD_LAUNCHES`` ``flash_attention_bwd``; for mamba2-130m 2 x 24
    ``ssd_chunk`` and 24 x ``ops.bwd_launches`` ``ssd_chunk_bwd``), the
    two runs bit-equal in every parameter and moment (through
    ``train_digest`` where the state passes ``EXACT_STATE_BYTES``); the
    step wall, tokens/s, peak memory; then one more step under the
    profiler: busy share, device time by kernel, the backward kernels'
    share (for the encdec family also its cross-attention's backward)."""
    from repro_torch.data import SyntheticLM, batch_for
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import counts, reset_counts
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.common import n_params as n_params_of
    from repro_torch.train import AdamWCfg, make_train_step
    from repro_torch.tree import tree_leaves
    t_path = time.perf_counter()
    cfg = train_cfg(arch, over)
    tag = train_tag(arch, cfg)
    want, fwd_names, bwd_names = train_kernels(cfg)
    n_params = n_params_of(build_model(cfg).schema())
    exact = 10 * n_params <= EXACT_STATE_BYTES
    argv = ["--arch", arch, "--seq", str(TRAIN_SEQ), "--batch",
            str(batch_size), "--steps", str(TRAIN_STEPS), "--log-every",
            "1"]
    runs, parts = [], []
    for r in range(2):
        state, walls, per_step = {}, [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t_last = [time.perf_counter()]
        seen = [dict(counts)]

        def on_step(step, params, opt, metrics):
            torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append(now - t_last[0])
            per_step.append({k: counts[k] - seen[0][k] for k in want})
            seen[0] = dict(counts)
            state.update(params=params, opt=opt, metrics=metrics)
            check(bool(torch.isfinite(metrics["grad_norm"])),
                  f"{tag} train step {step}: grad norm not finite")
            t_last[0] = time.perf_counter()
        if batches == "main":
            losses = train.main(argv, on_step=on_step, cfg=cfg)
        else:
            losses = batch_for_run(cfg, TRAIN_STEPS, batch_size, dev,
                                   on_step, torch)
        for k in want:
            launches[k] = launches.get(k, 0) + counts[k]
        check(len(losses) == TRAIN_STEPS and all(
            math.isfinite(x) for x in losses),
            f"{tag} training: losses {losses}")
        for s, n in enumerate(per_step):
            check(n == want, f"{tag} train step {s}: launches {n}, "
                  f"not {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        st = (state["params"], state["opt"])
        runs.append((losses, st if exact else train_digest(st, torch),
                     walls, peak))
        parts.append(time.perf_counter() - t_path - sum(parts))
        if r == 0:
            state.clear()
            del st
            torch.cuda.empty_cache()
    (la, ka, walls, peak), (lb, kb, _, _) = runs
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(ka),
                                                  tree_leaves(kb)))
    check(same and la == lb, f"{tag} training: two runs from one "
          "seed differ")
    how = ("in every parameter and moment" if exact else
           "in every parameter and moment's train_digest")
    step_s = sum(walls[1:]) / len(walls[1:])
    tok_s = TRAIN_SEQ * batch_size / step_s
    log(f"{tag} training, full width, {n_params / 1e9:.3f} B parameters, "
        f"T={TRAIN_SEQ} B={batch_size}, remat, AdamW: losses "
        f"{[round(x, 4) for x in la]}  step wall {step_s:.3f} s (steps 1-"
        f"{TRAIN_STEPS - 1}; step 0 {walls[0]:.3f} s)  {tok_s:.0f} tok/s  "
        f"peak memory {peak:.2f} GiB  per step {want}  two runs bit-equal "
        f"{how}")
    # one more step under the profiler, from run B's state; its busy
    # share divides by run B's last (unprofiled) step's wall
    wall = runs[1][2][-1]
    model = build_model(cfg)
    step_fn = make_train_step(model, AdamWCfg(
        lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS), donate=True)
    if batches == "main":
        batch = SyntheticLM(cfg.vocab, TRAIN_SEQ, batch_size).batch(
            TRAIN_STEPS, device=dev)
    else:
        shape = dataclasses.replace(
            next(s for s in SHAPES if s.name == "train_4k"),
            seq_len=TRAIN_SEQ, global_batch=batch_size)
        batch = batch_for(cfg, shape, TRAIN_STEPS, device=dev)
    box = [state.pop("params"), state.pop("opt")]
    state.clear()
    profs = []

    def one_step():
        box[0], box[1], m = step_fn(box[0], box[1], batch)
        float(m["loss"])
    by_name, _ = traced(one_step, fwd_names + tuple(bwd_names), torch,
                        keep=profs)
    busy = sum(by_name.values()) / 1e6
    check(busy > 0, f"{tag} training: the profiler recorded no "
          "device time")
    fwd = {n: sum(v for k, v in by_name.items() if n in k) / 1e6
           for n in fwd_names}
    passes = {n: sum(v for k, v in by_name.items() if n in k) / 1e6
              for n in bwd_names}
    bwd = sum(passes.values())
    del ka, kb, runs
    check(all(passes.values()) and all(fwd.values()), f"{tag} training: "
          f"the device trace lacks {', '.join(bwd_names)} or "
          f"{', '.join(fwd_names)} ({passes}, {fwd})")
    cross = ""
    if cfg.family == "encdec":
        ms = cross_bwd_ms(profs[-1], cfg)
        cross = ("; the cross-attention's backward (Tq 4096 over Tk "
                 f"{cfg.n_frames}) {'not measured' if ms is None else f'{ms / cfg.n_layers:.4f} ms a layer'}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"{tag} train step device time {busy:.3f} s; busy share "
        f"{busy / wall:.3f} of the unprofiled {wall:.3f} s wall; the "
        f"backward kernels {bwd:.3f} s ({bwd / busy:.3f} of the device "
        "time: " + ", ".join(f"{k} {v:.3f} s" for k, v in passes.items())
        + "), the forward kernels " + ", ".join(
            f"{k} {v:.3f} s ({v / busy:.3f})" for k, v in fwd.items())
        + cross + "; top kernels: "
        + "; ".join(f"{k[:60]} {v / 1e6:.3f} s" for k, v in top)
        + f"  (the path {time.perf_counter() - t_path:.1f} s: runs "
        f"{parts[0]:.1f} + {parts[1]:.1f} s, the profiled step "
        f"{time.perf_counter() - t_path - sum(parts):.1f} s)")
    del box, batch, profs
    torch.cuda.empty_cache()
    return dict(step_s=step_s, tok_s=tok_s, peak_gib=peak, busy=busy / wall,
                bwd_share=bwd / busy)


def train_two_layer_batch(cfg, T, B, torch, device):
    """The 2-layer train step's batch on ``device``: ``data.batch_for``'s
    for the vlm and encdec families, ``SyntheticLM``'s tokens else."""
    from repro_torch.configs import SHAPES
    from repro_torch.data import SyntheticLM, batch_for
    if cfg.family in ("vlm", "encdec"):
        shape = dataclasses.replace(
            next(s for s in SHAPES if s.name == "train_4k"), seq_len=T,
            global_batch=B)
        return batch_for(cfg, shape, 3, seed=5, device=device)
    return SyntheticLM(cfg.vocab, T, B, seed=5).batch(3, device=device)


def train_two_layer_cpu(arch, params, torch, T=256, B=2, **kw):
    """The CPU side of ``check_train_two_layer`` (``cpu_side_main`` runs
    it) on the check's weights copied to the CPU: the batch, the loss,
    the global gradient norm, the gradients and the routing records of
    one step through the plain versions."""
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import clip_by_global_norm
    from repro_torch.train.train_step import value_and_grad
    cfg = two_layer_cfg(arch, **kw)
    model = build_model(cfg)
    batch = train_two_layer_batch(cfg, T, B, torch, "cpu")
    with routing_record() as rec:
        loss, grads = value_and_grad(model, params, batch)
    return {"batch": batch, "loss": float(loss),
            "norm": float(clip_by_global_norm(grads, 1.0)[1]),
            "grads": grads, "sets": rec.sets, "chosen": rec.chosen}


def check_train_two_layer(torch, dev, arch=TRAIN_ARCH, T=256, B=2, **kw):
    """One train step's gradients of a 2-layer ``arch`` at full width
    (``kw``: other fields of its config, ``n_experts``), the card (through
    the mixers' kernels in both directions) against the CPU (the plain
    versions; ``train_two_layer_cpu``, computed by the CPU-side process),
    same weights and batch: the batch (``SyntheticLM``'s tokens, or
    ``data.batch_for``'s for the vlm and encdec families) from the card
    bit-equal to the CPU's; the loss, the global gradient norm and every
    gradient leaf within their tolerances.  Where the model routes to
    experts, a bf16 choice at a near-tie may go the other way on the
    other device, and such a token's share then moves the gradients of
    its experts and, through its changed activations, of every leaf below
    (at qwen3-moe-30b-a3b's size 45 of 4,096 choices moved leaves by up to
    0.21 of their max |grad| where their experts' tokens agreed).  So the
    card's own routing gives the loss, the norm and the share of choices
    alike, and the gradients are held on a second card step whose MoE
    layers take the CPU's choices (``given_routing``)."""
    import gc
    from repro_torch.kernels import counts
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import clip_by_global_norm
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import leaves_with_path
    cfg = two_layer_cfg(arch, **kw)
    model = build_model(cfg)
    t0 = time.perf_counter()
    on_card = two_layer_params(model, 4, torch, dev)
    card_batch = train_two_layer_batch(cfg, T, B, torch, dev)
    before = dict(counts)
    with routing_record() as card_rec:
        loss_d, g_d = value_and_grad(model, on_card, card_batch)
    norm_d = clip_by_global_norm(g_d, 1.0)[1]
    # one step's launches (the counts are restored: not the main path)
    want = train_kernels(cfg)[0]
    got = {k: counts[k] - before[k] for k in want}
    check(got == want, f"{arch} 2-layer train step: launches {got}, not "
          f"{want}")
    cpu = CPU_SIDE.result("train", arch, T=T, B=B, **kw)
    what = "batch_for" if cfg.family in ("vlm", "encdec") else "SyntheticLM"
    check(all(torch.equal(cpu["batch"][k], card_batch[k].cpu())
              for k in cpu["batch"]),
          f"{what}: the card's batch differs from the CPU's")
    routed = ""
    if cfg.moe is not None:
        # the forward's records (the remat recompute records again)
        n_moe = len(cpu["sets"]) // 2
        same, total = routing_agreement(card_rec.sets[:n_moe],
                                        cpu["sets"][:n_moe])
        del g_d
        with given_routing(cpu["chosen"]) as given:
            loss_g, g_d = value_and_grad(model, on_card, card_batch)
        check(given.calls == len(cpu["chosen"]), f"{arch} 2-layer: "
              f"{given.calls} MoE calls, the CPU's run made "
              f"{len(cpu['chosen'])}")
        routed = (f"; routing choices alike on card and CPU {same} of "
                  f"{total} ({same / total:.5f}); the gradients with the "
                  f"CPU's choices (loss off by "
                  f"{abs(float(loss_g) - cpu['loss']):.3g})")
    counts.update(before)
    t_card = time.perf_counter() - t0
    loss_err = abs(float(loss_d) - cpu["loss"])
    norm_err = abs(float(norm_d) - cpu["norm"]) / cpu["norm"]
    errs = []
    for (path, a), (_, b) in zip(leaves_with_path(cpu["grads"]),
                                 leaves_with_path(g_d)):
        # compared on the card: the CPU's leaf copied over
        a = a.to(dev).float()
        scale = max(float(a.abs().max()), 1e-30)
        errs.append((float((b.float() - a).abs().max()) / scale, path))
        del a
    errs.sort(reverse=True)
    tag = f"{arch} 2-layer" + "".join(f" {k}={v}" for k, v in kw.items())
    log(f"{tag} full width, T={T} B={B}: {what} batch on the card "
        f"bit-equal to the CPU's; loss {cpu['loss']:.5f} (card off by "
        f"{loss_err:.3g}, tolerance {TRAIN_LOSS_TOL}), grad norm "
        f"{cpu['norm']:.5f} (relative error {norm_err:.3g}, tolerance "
        f"{TRAIN_NORM_RTOL}){routed}, worst gradient leaves "
        + ", ".join(f"{p} off by {e:.3g}" for e, p in errs[:3])
        + f" of their max |grad| (tolerance {TRAIN_GRAD_TOL})  (card "
        f"{t_card:.1f} s, CPU {cpu['seconds']:.1f} s in the CPU-side "
        "process)")
    check(loss_err <= TRAIN_LOSS_TOL and norm_err <= TRAIN_NORM_RTOL
          and errs[0][0] <= TRAIN_GRAD_TOL,
          f"{arch} 2-layer train step: the card differs from the CPU")
    del on_card, g_d, card_batch, cpu
    gc.collect()
    torch.cuda.empty_cache()


def run_train_tiny(torch, dev):
    """The reference's two driver checks on the card with the ``tiny``
    preset: the loss drops by 0.2 over 100 steps
    (``tests/test_launch_tools.py``), and 3 steps, a checkpoint, a restore
    and 3 more steps equal 6 straight steps bit for bit
    (``tests/test_substrate.py``)."""
    import tempfile
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.serve import PRESETS
    from repro_torch.models import build_model
    from repro_torch.train import AdamWCfg, adamw_init, make_train_step
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    losses = train.main(["--preset", "tiny", "--steps", "100", "--batch",
                         "4", "--seq", "64", "--lr", "3e-3", "--log-every",
                         "100"])
    drop = float(np.mean(losses[:10]) - np.mean(losses[-10:]))
    t1 = time.perf_counter()
    cfg = PRESETS["tiny"]
    model = build_model(cfg)
    step_fn = make_train_step(model, AdamWCfg(lr=1e-3, warmup_steps=2,
                                              total_steps=10))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=2)

    def run(params, opt, start, end):
        for s in range(start, end):
            params, opt, _ = step_fn(params, opt, data.batch(s, device=dev))
        return params, opt

    p0 = model.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    o0 = adamw_init(p0)
    pa, oa = run(p0, o0, 0, 6)
    pb, ob = run(p0, o0, 0, 3)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save({"p": pb, "o": ob}, 2, blocking=True)
        restored, step = mgr.restore_latest({"p": pb, "o": ob})
    pc, oc = run(restored["p"], restored["o"], step + 1, 6)
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves((pa, oa)),
                                                 tree_leaves((pc, oc))))
    log(f"tiny preset on the card: loss {np.mean(losses[:10]):.4f} -> "
        f"{np.mean(losses[-10:]):.4f} over 100 steps (drop {drop:.4f}, "
        f"needs 0.2; {t1 - t0:.1f} s); 3 steps + checkpoint + restore + 3 "
        f"steps {'bit-equal' if same else 'DIFFER from'} 6 straight steps "
        f"({time.perf_counter() - t1:.1f} s)")
    check(drop > 0.2, f"tiny preset: the loss dropped by {drop}, not 0.2")
    check(same, "tiny preset: a resumed run differs from a straight one")


# ---------------------------------------------------------------------------
# The distribution layer (ROADMAP 15(e), 15(f)): elastic reshard on the card,
# the fake-mesh dry run in a child process, the LLM serving twin
# ---------------------------------------------------------------------------

DIST_ARCH = "qwen3-0.6b"
# the dry run's gated cells (arch, shape, multi-pod) and the cell it only
# records: jamba-1.5-large's full state per device at full depth
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", False),
                ("qwen3-0.6b", "prefill_32k", False),
                ("qwen3-0.6b", "decode_32k", False),
                ("qwen3-0.6b", "train_4k", True),
                # 24 heads the 16-way "model" axis does not divide
                ("mamba2-130m", "train_4k", True))
DRYRUN_RECORDED = ((JAMBA, "train_4k", False),)
# the cells that stopped at an op eager DTensor had no rule for, at their
# reduced configs on a fake world of 8, mesh (2, 4): (arch, kind,
# reduced()'s overrides)
DRYRUN_REPAIRED = (("qwen3-moe-30b-a3b", "prefill", {}),
                   ("qwen2-moe-a2.7b", "train", {}),
                   ("mamba2-130m", "prefill", {}),
                   (JAMBA, "prefill", {}),
                   ("phi3-medium-14b", "prefill", {"attn_impl": "flat"}))
DRYRUN_SMALL = (64, 8)      # T, B of the reduced cells (the CPU tests')
TWIN_ARCH = "qwen3-0.6b"
TWIN_CLIENTS = 1000            # enough load for the HS arm to scale out
TWIN_DURATION = 120.0


def _bits_equal(a, b, torch) -> bool:
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()]))


def run_dist(torch, dev):
    """Phase 14: qwen3-0.6b's full-width train state (parameters and AdamW
    moments after one step) saved with ``CheckpointManager`` and loaded on
    the host, placed on a (1, 1) ("data", "model") mesh by
    ``reshard_tree``, then rescaled by ``simulate_failure_and_rescale``
    onto (1, 1, 1) ("pod", "data", "model"), over a world-size-1 NCCL
    group started through a ``FileStore`` (no network).  Every leaf's
    ``full_tensor()`` bit-equal to the saved leaf, its placements the
    resolver's, and one ``train_4k`` step (B ``TRAIN_BATCH``) from the
    rescaled state's local tensors bit-equal, in every parameter and
    moment, to the step from the state that was never resharded."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.ckpt.elastic import (reshard_tree,
                                          simulate_failure_and_rescale)
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import batch_for
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import opt_logical
    from repro_torch.models import build_model
    from repro_torch.train import AdamWCfg, adamw_init, make_train_step
    from repro_torch.tree import leaves_with_path, tree_leaves, tree_map
    tag = f"dist ({DIST_ARCH})"
    t_phase = time.perf_counter()
    cfg = get_config(DIST_ARCH)
    model = build_model(cfg)
    shape = dataclasses.replace(
        next(s for s in SHAPES if s.name == "train_4k"),
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    step_fn = make_train_step(model, AdamWCfg())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1)
    try:
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(0), dev)
        params, opt, _ = step_fn(params, adamw_init(params),
                                 batch_for(cfg, shape, 0, device=dev))
        state = {"params": params, "opt": opt}
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(state))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), keep=1)
        mgr.save(state, step=1, blocking=True)
        t_save = time.perf_counter() - t0
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                        state)
        t0 = time.perf_counter()
        host, step = mgr.restore_latest(like)
        t_load = time.perf_counter() - t0
        check(step == 1, f"{tag}: restored step {step}")
        axes = model.param_logical_axes()
        logical = {"params": axes, "opt": opt_logical(axes)}
        t0 = time.perf_counter()
        m1 = make_mesh((1, 1), ("data", "model"))
        placed = reshard_tree(host, m1, logical)
        torch.cuda.synchronize()
        t_place = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2 = make_mesh((1, 1, 1), ("pod", "data", "model"))
        placed = simulate_failure_and_rescale(placed, m1, m2, logical)
        torch.cuda.synchronize()
        t_rescale = time.perf_counter() - t0
        del host
        saved = dict(leaves_with_path(state))
        # the resolver's placements of each leaf on the new mesh (wrapped:
        # a tuple would be walked as a container)
        want = dict(leaves_with_path(tree_map(
            lambda t, ax: types.SimpleNamespace(p=shd.placements(
                m2, shd.resolve(m2, t.shape, ax, shd.PARAM_RULES))),
            state, logical)))
        n = 0
        for path, t in leaves_with_path(placed):
            check(t.device.type == dev.type, f"{tag}: {path} on {t.device}")
            check(_bits_equal(t.full_tensor(), saved[path], torch),
                  f"{tag}: {path} differs after two reshards")
            check(tuple(t.placements) == want[path].p,
                  f"{tag}: {path} placed {t.placements}, the resolver "
                  f"{want[path].p}")
            n += 1
        # a kernel's card path takes plain tensors: a DTensor raises
        from torch.distributed.tensor import Replicate, distribute_tensor
        from repro_torch.kernels.flash_attention import attention
        x = distribute_tensor(torch.zeros((1, 1, 16, 64), device=dev,
                                          dtype=torch.bfloat16), m2,
                              [Replicate()] * 3)
        try:
            attention(x, x, x)
            refused = ""
        except TypeError as e:
            refused = str(e)
        check("DTensor" in refused, f"{tag}: the flash kernel's entry took "
              "a DTensor")
        local = tree_map(lambda t: t.to_local(), placed)
        batch = batch_for(cfg, shape, 1, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = step_fn(state["params"], state["opt"], batch)
        got = step_fn(local["params"], local["opt"], batch)
        torch.cuda.synchronize()
        t_steps = time.perf_counter() - t0
        m = 0
        for a, b in zip(tree_leaves((got[0], got[1])),
                        tree_leaves((want[0], want[1]))):
            check(_bits_equal(a, b, torch), f"{tag}: the resumed step "
                  "differs from the step that was never resharded")
            m += 1
        check(float(got[2]["loss"]) == float(want[2]["loss"]),
              f"{tag}: resumed loss differs")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gb = nbytes / 1e9
    log(f"{tag}: state {gb:.3f} GB ({n} leaves: parameters and AdamW "
        f"moments); saved {t_save:.2f} s, loaded on the host "
        f"{t_load:.2f} s, placed on (1, 1) {t_place:.2f} s ({gb:.3f} GB "
        f"host to card), rescaled to (1, 1, 1) {t_rescale:.2f} s "
        f"({gb:.3f} GB card to host, {gb:.3f} GB host to card); every "
        f"leaf bit-equal and placed as the resolver says; a DTensor "
        f"refused by the flash kernel's entry ({refused}); the resumed "
        f"step bit-equal in all {m} parameters and moments (two steps "
        f"{t_steps:.2f} s); phase wall {time.perf_counter() - t_phase:.1f}"
        f" s  ({gpu_line()})")


def resolver_bytes(arch, shape_name, multi_pod) -> int:
    """The dry-run cell's argument bytes per device by the resolver alone
    (``AbstractMesh``, shard shapes of the abstract arguments), apart
    from the DTensors the dry run builds."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(arch)
    shape = next(s for s in SHAPES if s.name == shape_name)
    model = build_model(cfg)
    mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model")) \
        if multi_pod else shd.AbstractMesh((16, 16), ("data", "model"))
    ap, ax = model.abstract_params(), model.param_logical_axes()
    trees = [(ap, ax, shd.PARAM_RULES)]
    if shape.kind == "decode":
        B = shape.global_batch
        trees += [(model.init_decode_state(B, shape.seq_len, device="meta"),
                   specs.decode_state_logical(model, cfg),
                   specs.STATE_RULES),
                  (specs._meta((B, 1), torch.int32), ("batch", None),
                   shd.ACT_RULES)]
    else:
        inp = specs.input_specs(cfg, shape)
        if shape.kind == "prefill":
            inp.pop("labels")
        trees.append((inp, specs.batch_logical(cfg, inp), shd.ACT_RULES))
        if shape.kind == "train":
            trees.append((specs.abstract_opt_state(ap),
                          specs.opt_logical(ax), shd.PARAM_RULES))

    def one(a, axes, rules):
        spec = shd.resolve(mesh, a.shape, axes, rules)
        return math.prod(shd.shard_shape(mesh, a.shape, spec)) \
            * a.element_size()
    return sum(sum(tree_leaves(tree_map(lambda a, x: one(a, x, r), t, l)))
               for t, l, r in trees)


class DryRun:
    """The child process of the dry run (``DRYRUN_FLAG``): ``start()``
    spawns it, ``result()`` waits for its records, ``stop()`` ends it and
    removes its directory."""

    def __init__(self):
        self.proc = self.dir = None

    def start(self):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        self.log = open(os.path.join(self.dir, "child.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), DRYRUN_FLAG,
             self.dir], stdout=self.log, stderr=subprocess.STDOUT)

    def result(self):
        t0 = time.perf_counter()
        code = self.proc.wait()
        with open(os.path.join(self.dir, "child.log")) as f:
            tail = f.read()[-3000:]
        path = os.path.join(self.dir, "records.json")
        check(code == 0 and os.path.exists(path),
              f"the dry-run process ended with exit code {code}:\n{tail}")
        log(f"dry run: waited {time.perf_counter() - t0:.1f} s for the "
            "child")
        with open(path) as f:
            return json.load(f)

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        if self.proc is not None:
            self.proc.wait()
            self.log.close()
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
        self.proc = self.dir = None


DRYRUN = DryRun()


def dryrun_main(out_dir) -> int:
    """The dry-run child: every cell of ``DRYRUN_CELLS`` and
    ``DRYRUN_RECORDED`` on its fake world (no card work: it runs beside
    the card phases at the lowest priority, one thread)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    os.nice(19)
    torch.set_num_threads(1)
    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    recs = []
    T, B = DRYRUN_SMALL
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        for arch, kind, over in DRYRUN_REPAIRED:
            t0 = time.perf_counter()
            rec = dict(arch=arch, shape=f"{kind}_small", mesh="2x4",
                       reduced=over, repaired=True)
            rec.update(dryrun.cell_record(
                get_config(arch).reduced(**over),
                ShapeCfg(f"{kind}_small", T, B, kind), mesh,
                extrapolate=False))
            rec["child_wall_s"] = round(time.perf_counter() - t0, 1)
            print(dryrun.show(rec), flush=True)
            recs.append(rec)
    for arch, shape, multi_pod in DRYRUN_CELLS + DRYRUN_RECORDED:
        t0 = time.perf_counter()
        rec = dryrun.dryrun_cell(arch, shape, multi_pod, force=True)
        rec["child_wall_s"] = round(time.perf_counter() - t0, 1)
        print(dryrun.show(rec), flush=True)
        recs.append(rec)
    tmp = os.path.join(out_dir, "records.tmp")
    with open(tmp, "w") as f:
        json.dump(recs, f)
    os.replace(tmp, os.path.join(out_dir, "records.json"))
    return 0


def check_dryrun():
    """Phase 15: the dry-run child's records.  The qwen3-0.6b cells must
    be ``ok``, their ``argument_bytes`` equal to ``resolver_bytes``, the
    2×16×16 train batch split 32 ways and (single pod) the extrapolated
    FLOPs equal to the direct count; each cell's roofline row under the
    H100 constants.  jamba-1.5-large's full-depth record is printed, not
    gated."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, roofline
    recs = DRYRUN.result()
    card = gpu_line()
    log(f"dry run constants (roofline.py, H100 SXM5 datasheet, not "
        f"measured): PEAK_FLOPS {roofline.PEAK_FLOPS:.3e} FLOP/s, HBM_BW "
        f"{roofline.HBM_BW:.3e} B/s, LINK_BW {roofline.LINK_BW:.3e} B/s; "
        f"counts are eager DTensor counts per device on a fake world, "
        f"not XLA's")
    gated = {(a, s, mp) for a, s, mp in DRYRUN_CELLS}
    for rec in recs:
        key = (rec["arch"], rec["shape"], rec["mesh"] == "2x16x16")
        tag = f"dry run {key[0]} {key[1]} {rec['mesh']}"
        log(f"{tag}: {dryrun.show(rec)} (child {rec.get('child_wall_s')} "
            f"s on the host, {card})")
        if rec.get("repaired"):
            tag += f" reduced{rec['reduced'] or ''}"
            check(rec["status"] == "ok", f"{tag}: {rec['status']} at "
                  f"{rec.get('op')}: {rec.get('error', '')[:500]}")
            log(f"{tag}: ok, per device flops {rec['cost']['flops']:.4e}, "
                f"bytes {rec['cost']['bytes_accessed']:.4e}, collectives "
                f"{json.dumps(rec.get('collectives', {}))}")
            continue
        mem = rec.get("memory", {})
        if mem:
            gib = {k: v / 2**30 for k, v in mem.items()}
            log(f"{tag}: per device argument "
                f"{gib['argument_bytes']:.3f} GiB, output "
                f"{gib.get('output_bytes', 0):.3f} GiB, temp "
                f"{gib.get('temp_bytes', 0):.3f} GiB; collectives "
                f"{json.dumps(rec.get('collectives', {}))}")
        if key not in gated:
            continue
        check(rec["status"] == "ok", f"{tag}: {rec['status']} at "
              f"{rec.get('op')}: {rec.get('error', '')[:500]}")
        want = resolver_bytes(*key)
        check(mem["argument_bytes"] == want, f"{tag}: argument bytes "
              f"{mem['argument_bytes']} against the resolver's {want}")
        if key[2] and rec["shape"].startswith("train"):
            tok = rec["batch_shards"]["tokens"]
            check(tok["global"][0] == 32 * tok["local"][0],
                  f"{tag}: the batch splits {tok} (want 32 ways)")
        if not key[2]:
            ext, direct = rec["cost_extrapolated"], rec["cost_direct"]
            check(ext["flops"] == direct["flops"], f"{tag}: extrapolated "
                  f"FLOPs {ext['flops']} against the direct {direct['flops']}")
            shape = next(s for s in SHAPES if s.name == rec["shape"])
            row = roofline.roofline_of(rec, get_config(rec["arch"]), shape)
            log(f"{tag} roofline: compute {row['t_compute_s']:.6f} s, "
                f"memory {row['t_memory_s']:.6f} s, collective "
                f"{row['t_collective_s']:.6f} s (dominant "
                f"{row['dominant']}), model FLOPs / counted "
                f"{row['useful_ratio']:.4f}, roofline fraction "
                f"{row['roofline_fraction']:.4f}")


def run_twin(torch, dev, launches):
    """Phase 9b: ``examples/torch_llm_serving_sim.py`` on the card (its
    stage costs from the H100 roofline constants), both arms at
    ``TWIN_CLIENTS`` clients over ``TWIN_DURATION`` s: each completes
    requests with one ``cloudlet_finish`` launch a tick, and the HS arm
    scales out."""
    sys.path.insert(0, os.path.join(HERE, "examples"))
    import torch_llm_serving_sim as twin
    from repro_torch.core import summarize
    from repro_torch.kernels import counts, reset_counts
    costs = twin.stage_costs_ms(TWIN_ARCH)
    log(f"serving twin ({TWIN_ARCH}): stage costs ms/request "
        + ", ".join(f"{k}={v:.3f}" for k, v in costs.items()))
    for label, sim in twin.make_sims(TWIN_ARCH, TWIN_CLIENTS,
                                     TWIN_DURATION, device=dev):
        tag = f"serving twin {label}"
        new_cell()
        T = sim.params.n_ticks
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = counts["cloudlet_finish"]
        check(n == T, f"{tag}: cloudlet_finish launched {n} times in {T} "
              "ticks")
        launches["cloudlet_finish"] = launches.get("cloudlet_finish", 0) + n
        rep = summarize(sim, res)
        check(rep.completed_requests > 0, f"{tag}: no request completed")
        if "HS" in label:
            check(rep.scale_out > 0, f"{tag}: the HS arm did not scale out")
        log(f"{tag}: {TWIN_CLIENTS} clients over {TWIN_DURATION:.0f} s "
            f"({T} ticks): completed {rep.completed_requests}, avg "
            f"{rep.avg_response_ms:.1f} ms, p95 {rep.p95_response_ms:.1f} "
            f"ms, replicas +{rep.scale_out}/-{rep.scale_in}; "
            f"cloudlet_finish launches {n}; wall {wall:.2f} s  "
            f"({gpu_line()})")


# the nine other twins of examples/ at their smallest settings (the CPU
# tests' ``tests/test_torch_examples.py``: the simulator's runs give the
# CPU's bits on the card, so each verdict holds as it does there): flags,
# and the module constants cut where a twin has no size flag
TWINS = (
    ("quickstart", [], {"N_TICKS": 100}),
    ("sockshop_sim", [], {"DURATION_S": 5.0, "LOADS": (100,)}),
    ("autoscale_study", ["--loads", "100", "--duration", "16"], {}),
    ("network_saturation", ["--loads", "10,20", "--duration", "5"], {}),
    ("chaos_study", ["--radii", "2", "--clients", "60", "--duration", "20"],
     {}),
    ("hetero_study", ["--clients", "40", "--duration", "20"], {}),
    ("slo_study", ["--duration", "10", "--clients", "30"], {}),
    ("telemetry_study", ["--duration", "10", "--points", "2"], {}),
    ("train_lm", ["--steps", "20", "--batch", "4", "--seq", "32", "--lr",
                  "1e-2", "--log-every", "100"], {}),
)


def run_twins(torch, dev, launches):
    """Phase 9c: each twin of ``TWINS`` once on the card: its ``main``
    returns 0 (its verdict holds); the kernels it launches are counted."""
    import contextlib
    import importlib.util
    import io
    from repro_torch.kernels import counts, reset_counts
    t_all = time.perf_counter()
    for name, flags, consts in TWINS:
        new_cell()
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", os.path.join(HERE, "examples",
                                          f"torch_{name}.py"))
        twin = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(twin)
        for k, v in consts.items():
            setattr(twin, k, v)
        out = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = twin.main(flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k: v for k, v in counts.items() if v}
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        tail = [ln for ln in out.getvalue().splitlines() if ln.strip()]
        check(code == 0, f"twin {name} {' '.join(flags)}: verdict failed:\n"
              + "\n".join(tail[-12:]))
        log(f"twin {name} {' '.join(flags)} "
            + " ".join(f"{k}={v}" for k, v in consts.items())
            + f": verdict held in {wall:.2f} s, launches {n}; "
            f"{tail[-1][:160]}")
    new_cell()
    log(f"twins of examples/: {time.perf_counter() - t_all:.1f} s in all "
        f"({gpu_line()})")


CHAOS_CASES = ("case1b+faults", "case1b+chaos2", "case1b+net+chaos2")


def overhead(figs, tags):
    """The replay figures of the cases ``tags`` beside case1b's from the
    same run: their ratios are the port's chaos and observability
    overheads."""
    base = figs["case1b"]
    fmt = lambda x: "not measured" if x is None else f"{x:.3f}"
    for tag in tags:
        f = figs[tag]
        log(f"{tag} against case1b: replayed {f['ms']:.3f} against "
            f"{base['ms']:.3f} ms/tick ({f['ms'] / base['ms']:.3f}x), "
            f"{f['ops']:.1f} against {base['ops']:.1f} device operations a "
            f"tick ({f['ops'] / base['ops']:.3f}x), busy share "
            f"{fmt(f['busy'])} against {fmt(base['busy'])}, {f['cpu_ops']} "
            f"against {base['cpu_ops']} operations a tick on the CPU "
            f"({gpu_line()})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"card: {card}  torch {torch.__version__} cuda {torch.version.cuda}")
    results, launches = {}, {}
    t_lap = [t_start]

    def lap(name):
        """Log the wall of the phases since the last lap, so that a run
        near the time limit shows which path to cut."""
        now = time.perf_counter()
        log(f"phase wall: {name} {now - t_lap[0]:.1f} s")
        t_lap[0] = now
    try:
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        GOLDEN_CHAOS_RUN.start()
        _build.build(_build_names())
        log(f"kernels built in {time.perf_counter() - t0:.1f} s "
            f"({', '.join(_build_names())})")
        check_builds()
        check_bwd_build()
        check_ssd_bwd_build()
        CPU_SIDE.start()
        DRYRUN.start()
        lap("builds and their reports")

        check_launch_floor(torch, dev)
        results["cloudlet_finish"] = check_cloudlet_finish(
            "case1b", 8000, 1000, 1016008, torch, dev)
        check_cloudlet_finish("case2b", 262144, 50000, 1072, torch, dev)
        check_cloudlet_finish("skewed", 8192, 60, 3000, torch, dev, skew=3)
        check_unpooled(torch, dev, launches)
        check_tropical_product("sockshop", 60, 13, torch, dev)
        results["tropical_matmul"] = check_tropical_product(
            "fleet", 8, 1024, torch, dev)
        results["tropical_closure"] = check_tropical_closure(
            "sockshop", 60, 13, SOCKSHOP_DEPTH, torch, dev)
        check_link_share("sockshop", 8192, 10, torch, dev)
        results["link_share"] = check_link_share("case1b+net", 8000, 15,
                                                 torch, dev)
        check_link_share("case2b+net", 262144, 781, torch, dev)
        check_link_share_cut("case1b+net chaos", 8000, 15, torch, dev)
        check_cloudlet_finish_batched("sockshop", 8, 8192, 60, 82756,
                                      torch, dev)
        check_cloudlet_finish_batched("case2b", 4, 262144, 50000, 1072,
                                      torch, dev)
        check_link_share_batched("sockshop", 8, 8192, 10, torch, dev)
        check_link_share_batched("case2b+net", 2, 262144, 781, torch, dev)
        check_flash("T=4096", 1, 16, 8, 4096, 128, torch, dev, 20)
        results["flash_attention"] = check_flash(
            "prefill_32k", 1, 16, 8, prefill_len(), 128, torch, dev, 3)
        # the moe family's prefill heads: qwen3-moe-30b-a3b (GQA group 8)
        # and qwen2-moe-a2.7b (MHA); granite-20b's MQA at T=4096
        check_flash("qwen3-moe prefill_32k", 1, 32, 4, prefill_len(), 128,
                    torch, dev, 3)
        check_flash("qwen2-moe prefill_32k", 1, 16, 16, prefill_len(), 128,
                    torch, dev, 3)
        check_flash("granite MQA T=4096", 1, 48, 1, 4096, 128, torch, dev,
                    20)
        # the vlm and encdec prefills' heads: qwen2-vl-7b (GQA group 7);
        # whisper-base's encoder (1,500 frames, ragged against the 128-key
        # tile), its decoder's self-attention and its cross-attention
        check_flash("qwen2-vl prefill_32k", 1, 28, 4, prefill_len(), 128,
                    torch, dev, 3)
        # jamba-1.5-large's attention layer: 64/8 heads (GQA group 8)
        check_flash("jamba prefill_32k", 1, 64, 8, prefill_len(), 128,
                    torch, dev, 3)
        check_flash("whisper encoder", 1, 8, 8, 1500, 64, torch, dev, 20,
                    causal=False)
        check_flash("whisper decoder self", 1, 8, 8, prefill_len(), 64,
                    torch, dev, 3)
        check_flash("whisper cross", 1, 8, 8, prefill_len(), 64, torch,
                    dev, 3, causal=False, Tk=1500)
        check_ssd("CUDA cores, L=16", 24, 8, 16, 64, 128, torch, dev)
        check_ssd("K=32", 24, 32, 128, 64, 128, torch, dev)
        results["ssd_chunk"] = check_ssd(
            "prefill_32k", 24, prefill_len() // 128, 128, 64, 128, torch, dev)
        # mamba2-130m's training forward (B 8, T 4096): 8 B/C rows of 24
        # heads, 24 heads a block
        check_ssd("mamba2-130m train_4k forward", 24 * SSM_TRAIN_BATCH,
                  TRAIN_SEQ // 128, 128, 64, 128, torch, dev,
                  group=24)
        # jamba-1.5-large's prefill: 128 heads of width 128, one B/C group
        check_ssd("jamba prefill_32k, P=128", 128, prefill_len() // 128,
                  128, 128, 128, torch, dev)
        lap("kernels against their plain versions")
        check_golden(torch, dev)
        GOLDEN_CHAOS_RUN.result()
        lap("golden scenario and chaos combos")

        figs = {"case1b": run_capacity("case1b", 2, torch, dev, launches)}
        run_capacity("case1b+net", 1, torch, dev, launches)
        run_capacity("case2b", 1, torch, dev, launches)
        for tag in CHAOS_CASES:
            figs[tag] = run_capacity(tag, 1, torch, dev, launches)
        overhead(figs, CHAOS_CASES)
        lap("Table 2 cells")
        run_sockshop(launches)
        run_sweep8(launches)
        run_chaos_study(launches)
        lap("SockShop, sweep8, chaos study")
        run_obs(figs, torch, dev, launches)
        lap("observability")
        run_fabric_sweep(run_sockshop_fabric(launches))
        run_fleet_alg2(torch, dev, launches)
        run_twin(torch, dev, launches)
        run_twins(torch, dev, launches)
        lap("fabric SockShop, fleet Alg 2, the twins of examples/")
        run_simcheck(figs, torch, dev)
        lap("simcheck")
        for arch in SERVE_ARCHS:
            run_prefill(served_tag(arch), torch, dev, launches,
                        cfg=served_cfg(arch))
        run_prefill(JAMBA, torch, dev, launches, cfg=jamba_period())
        lap("prefill")
        for arch, kw in TWO_LAYER_CASES:
            check_two_layer(arch, torch, dev, **kw)
        lap("2-layer card against CPU")
        for arch in SERVE_ARCHS:
            run_serve(arch, torch, dev, cfg=served_cfg(arch),
                      tag=served_tag(arch))
        run_serve(JAMBA, torch, dev, cfg=jamba_period(),
                  tag=f"{JAMBA} (one period, {JAMBA_EXPERTS} experts)")
        from repro_torch.configs import get_config
        for arch in INT8_SERVE_ARCHS:
            run_serve(arch, torch, dev, cfg=dataclasses.replace(
                get_config(arch), kv_dtype="int8"),
                tag=f"{arch} kv_dtype=int8")
        lap("serve")
        t_train = time.perf_counter()
        # the training forward (with the rows' log-sum-exp) at train_4k
        check_flash("qwen3-0.6b train_4k forward", TRAIN_BATCH, 16, 8,
                    TRAIN_SEQ, 128, torch, dev, 20, lse=True)
        # the backward: bf16 at D 64 and 128 on the tensor-core kernels,
        # float32 and bf16 at D 32 on the CUDA-core ones
        results["flash_attention_bwd"] = check_flash_bwd(
            "qwen3-0.6b train_4k", TRAIN_BATCH, 16, 8, TRAIN_SEQ, TRAIN_SEQ,
            128, "bfloat16", True, torch, dev, n_time=5)
        check_flash_bwd("whisper cross", 1, 8, 8, TRAIN_SEQ, 1500, 64,
                        "bfloat16", False, torch, dev, n_time=5)
        check_flash_bwd("presets' heads", 4, 4, 2, 1024, 1024, 64,
                        "bfloat16", True, torch, dev)
        check_flash_bwd("ragged", 2, 16, 8, 1000, 1000, 128, "bfloat16",
                        True, torch, dev)
        check_flash_bwd("non-causal", 1, 8, 8, 777, 1500, 64, "bfloat16",
                        False, torch, dev)
        check_flash_bwd("group 7", 1, 28, 4, 1000, 1000, 128, "bfloat16",
                        True, torch, dev)
        check_flash_bwd("granite-20b MQA", 1, 48, 1, TRAIN_SEQ, TRAIN_SEQ,
                        128, "bfloat16", True, torch, dev)
        check_flash_bwd("float32", 1, 16, 8, 1024, 1024, 128, "float32",
                        True, torch, dev, n_time=3)
        check_flash_bwd("D=32", 1, 16, 8, 1024, 1024, 32, "bfloat16",
                        True, torch, dev, n_time=3)
        run_train_full(torch, dev, launches)
        check_train_two_layer(torch, dev)
        # the SSD backward: mamba2-130m's training shape (B 8, T 4096: one
        # B/C row for 24 heads a sequence) and jamba-1.5-large's (B 1, T
        # 4096: one row of 128 heads of width 128), several slices of a
        # row's heads, four rows of 4 heads, and the reduced configs'
        # chunk of 16 (the CUDA-core pair)
        results["ssd_chunk_bwd"] = check_ssd_bwd(
            "mamba2-130m train_4k", 24 * SSM_TRAIN_BATCH, TRAIN_SEQ // 128,
            128, 64, 128, 24, torch, dev, n_time=5)
        check_ssd_bwd("jamba train_4k, P=128", 128, TRAIN_SEQ // 128, 128,
                      128, 128, 128, torch, dev, n_time=5)
        check_ssd_bwd("several slices", 32, 4, 128, 64, 128, 16, torch, dev)
        check_ssd_bwd("group 4", 16, 8, 128, 64, 128, 4, torch, dev)
        check_ssd_bwd("L=N=P=16", 48, 8, 16, 16, 16, 24, torch, dev)
        run_train_full(torch, dev, launches, arch=SSM_TRAIN_ARCH,
                       batch_size=SSM_TRAIN_BATCH)
        check_train_two_layer(torch, dev, arch=SSM_TRAIN_ARCH)
        run_train_tiny(torch, dev)
        lap("training: dense and ssm")
        # the moe, vlm, encdec and hybrid families (ROADMAP 15(d3)): the
        # 2-layer steps first (the CPU-side process is done with the
        # card's memory once their results are in), then the full runs
        for arch, kw in TRAIN_TWO_LAYER:
            check_train_two_layer(torch, dev, arch=arch, **kw)
        lap("training: 2-layer steps of the families, card against CPU")
        for arch, batch_size, over, batches in TRAIN_FAMILIES:
            run_train_full(torch, dev, launches, arch=arch,
                           batch_size=batch_size, over=over,
                           batches=batches)
        lap("training: moe, vlm, encdec, hybrid")
        log(f"training phases {time.perf_counter() - t_train:.1f} s")
        run_dist(torch, dev)
        lap("dist: elastic reshard")
        check_dryrun()
        lap("dry run (its child's records)")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        CPU_SIDE.stop()
        GOLDEN_CHAOS_RUN.stop()
        DRYRUN.stop()
    src = {
        "cloudlet_finish": ("src/repro_torch/csrc/cloudlet_finish.cu",
                            "src/repro/kernels/cloudlet_step/kernel.py:102"),
        "tropical_matmul": ("src/repro_torch/csrc/tropical.cu",
                            "src/repro/kernels/tropical/kernel.py:43"),
        "tropical_closure": ("src/repro_torch/csrc/tropical.cu",
                             "src/repro/kernels/tropical/kernel.py:43"),
        "link_share": ("src/repro_torch/csrc/link_share.cu",
                       "src/repro/kernels/link_share/kernel.py:42"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:78"),
        "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                      "src/repro/kernels/ssd_scan/kernel.py:60"),
        # the reference's backwards are recompute VJPs, no Pallas kernels
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention/ops.py:56"),
        "ssd_chunk_bwd": ("src/repro_torch/csrc/ssd_chunk_bwd.cu",
                          "src/repro/kernels/ssd_scan/ops.py:76")}
    kernels = []
    for name, (path, replaces) in src.items():
        r = results[name]
        n = launches.get(name, 0)
        if n <= 0:
            print(f"chip_smoke: {name} was not launched on the main path",
                  file=sys.stderr)
            return 1
        kernels.append(dict(
            name=name, route="cuda", source=path, replaces=replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r.get("bound_by", "bytes"),
            library_ms=r.get("library_ms")))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _build_names():
    from repro_torch.kernels import KERNELS
    return list(KERNELS)


def golden_chaos_main() -> int:
    """The child process of ``GoldenChaos``."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        check_golden_chaos(torch, torch.device("cuda"))
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    if GOLDEN_CHAOS_FLAG in sys.argv:
        sys.exit(golden_chaos_main())
    if DRYRUN_FLAG in sys.argv:
        sys.exit(dryrun_main(sys.argv[sys.argv.index(DRYRUN_FLAG) + 1]))
    if CPU_SIDE_FLAG in sys.argv:
        sys.exit(cpu_side_main(sys.argv[sys.argv.index(CPU_SIDE_FLAG) + 1]))
    sys.exit(main())
