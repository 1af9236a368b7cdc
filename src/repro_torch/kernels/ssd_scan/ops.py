"""Mamba-2 SSD layer: the intra-chunk part in the CUDA kernels of
``csrc/ssd_chunk.cu`` on a CUDA tensor (the plain ``ref.ssd_chunk`` on a
CPU tensor, an error on anything else); the zero-Δ pad to the chunk, the
inter-chunk recurrence and the carried-state term in PyTorch around it,
as the reference keeps them outside its Pallas kernel.

The C entry point picks the kernel from the chunk length L, the state
width N and the head width P, by the rule ``route`` states: L 64 or 128,
N 64 or 128 and P 64 or 128 (mamba2-130m's prefill is L = N = 128, P =
64; jamba-1.5-large's P = 128 passes in two halves of 64 columns) go to
the tensor-core kernel ``ssd_chunk_sm90`` (3xTF32 wgmma, C·Bᵀ once per
chunk and B/C group), every other shape (ragged or short chunks, other
widths) to the CUDA-core ``ssd_chunk_kernel``.  One launch a call; a
failed build or launch raises, and nothing retries the other kernel.

Gradients: on the card, when grad mode is on and an input requires a
gradient, ``ssd_chunk`` runs through ``SSDChunk`` (an
``autograd.Function``): its forward is the same launch, its backward the
kernels of ``csrc/ssd_chunk_bwd.cu`` (``launch_bwd``, counted as
``ssd_chunk_bwd``, ``bwd_launches`` a call, no atomics), by the rule
``route_bwd`` states: the forward's tensor-core shapes go to three
tensor-core kernels (``ssd_bwd_ds``, ``ssd_bwd_dx``, ``ssd_bwd_db``: a
slice of a B/C row's heads a block, Σ_h dS_h on chip, no per-head
partial through memory), chunks up to 128, state widths up to 128 and
head widths up to 64 otherwise to the CUDA-core pair (``ssd_bwd_heads``,
``ssd_bwd_groups``); other shapes raise when the forward is called
under grad.  The reference has no backward kernel: its VJP recomputes
through its plain version.  On
the CPU gradients come from autograd through ``ref.ssd_chunk``.  The
carry over chunks and the carried-state term stay plain PyTorch under
autograd on both devices, as the reference keeps them outside its
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, launched, reject_dtensor
from . import ref

_SMEM_BYTES = 232_448          # what one Hopper block may hold
CUDA_CORES = 0      # ``ssd_chunk_kernel``
TENSOR_CORES = 1    # ``ssd_chunk_sm90``
SM90_CHUNKS = (64, 128)
SM90_STATES = (64, 128)
SM90_HEAD_DIMS = (64, 128)
SM90_HALF = 64      # the tensor-core kernels take a head 64 columns a pass
BWD_MAX_L = 128     # the CUDA-core backward's limits: chunk,
BWD_MAX_N = 128     # state width
BWD_MAX_P = 64      # and head width


def route(L: int, N: int, P: int) -> int:
    """The kernel that the C entry point runs for chunks of L, state width
    N and head width P."""
    if L in SM90_CHUNKS and N in SM90_STATES and P in SM90_HEAD_DIMS:
        return TENSOR_CORES
    return CUDA_CORES


def route_bwd(L: int, N: int, P: int) -> int:
    """The backward kernels a shape takes: the forward's tensor-core
    shapes (``route``) the three tensor-core kernels of
    ``csrc/ssd_chunk_bwd.cu``; else the CUDA-core pair for chunks of 1
    to ``BWD_MAX_L``, state widths up to ``BWD_MAX_N`` and head widths up
    to ``BWD_MAX_P`` (on either route every kernel's shared memory fits a
    block, as the C library's ``ssd_chunk_bwd_smem_bytes`` states); any
    other shape raises, with its reason."""
    if route(L, N, P) == TENSOR_CORES:
        return TENSOR_CORES
    if not (1 <= L <= BWD_MAX_L and 1 <= N <= BWD_MAX_N
            and 1 <= P <= BWD_MAX_P):
        raise ValueError(
            f"the ssd_chunk backward takes chunks of 64 or 128 at state "
            f"widths 64 or 128 and head widths 64 or 128, else chunks of 1 "
            f"to {BWD_MAX_L}, state widths up to {BWD_MAX_N} and head "
            f"widths up to {BWD_MAX_P}, got L={L}, N={N}, P={P}")
    return CUDA_CORES


def bwd_launches(L: int, N: int, P: int) -> int:
    """The kernel launches of one backward call: three on the tensor
    cores (``ssd_bwd_ds``, ``ssd_bwd_dx``, ``ssd_bwd_db``), two on the
    CUDA cores (``ssd_bwd_heads``, ``ssd_bwd_groups``)."""
    return 3 if route_bwd(L, N, P) == TENSOR_CORES else 2


def heads_per_block(K: int, groups: int, heads: int, sms: int,
                    halves: int = 1) -> int:
    """The heads of one B/C group that one block of a tensor-core kernel
    (``ssd_chunk_sm90``, ``ssd_bwd_ds``, ``ssd_bwd_dx``) takes, for K
    chunks, ``groups`` groups of ``heads`` heads, a card of ``sms`` SMs
    (one block per SM) and heads of ``halves`` passes of 64 columns (2 at
    head width 128).  A block pays about one pass's time for its B/C load
    and C·Bᵀ, then ``halves`` a head, and the grid runs in waves of
    ``sms`` blocks: the rule takes the slice with the fewest waves ×
    (heads × halves + 1), the larger slice on a tie.  mamba2-130m's
    prefill (K = 256, one group of 24) keeps 24 heads a block (256
    blocks, two waves); K = 32 takes 6 (128 blocks, one wave)."""
    best, pick = None, heads
    for hpb in range(heads, 0, -1):
        blocks = K * groups * -(-heads // hpb)
        cost = -(-blocks // sms) * (hpb * halves + 1)
        if best is None or cost < best:
            best, pick = cost, hpb
    return pick


def _lib():
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_chunk_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_chunk_route.argtypes = [ctypes.c_int] * 3
        lib.ssd_chunk_route.restype = ctypes.c_int
    return lib


def _lib_bwd():
    lib = _build.load("ssd_chunk_bwd")
    fn = lib.ssd_chunk_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_chunk_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssd_chunk_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_chunk_bwd_route.argtypes = [ctypes.c_int] * 3
        lib.ssd_chunk_bwd_route.restype = ctypes.c_int
    return lib


def _check(t: torch.Tensor, name: str, shape, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class SSDChunk(torch.autograd.Function):
    """``ssd_chunk`` on the card with the hand-written backward: the
    forward saves its five inputs; the backward gets the four outputs'
    gradients (zeros where an output was not used, as PyTorch
    materialises them), made contiguous."""

    @staticmethod
    def forward(ctx, x, dt, la, b, c, group):
        outs = launch(x, dt, la, b, c, group)
        ctx.save_for_backward(x, dt, la, b, c)
        ctx.group = group
        return outs

    @staticmethod
    def backward(ctx, dy, dstate, ddec, dtot):
        x, dt, la, b, c = ctx.saved_tensors
        grads = launch_bwd(x, dt, la, b, c, dy.contiguous(),
                           dstate.contiguous(), ddec.contiguous(),
                           dtot.contiguous(), ctx.group)
        return (*grads, None)


def ssd_chunk(x, dt, la, b, c, group: int = 1):
    """Intra-chunk SSD over every (batch·head, chunk): x [M, K, L, P];
    dt, la [M, K, L, 1]; b, c [M / group, K, L, N], all float32 (row m
    reads B/C row m // group).  Returns (y [M,K,L,P], state [M,K,N,P],
    in_decay [M,K,L,1], total_decay [M,K,1,1]); differentiable in its
    five inputs."""
    dev = x.device
    if dev.type == "cpu":
        return ref.ssd_chunk(x, dt, la, b, c, group)
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cuda or cpu, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, la, b, c)):
        if x.dim() == 4 and b.dim() == 4:     # else launch raises
            route_bwd(x.shape[2], b.shape[-1], x.shape[3])
        return SSDChunk.apply(x, dt, la, b, c, group)
    return launch(x, dt, la, b, c, group)


def launch(x, dt, la, b, c, group: int):
    """``ssd_chunk`` on the card: one launch of ``route``'s kernel."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cuda or cpu, not {dev}")
    reject_dtensor("kernels.ssd_scan.ops.launch", x, dt, la, b, c)
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"x and b must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(b.shape)}")
    M, K, L, P = x.shape
    N = b.shape[-1]
    if group < 1 or M % group or M > 65535 or not 1 <= L <= 128:
        raise ValueError(f"ssd_chunk takes M <= 65535 rows in groups of "
                         f"{group} and chunks of 1 to 128, got "
                         f"{tuple(x.shape)}")
    _check(x, "x", (M, K, L, P), dev)
    _check(dt, "dt", (M, K, L, 1), dev)
    _check(la, "la", (M, K, L, 1), dev)
    _check(b, "b", (M // group, K, L, N), dev)
    _check(c, "c", (M // group, K, L, N), dev)
    lib = _lib()
    if lib.ssd_chunk_smem_bytes(L, N, P) > _SMEM_BYTES:
        raise ValueError(f"ssd_chunk holds L={L}, N={N}, P={P} in more "
                         f"than {_SMEM_BYTES} bytes of shared memory")
    hpb = 1
    if route(L, N, P) == TENSOR_CORES:
        hpb = _heads_per_block(dev, K, M // group, group, P)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((M, K, L, P), **f32)
    st = torch.empty((M, K, N, P), **f32)
    dec = torch.empty((M, K, L, 1), **f32)
    tot = torch.empty((M, K, 1, 1), **f32)
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), la.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), st.data_ptr(), dec.data_ptr(),
        tot.data_ptr(), M, K, L, P, N, group, hpb,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err}")
    launched("ssd_chunk")
    return y, st, dec, tot


def _heads_per_block(dev, K, groups, heads, P):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return heads_per_block(K, groups, heads, sms, P // SM90_HALF)


def launch_bwd(x, dt, la, b, c, dy, dstate, ddec, dtot, group: int):
    """dx, ddt, dla, db, dc of ``ssd_chunk`` on the card (``route_bwd``'s
    kernels of ``csrc/ssd_chunk_bwd.cu``), for the gradients dy
    [M,K,L,P], dstate [M,K,N,P], ddec [M,K,L,1] and dtot [M,K,1,1] of its
    outputs; db and dc [M / group, K, L, N] summed over the group's
    heads: on the tensor cores Σ dS in ascending head order within a
    slice of ``heads_per_block`` heads, then over the slices in
    ascending order, and Σ w ⊙ R over all the heads in ascending order;
    on the CUDA cores both in ascending head order."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the ssd_chunk backward runs on cuda, not {dev}")
    reject_dtensor("kernels.ssd_scan.ops.launch_bwd", x, dt, la, b, c, dy,
                   dstate, ddec, dtot)
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"x and b must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(b.shape)}")
    M, K, L, P = x.shape
    N = b.shape[-1]
    if group < 1 or M % group or M > 65535:
        raise ValueError(f"ssd_chunk takes M <= 65535 rows in groups of "
                         f"{group}, got {tuple(x.shape)}")
    kind = route_bwd(L, N, P)
    G = M // group
    for t, name, shape in ((x, "x", (M, K, L, P)), (dt, "dt", (M, K, L, 1)),
                           (la, "la", (M, K, L, 1)), (b, "b", (G, K, L, N)),
                           (c, "c", (G, K, L, N)),
                           (dy, "dy", (M, K, L, P)),
                           (dstate, "dstate", (M, K, N, P)),
                           (ddec, "ddec", (M, K, L, 1)),
                           (dtot, "dtot", (M, K, 1, 1))):
        _check(t, name, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((M, K, L, P), **f32)
    ddt = torch.empty((M, K, L, 1), **f32)
    dla = torch.empty((M, K, L, 1), **f32)
    db = torch.empty((G, K, L, N), **f32)
    dc = torch.empty((G, K, L, N), **f32)
    if kind == TENSOR_CORES:
        # each slice's Σ dS and each head's Σ_j T_ij - Σ_j T_ji
        hpb = _heads_per_block(dev, K, G, group, P)
        s1 = torch.empty((-(-group // hpb), G, K, L, L), **f32)
        s2 = torch.empty((M, K, L), **f32)
    else:
        # each head's dS and w ⊙ R, which the second kernel sums per group
        hpb = 1
        s1 = torch.empty((M, K, L, L), **f32)
        s2 = torch.empty((M, K, L, N), **f32)
    lib = _lib_bwd()
    if lib.ssd_chunk_bwd_smem_bytes(L, N, P) > _SMEM_BYTES:
        raise ValueError(f"the ssd_chunk backward holds L={L}, N={N}, "
                         f"P={P} in more than {_SMEM_BYTES} bytes of "
                         f"shared memory")
    err = lib.ssd_chunk_bwd_launch(
        *(t.data_ptr() for t in (x, dt, la, b, c, dy, dstate, ddec, dtot,
                                 dx, ddt, dla, db, dc, s1, s2)),
        M, K, L, P, N, group, hpb,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd launch failed: CUDA error {err}")
    for _ in range(bwd_launches(L, N, P)):
        launched("ssd_chunk_bwd")
    return dx, ddt, dla, db, dc


def _chunked(x, dt, A, B, C, D, chunk):
    Bsz, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    K = T // chunk
    la = dt.float() * A.float()[None, None, :]

    def to_mk(v, n, d):
        # [B, T, n, d] → [B·n, K, L, d]
        return (v.reshape(Bsz, K, chunk, n, d).permute(0, 3, 1, 2, 4)
                .reshape(Bsz * n, K, chunk, d).contiguous())

    xk = to_mk(x.float(), H, P)
    dtk = to_mk(dt.float()[..., None], H, 1)
    lak = to_mk(la[..., None], H, 1)
    bk = to_mk(B.float(), G, N)          # per group: no per-head copy
    ck = to_mk(C.float(), G, N)
    y_intra, states, in_decay, total = ssd_chunk(xk, dtk, lak, bk, ck,
                                                 group=H // G)
    h_ins = ref.carry(states, total[:, :, 0, 0])        # [B·H, K, N, P]
    r = H // G
    y_carry = torch.einsum("gkln,grknp->grklp", ck,
                           h_ins.reshape(Bsz * G, r, K, N, P))
    y_carry = y_carry.reshape(Bsz * H, K, chunk, P) * in_decay
    y = (y_intra + y_carry).reshape(Bsz, H, K, chunk, P) \
        .permute(0, 2, 3, 1, 4).reshape(Bsz, T, H, P)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


def ssd(x, dt, A, B, C, D=None, chunk: int = 64):
    """Mamba-2 SSD layer, x [B, T, H, P], dt [B, T, H], A [H], B/C
    [B, T, G, N], D [H] → [B, T, H, P] in x's type."""
    T = x.shape[1]
    pad = (-T) % chunk
    if pad:
        # zero-Δ padding is inert: a = exp(0·A) = 1 and Δ·b·x = 0
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    out = _chunked(x, dt, A, B, C, D, chunk)
    return out[:, :T] if pad else out


ssd_decode_step = ref.ssd_decode_step
