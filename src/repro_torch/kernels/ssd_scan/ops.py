"""Mamba-2 SSD layer: the intra-chunk part in the CUDA kernels of
``csrc/ssd_chunk.cu`` on a CUDA tensor (the plain ``ref.ssd_chunk`` on a
CPU tensor, an error on anything else); the zero-Δ pad to the chunk, the
inter-chunk recurrence and the carried-state term in PyTorch around it,
as the reference keeps them outside its Pallas kernel.

The C entry point picks the kernel from the chunk length L, the state
width N and the head width P, by the rule ``route`` states: L 64 or 128,
N 64 or 128 and P 64 (Mamba-2's head width; mamba2-130m's prefill is
L = N = 128) go to the tensor-core kernel ``ssd_chunk_sm90`` (3xTF32
wgmma, C·Bᵀ once per chunk and B/C group), every other shape (ragged or
short chunks, other widths) to the CUDA-core ``ssd_chunk_kernel``.  One
launch a call; a failed build or launch raises, and nothing retries the
other kernel.  The kernels have no backward yet: on the card, a call in
grad mode with an input that requires a gradient raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, launched
from . import ref

_SMEM_BYTES = 232_448          # what one Hopper block may hold
CUDA_CORES = 0      # ``ssd_chunk_kernel``
TENSOR_CORES = 1    # ``ssd_chunk_sm90``
SM90_CHUNKS = (64, 128)
SM90_STATES = (64, 128)
SM90_HEAD_DIMS = (64,)


def route(L: int, N: int, P: int) -> int:
    """The kernel that the C entry point runs for chunks of L, state width
    N and head width P."""
    if L in SM90_CHUNKS and N in SM90_STATES and P in SM90_HEAD_DIMS:
        return TENSOR_CORES
    return CUDA_CORES


def heads_per_block(K: int, groups: int, heads: int, sms: int) -> int:
    """The heads of one B/C group that one block of ``ssd_chunk_sm90``
    takes, for K chunks, ``groups`` groups of ``heads`` heads and a card
    of ``sms`` SMs (one block per SM).  A block pays about one head's
    time for its B/C load and C·Bᵀ, then one per head, and the grid runs
    in waves of ``sms`` blocks: the rule takes the slice with the fewest
    waves × (heads + 1), the larger slice on a tie.  mamba2-130m's
    prefill (K = 256, one group of 24) keeps 24 heads a block (256
    blocks, two waves); K = 32 takes 6 (128 blocks, one wave)."""
    best, pick = None, heads
    for hpb in range(heads, 0, -1):
        blocks = K * groups * -(-heads // hpb)
        cost = -(-blocks // sms) * (hpb + 1)
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


def ssd_chunk(x, dt, la, b, c, group: int = 1):
    """Intra-chunk SSD over every (batch·head, chunk): x [M, K, L, P];
    dt, la [M, K, L, 1]; b, c [M / group, K, L, N], all float32 (row m
    reads B/C row m // group).  Returns (y [M,K,L,P], state [M,K,N,P],
    in_decay [M,K,L,1], total_decay [M,K,1,1])."""
    dev = x.device
    if dev.type == "cpu":
        return ref.ssd_chunk(x, dt, la, b, c, group)
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk runs on cuda or cpu, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, la, b, c)):
        # the kernel's outputs carry no grad_fn: a gradient would stop here
        raise NotImplementedError(
            "ssd_chunk has no backward kernel yet: training the ssm family "
            "(mamba2-130m) on the card comes with the ssd_chunk backward "
            "slice; the CPU path differentiates through ref.ssd_chunk")
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
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        hpb = heads_per_block(K, M // group, group, sms)
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
