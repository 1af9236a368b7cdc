"""Causal GQA attention: the CUDA kernels of ``csrc/flash_attention.cu`` on
a CUDA tensor, the plain version of ``ref.py`` on a CPU tensor, an error
on anything else.

The C entry point picks the kernel from the input type and head width,
by the rule ``route`` states: bfloat16 at head width 64 or 128 goes to the
tensor-core kernel ``flash_fwd_sm90`` (wgmma, TMA, P split into two bf16
terms); float32, and bfloat16 at 16 or 32, to the CUDA-core kernel
``flash_fwd``, whose float32 math keeps the float32 tolerance (TF32 would
not).

The reference pads ragged lengths to its (128, 128) blocks and masks with
the original lengths; the kernel masks the ragged edges itself, so no
padding is made here.  Fully masked rows (Tq > Tk) come out as the
reference's Pallas kernel gives them (``ref.py`` states the rule).

Gradients: on the card, when grad mode is on and q, k or v requires a
gradient, ``attention`` runs through ``FlashAttention`` (an
``autograd.Function``): its forward is the same launch with the rows'
log-sum-exp written beside the output, its backward two kernels of
``csrc/flash_attention_bwd.cu`` (``launch_bwd``: dq, then dk and dv, no
atomics), counted as ``flash_attention_bwd``, picked by the rule
``route_bwd`` states: bfloat16 at head width 64 or 128 goes to the
tensor-core kernels ``flash_bwd_dq_sm90`` and ``flash_bwd_dkdv_sm90``
(wgmma, TMA), float32 and bfloat16 at 16 or 32 to the CUDA-core
``flash_bwd_dq`` and ``flash_bwd_dkdv``.  The backward takes what
the reference's recompute VJP gives a finite gradient for: every causal
row sees a key (Tq <= Tk); it raises on the rest.  On the CPU gradients
come from autograd through ``ref.attention``.  Serving (no gradient)
launches the forward alone, as before.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, launched, reject_dtensor
from . import ref

HEAD_DIMS = (16, 32, 64, 128)      # the kernels' compiled head widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CUDA_CORES = 0        # ``flash_fwd``; ``flash_bwd_dq``, ``flash_bwd_dkdv``
TENSOR_CORES = 1      # ``flash_fwd_sm90`` (P = bf16 hi + bf16 lo);
#                       ``flash_bwd_dq_sm90``, ``flash_bwd_dkdv_sm90``
SM90_HEAD_DIMS = (64, 128)
BWD_LAUNCHES = 2      # kernel launches per backward call (dq; dk and dv)


def route(dtype: torch.dtype, head_dim: int) -> int:
    """The kernel that the C entry point runs for inputs of this type
    and head width."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return TENSOR_CORES
    return CUDA_CORES


def route_bwd(dtype: torch.dtype, head_dim: int) -> int:
    """The backward kernels that the C entry point runs for inputs of this
    type and head width: the forward's rule, for the same reason (TF32
    would break the float32 tolerance)."""
    return route(dtype, head_dim)


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _lib_bwd():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 4:
        raise ValueError(f"{name} must be [B, H, T, D], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None
              ) -> torch.Tensor:
    """q [B, Hq, Tq, D]; k, v [B, Hkv, Tk, D] → [B, Hq, Tq, D] in q's
    type (float32 or bfloat16 on the card; f32 softmax statistics)."""
    dev = q.device
    if dev.type == "cpu":
        if k.device != dev or v.device != dev:
            raise ValueError(f"q, k, v on {q.device}, {k.device}, "
                             f"{v.device}")
        return ref.attention(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    return launch(q, k, v, causal, scale)


class FlashAttention(torch.autograd.Function):
    """Attention on the card with the hand-written backward: the forward
    saves q, k, v, the output and the rows' log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if causal and q.shape[2] > k.shape[2]:
            raise ValueError(
                f"the attention backward takes causal rows that see a key "
                f"(Tq <= Tk), got Tq {q.shape[2]} > Tk {k.shape[2]}")
        out, lse = launch(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = launch_bwd(q, k, v, out, dout.contiguous(), lse,
                                ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           scale: float | None, with_lse: bool = False):
    """``attention`` on the card: one launch of ``route``'s kernel.  With
    ``with_lse`` also the rows' log-sum-exp (float32 ``[B, Hq, Tq]``,
    natural log of the sum of exp(scale·q·k) over the visible keys):
    returns ``(out, lse)``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {dev}")
    reject_dtensor("kernels.flash_attention.ops.launch", q, k, v)
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, not "
                        f"{q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, q.dtype, dev)
    B, Hq, Tq, D = q.shape
    Bk, Hkv, Tk, Dk = k.shape
    if Bk != B or Dk != D or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if Tq < 1 or Tk < 1 or B > 65535 or Hq > 65535:
        raise ValueError(f"empty or oversized attention {tuple(q.shape)}")
    if route(q.dtype, D) == TENSOR_CORES:
        if Tq > 65535 * 128:
            raise ValueError(f"{Tq} query rows exceed the grid")
        # TMA reads from 16-byte aligned addresses
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    scale = (D ** -0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=dev) \
        if with_lse else None
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, Tq, Tk, D, int(bool(causal)),
                 ref.masked_row_denominator(Tk), scale,
                 None if lse is None else lse.data_ptr(), _DTYPES[q.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    launched("flash_attention")
    return (out, lse) if with_lse else out


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
               causal: bool, scale: float | None):
    """dq, dk, dv of ``attention`` on the card (the dq kernel, then the
    dk/dv kernel of ``route_bwd``'s pair), in q's type, from the forward's
    ``out`` and ``lse`` (``launch(..., with_lse=True)``) and the gradient
    ``dout``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the attention backward runs on cuda, not {dev}")
    reject_dtensor("kernels.flash_attention.ops.launch_bwd", q, k, v, out,
                   dout, lse)
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, not "
                        f"{q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"),
                    (dout, "dout")):
        _check(t, name, q.dtype, dev)
    if lse.device != dev or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 tensor on "
                         f"{dev}")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if tuple(out.shape) != tuple(q.shape) \
            or tuple(dout.shape) != tuple(q.shape) \
            or tuple(lse.shape) != (B, Hq, Tq) \
            or tuple(v.shape) != tuple(k.shape) or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"backward shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)}")
    if Hkv < 1 or Hq % Hkv or D not in HEAD_DIMS:
        raise ValueError(f"{Hq} query heads over {Hkv} KV heads at head "
                         f"width {D}")
    if causal and Tq > Tk:
        raise ValueError(f"causal rows without a visible key (Tq {Tq} > "
                         f"Tk {Tk}) have no finite gradient")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"oversized attention {tuple(q.shape)}")
    if route_bwd(q.dtype, D) == TENSOR_CORES:
        if max(Tq, Tk) > 65535 * 128:
            raise ValueError(f"{max(Tq, Tk)} rows exceed the grid")
        # TMA and the Δ prologue read from 16-byte aligned addresses
        q, k, v, out, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                              for t in (q, k, v, out, dout))
    scale = (D ** -0.5) if scale is None else float(scale)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, Hq, Tq), dtype=torch.float32, device=dev)
    err = _lib_bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     delta.data_ptr(), B, Hq, Hkv, Tq, Tk, D,
                     int(bool(causal)), scale, _DTYPES[q.dtype],
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    for _ in range(BWD_LAUNCHES):
        launched("flash_attention_bwd")
    return dq, dk, dv
