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
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, launched
from . import ref

HEAD_DIMS = (16, 32, 64, 128)      # the kernels' compiled head widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CUDA_CORES = 0        # ``flash_fwd``
TENSOR_CORES = 1      # ``flash_fwd_sm90``, P = bf16 hi + bf16 lo
SM90_HEAD_DIMS = (64, 128)


def route(dtype: torch.dtype, head_dim: int) -> int:
    """The kernel that the C entry point runs for inputs of this type
    and head width."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return TENSOR_CORES
    return CUDA_CORES


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
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
    return launch(q, k, v, causal, scale)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           scale: float | None) -> torch.Tensor:
    """``attention`` on the card: one launch of ``route``'s kernel."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu, not {dev}")
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
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, Tq, Tk, D, int(bool(causal)),
                 ref.masked_row_denominator(Tk), scale, _DTYPES[q.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err}")
    launched("flash_attention")
    return out
