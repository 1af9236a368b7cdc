"""Model-zoo foundations: declarative parameter schemas and shared layers.

Every parameter is declared once as a :class:`P` (shape, logical axes,
init, dtype) inside a nested-dict schema; ``initialize(schema, gen)``
materialises it on the generator's device, ``abstract(schema)`` gives
meta tensors of each leaf's shape and type (the dry run's stand-ins, no
allocation), and ``logical_axes(schema)`` the logical-axis tree that
``dist.sharding`` resolves against a mesh.  The layers are pure functions
over parameter dicts with float32 math and bfloat16 storage, as the
reference's ``repro.models.common`` computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from ..dist.sharding import constrain, is_dtensor


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter declaration."""

    shape: tuple
    axes: tuple              # logical axis name (or None) per dim
    init: str = "normal"     # normal | zeros | ones | small_normal | alog
    scale: float | None = None
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_schema(f: Callable[[P], Any], schema) -> Any:
    """``f`` over every :class:`P` leaf of a nested-dict schema."""
    if isinstance(schema, P):
        return f(schema)
    return {k: map_schema(f, v) for k, v in schema.items()}


def abstract(schema, device="meta") -> Any:
    """A tensor of each leaf's shape and type on ``device`` (``meta``: no
    storage), the counterpart of the reference's ``ShapeDtypeStruct``s."""
    return map_schema(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                            device=device), schema)


def logical_axes(schema) -> Any:
    """The logical-axis tuple of every leaf, in the schema's structure."""
    return map_schema(lambda p: p.axes, schema)


def tree_to(tree, device) -> Any:
    """A nested dict of tensors moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: tree_to(v, device) for k, v in tree.items()}


def n_params(schema) -> int:
    total = 0

    def count(p):
        nonlocal total
        total += math.prod(p.shape)
    map_schema(count, schema)
    return total


def initialize(schema, generator: torch.Generator, device) -> Any:
    """Materialise ``schema`` on ``device``, drawn from ``generator`` on the
    generator's own device.  Leaves are drawn in the schema's order:
    normal leaves ~ N(0, scale²) with scale ``shape[-1] ** -0.5`` unless
    given (0.02 for ``small_normal``), ``alog`` = log U[1, 16].  A leaf
    stacked over layers (once, or twice as the hybrid's layers inside
    its periods) is drawn one layer at a time into the finished tensor,
    so no float32 copy of a whole stack is ever alive (a qwen3-moe-30b-a3b
    expert stack would be 38.7 GB)."""
    device = torch.device(device)

    def draw(p: P, shape):
        if p.init == "alog":       # mamba A_log: log of uniform [1, 16]
            u = torch.rand(shape, generator=generator,
                           device=generator.device) * 15.0 + 1.0
            return torch.log(u)
        scale = p.scale if p.scale is not None else p.shape[-1] ** -0.5
        if p.init == "small_normal":
            scale = 0.02
        return torch.randn(shape, generator=generator,
                           device=generator.device) * scale

    def one(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=p.dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=p.dtype, device=device)
        if p.axes[0] != "layers":
            return draw(p, p.shape).to(device=device, dtype=p.dtype)
        out = torch.empty(p.shape, dtype=p.dtype, device=device)
        # one draw per layer, over every leading layer axis (the hybrid's
        # periods stack layers that are stacked themselves)
        n = next(i for i, a in enumerate(p.axes) if a != "layers")
        flat = out.view(-1, *p.shape[n:])
        for i in range(flat.shape[0]):
            flat[i] = draw(p, p.shape[n:])
        return out

    return map_schema(one, schema)


# ===========================================================================
# Shared layers (pure functions over param dicts; f32 math, bf16 storage)
# ===========================================================================

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def mlp_schema(d: int, f: int, dtype=torch.bfloat16):
    return {
        "gate": P((d, f), ("embed", "mlp"), dtype=dtype),
        "up": P((d, f), ("embed", "mlp"), dtype=dtype),
        "down": P((f, d), ("mlp", "embed"), dtype=dtype),
    }


def residual(t: torch.Tensor) -> torch.Tensor:
    """A block's output [B, T, d] (or [N, d]) on its way into the residual
    stream.  A DTensor is laid out by its logical axes, batch split and
    embed whole: the row-split output projection leaves partial sums,
    reduced here once (the reference's XLA partitioner reduces them where
    it plans to), so no nonlinear op after it meets a partial sum."""
    axes = ("batch", "seq", "embed") if t.dim() == 3 else ("batch", "embed")
    return constrain(t, axes)


def apply_mlp(p, x):
    return residual(swiglu(x, p["gate"], p["up"], p["down"]))


def rope_freqs(head_dim: int, theta: float = 1e6) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


_ROPE_INV: dict = {}


def _rope_inv(head_dim: int, theta: float, device) -> torch.Tensor:
    """The float32 inverse frequencies on ``device``, copied there once
    (a host-to-device copy per decode step would synchronise)."""
    key = (head_dim, float(theta), device)
    inv = _ROPE_INV.get(key)
    if inv is None:
        inv = torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)
        if not is_fake(inv):    # a fake mode's tensor dies with the mode
            _ROPE_INV[key] = inv
    return inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x [B, T, H, Dh]; positions [B, T] int."""
    Dh = x.shape[-1]
    inv = _rope_inv(Dh, theta, x.device)
    ang = positions.float()[..., None] * inv                 # [B,T,Dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


_MROPE_SEL: dict = {}


def _mrope_sel(sections, head_dim: int, device) -> torch.Tensor:
    """M-RoPE's band selector on ``device``: entry j of the Dh/2 frequency
    bands names the position row (t, h or w) that drives it.  Built on
    the host from the static ``sections`` and copied once per device."""
    key = (tuple(sections), head_dim, device)
    sel = _MROPE_SEL.get(key)
    if sel is None:
        host = np.zeros((head_dim // 2,), np.int64)
        off = 0
        for i, s in enumerate(sections):
            host[off:off + s] = i
            off += s
        assert off == head_dim // 2, (sections, head_dim)
        sel = torch.from_numpy(host).to(device)
        if not is_fake(sel):
            _MROPE_SEL[key] = sel
    return sel


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections,
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL M-RoPE: x [B, T, H, Dh]; positions3 [3, B, T] (t/h/w);
    ``sections`` splits the Dh/2 frequency bands among the three rows
    (e.g. (16, 24, 24)).  Band j turns by row sel[j]'s position times
    inv[j], the reference's product, so the angles are its bits."""
    Dh = x.shape[-1]
    inv = _rope_inv(Dh, theta, x.device)
    sel = _mrope_sel(sections, Dh, x.device)
    pos = positions3.float().index_select(0, sel)            # [Dh/2,B,T]
    ang = pos.permute(1, 2, 0) * inv                         # [B,T,Dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoid_positions(t: int, d: int) -> np.ndarray:
    """Whisper's sinusoidal positions [t, d] float32, on the host."""
    pos = np.arange(t)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / (10000 ** (dim / d))
    out = np.zeros((t, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` [V, d] at ``tokens`` [B, T].  A DTensor table
    is gathered whole on every device (an all-gather of a vocab-split
    table), and each device looks up the rows of its own tokens: DTensor's
    rules for an index gather or an embedding over a split table and
    tokens split over two mesh dims differ between torch releases, and
    some refuse.  The rows take the tokens' placements; the table's
    gradient is a partial sum over the mesh dims that split the tokens."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
    grad = [Partial() if p.is_shard() else Replicate()
            for p in tokens.placements]
    rows = whole.to_local(grad_placements=grad)[tokens.to_local()]
    shape = tuple(tokens.shape) + tuple(table.shape[1:])
    return residual(DTensor.from_local(
        rows, mesh, tokens.placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride()))


def unembed(x: torch.Tensor, emb_or_head: torch.Tensor) -> torch.Tensor:
    """Logits in f32."""
    return x.float() @ emb_or_head.float()


def masked_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's training loss: the cross entropy of float32
    ``logits`` [B, T, V] against ``labels`` [B, T], the mean over the
    positions whose label is not negative (0-d float32)."""
    mask = (labels >= 0).float()
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.clamp_min(0).reshape(-1).long(),
                          reduction="none").reshape(labels.shape)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
