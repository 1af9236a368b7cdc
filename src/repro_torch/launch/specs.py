"""Input stand-ins and step builders for every (arch × shape) dry-run cell,
as the reference's ``repro.launch.specs`` builds them.

``input_specs(cfg, shape)`` gives a meta tensor (no storage) of every
model input's shape and type; ``build_cell`` pairs the step a cell runs
with its arguments laid out on a mesh by the logical-axis rules:

  train_*   → the full ``train_step`` (forward, backward, AdamW update,
              written into the parameters and moments in place, as the
              reference donates them)
  prefill_* → the forward's logits of the last position
  decode_*  → one ``decode_step`` against a seq_len-deep KV cache / SSM
              state (written in place)

The arguments are DTensors whose local shards are fake tensors (a
``FakeTensorMode`` of the cell's own, ``Cell.fake_mode``): running the
cell under that mode allocates nothing.  The port's layers are a Python
loop, so there is no ``unroll`` flag: every layer runs.  The steps run
under DTensor's ``implicit_replication``: a plain tensor the model makes
(positions, masks) joins the DTensors as a replicated one.

The decode-state axes mirror the port's state, not the reference's: the
decoder-only and hybrid states are lists of per-layer (per-period) caches
and the port's ``KVCache`` has no ``pos``, so each per-layer leaf takes
the reference's axes without the leading ``"layers"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeCfg
from ..dist import sharding as shd
from ..models import build_model
from ..models.attention import KVCache, QuantKVCache
from ..models.common import unembed
from ..models.mamba2 import MambaState
from ..train.optimizer import AdamWCfg, AdamWState
from ..train.train_step import make_train_step
from ..tree import tree_map

i32 = torch.int32
bf16 = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ===========================================================================
# Batch specs (train / prefill)
# ===========================================================================

def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        return {"embeds": _meta((B, S, cfg.d_model), bf16),
                "positions": _meta((3, B, S), i32),
                "labels": _meta((B, S), i32)}
    if cfg.family == "encdec":
        return {"frames": _meta((B, cfg.n_frames, cfg.d_model), bf16),
                "tokens": _meta((B, S), i32),
                "labels": _meta((B, S), i32)}
    return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}


def batch_logical(cfg: ArchConfig, specs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k in specs:
        if k == "positions":
            out[k] = (None, "batch", "seq")
        elif k in ("embeds", "frames"):
            out[k] = ("batch", "seq", None)
        else:
            out[k] = ("batch", "seq")
    return out


def opt_logical(param_axes) -> AdamWState:
    """The AdamW state's axes: the moments follow the parameters."""
    return AdamWState(step=(), mu=param_axes, nu=param_axes)


def abstract_opt_state(abstract_params) -> AdamWState:
    z = tree_map(lambda p: _meta(p.shape, torch.float32), abstract_params)
    return AdamWState(step=_meta((), i32), mu=z, nu=z)


# ===========================================================================
# Decode-state logical axes (mirrors the port's state structure)
# ===========================================================================

STATE_RULES = dict(shd.ACT_RULES)
STATE_RULES["seq"] = ("model",)        # the KV cache may shard its time axis
STATE_RULES["heads"] = ("model",)

_KV = ("batch", "kv_heads", "seq", None)


def _kv_axes(quant: bool = False):
    if quant:
        return QuantKVCache(k=_KV, v=_KV, k_scale=_KV[:3], v_scale=_KV[:3])
    return KVCache(k=_KV, v=_KV)


def _mamba_axes():
    return MambaState(h=("batch", "heads", "state", None),
                      conv=("batch", None, "mlp"))


def decode_state_logical(model, cfg: ArchConfig):
    from ..models.encdec import EncDec, EncDecState
    from ..models.hybrid import HybridLM
    from ..models.transformer import DecodeState
    if isinstance(model, EncDec):        # stacked over layers, as the
        lay = ("layers",) + _KV          # reference's
        fr = ("layers", "batch", "kv_heads", "frames", None)
        return EncDecState(self_kv=KVCache(k=lay, v=lay),
                           cross_kv={"k": fr, "v": fr}, pos=())
    if isinstance(model, HybridLM):
        return DecodeState(
            layers=[{"kv": _kv_axes(),
                     "mamba": [_mamba_axes() for _ in range(model.n_mamba)]}
                    for _ in range(model.n_periods)], pos=())
    if model.is_mamba:
        return DecodeState(layers=[_mamba_axes()
                                   for _ in range(cfg.n_layers)], pos=())
    return DecodeState(layers=[_kv_axes(quant=cfg.kv_dtype == "int8")
                               for _ in range(cfg.n_layers)], pos=())


# ===========================================================================
# Step builders
# ===========================================================================

@dataclasses.dataclass
class Cell:
    fn: Callable
    args: Tuple            # DTensors over fake local shards
    in_shardings: Tuple    # ``NamedSharding`` trees, one per argument
    fake_mode: Any         # the ``FakeTensorMode`` to run ``fn`` under


def place(abstract_tree, shardings, mesh):
    """A DTensor per leaf: a fake local shard of the leaf's shard shape
    under the sharding's placements (no communication, no storage).
    Call under a ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor

    def one(a, sh):
        local = torch.empty(sh.shard_shape(a.shape), dtype=a.dtype)
        return DTensor.from_local(
            local, mesh, sh.placements(), run_check=False,
            shape=tuple(a.shape), stride=_meta(a.shape, a.dtype).stride())
    return tree_map(one, abstract_tree, shardings)


def _replicating(fn):
    @functools.wraps(fn)
    def run(*args):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args)
    return run


def build_cell(cfg: ArchConfig, shape: ShapeCfg, mesh,
               opt_cfg: AdamWCfg | None = None) -> Cell:
    """The step of the (``cfg`` × ``shape``) cell and its arguments on
    ``mesh`` (a ``DeviceMesh``: the dry run's is over a fake world)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build_model(cfg)
    abstract_params = model.abstract_params()
    param_axes = model.param_logical_axes()
    p_shard = shd.tree_shardings(mesh, abstract_params, param_axes,
                                 shd.PARAM_RULES)
    # DTensor's planning reads back small index tensors of its own, made
    # outside the fake mode (``comm_analysis.record``); they join the
    # fake shards as constants
    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def act(specs, axes, rules=shd.ACT_RULES):
        return shd.tree_shardings(mesh, specs, axes, rules)

    with fake:
        params = place(abstract_params, p_shard, mesh)

    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWCfg()
        opt_abs = abstract_opt_state(abstract_params)
        o_shard = shd.tree_shardings(mesh, opt_abs, opt_logical(param_axes),
                                     shd.PARAM_RULES)
        specs = input_specs(cfg, shape)
        b_shard = act(specs, batch_logical(cfg, specs))
        with fake:
            args = (params, place(opt_abs, o_shard, mesh),
                    place(specs, b_shard, mesh))
        fn = make_train_step(model, opt_cfg, donate=True)
        return Cell(fn=_replicating(fn), args=args,
                    in_shardings=(p_shard, o_shard, b_shard),
                    fake_mode=fake)

    if shape.kind == "prefill":
        specs = input_specs(cfg, shape)
        specs.pop("labels")
        b_shard = act(specs, batch_logical(cfg, specs))
        with fake:
            batch = place(specs, b_shard, mesh)

        def prefill_step(params, batch):
            with torch.no_grad():
                if cfg.family == "encdec":
                    enc = model.encode(params, batch["frames"])
                    h = model.decode_train(params, batch["tokens"], enc)
                    return unembed(h[:, -1:], params["embed"].T)
                h = model.hidden_states(
                    params, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"),
                    positions=batch.get("positions"))
                return model.logits(params, h[:, -1:])

        return Cell(fn=_replicating(prefill_step), args=(params, batch),
                    in_shardings=(p_shard, b_shard), fake_mode=fake)

    # decode: one new token against a seq_len-deep cache/state
    B = shape.global_batch
    state_abs = model.init_decode_state(B, shape.seq_len, device="meta")
    s_shard = shd.tree_shardings(mesh, state_abs,
                                 decode_state_logical(model, cfg),
                                 STATE_RULES)
    tok = {"t": _meta((B, 1), i32)}
    t_shard = act(tok, {"t": ("batch", None)})
    with fake:
        state = place(state_abs, s_shard, mesh)
        tokens = place(tok, t_shard, mesh)["t"]

    def serve_step(params, tokens, state):
        with torch.no_grad():
            return model.decode_step(params, tokens, state)

    return Cell(fn=_replicating(serve_step), args=(params, tokens, state),
                in_shardings=(p_shard, t_shard["t"], s_shard),
                fake_mode=fake)
