"""The port's dry run (``repro_torch.launch.dryrun``, ``comm_analysis``,
``roofline``) on a fake world of 8 ranks, mesh (2, 4), at small sizes:
collective counts of known redistributions, the reduced qwen3 cells
against the reference's shard bytes, the depth calibration against the
direct count, flat_seqshard against flat, and the roofline's model FLOPs
against the reference's.  No process group outlives a test."""
import dataclasses
import logging
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import ShapeCfg as RefShapeCfg
from repro.configs import get_config as ref_config
from repro.launch import roofline as rroof
from repro.launch import specs as rspecs

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeCfg, get_config
from repro_torch.launch import comm_analysis, dryrun, roofline
from repro_torch.launch.mesh import fake_world, make_mesh

torch.set_num_threads(1)
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)

MESH = ((2, 4), ("data", "model"))
SMALL = {"train": (64, 8), "prefill": (64, 8), "decode": (64, 8)}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a process group outlived the test"


@pytest.fixture
def mesh():
    with fake_world(8):
        yield make_mesh(*MESH, device_type="cpu")


def _shape(kind):
    T, B = SMALL[kind]
    return ShapeCfg(f"{kind}_small", T, B, kind)


# ------------------------------------------------------------ comm_analysis

def _redistributed(mesh, src, dst, shape=(1024, 256)):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    fake = FakeTensorMode()
    with fake:
        local_shape = list(shape)
        for p, n in zip(src, mesh.shape):
            if p.is_shard():
                local_shape[p.dim] //= n
        t = DTensor.from_local(torch.empty(local_shape), mesh, src,
                               run_check=False, shape=shape,
                               stride=(shape[1], 1))
        with comm_analysis.record() as rec:
            out = t.redistribute(mesh, dst)
        return rec, tuple(out.to_local().shape)


def test_counts_of_known_redistributions(mesh):
    from torch.distributed.tensor import Partial, Replicate, Shard
    nbytes = 1024 * 256 * 4
    # Shard(0) → Replicate over the 4 ranks of "model": one all-gather,
    # its result (the whole tensor) per device
    rec, local = _redistributed(mesh, (Replicate(), Shard(0)),
                                (Replicate(), Replicate()))
    s = rec.summary()
    assert local == (1024, 256)
    assert s["all-gather"] == {"count": 1, "bytes": nbytes}
    assert s["total_bytes"] == nbytes
    assert all(s[k]["count"] == 0 for k in comm_analysis._COLLECTIVES
               if k != "all-gather")
    # a partial sum reduced: one all-reduce of the whole tensor
    rec, _ = _redistributed(mesh, (Replicate(), Partial()),
                            (Replicate(), Replicate()))
    assert rec.summary()["all-reduce"] == {"count": 1, "bytes": nbytes}
    # ... or scattered: one reduce-scatter, a quarter per device
    rec, local = _redistributed(mesh, (Replicate(), Partial()),
                                (Replicate(), Shard(0)))
    assert local == (256, 256)
    assert rec.summary()["reduce-scatter"] == {"count": 1,
                                               "bytes": nbytes // 4}
    # over both mesh dims at once: one all-gather each, 2 then 8 ways
    rec, _ = _redistributed(mesh, (Shard(0), Shard(1)),
                            (Replicate(), Replicate()))
    s = rec.summary()
    assert s["all-gather"]["count"] == 2
    assert s["all-gather"]["bytes"] in (nbytes + nbytes // 2,
                                        nbytes + nbytes // 4)


def test_flops_and_bytes_at_local_shapes(mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 32), mesh,
                               (Shard(0), Shard(0)), run_check=False,
                               shape=(64, 32), stride=(32, 1))
        w = DTensor.from_local(torch.empty(32, 48), mesh,
                               (Replicate(), Replicate()), run_check=False,
                               shape=(32, 48), stride=(48, 1))
        with comm_analysis.record() as rec:
            y = x @ w
        assert tuple(y.to_local().shape) == (8, 48)
    assert rec.flops == 2 * 8 * 32 * 48
    assert rec.bytes_accessed == 4 * (8 * 32 + 32 * 48 + 8 * 48)
    assert rec.summary()["total_bytes"] == 0
    assert rec.peak_bytes == 4 * 8 * 48


# ------------------------------------------------------------ cells

def _ref_argument_bytes(arch, kind, mesh_shape):
    """The sum of the reference's shard bytes over the cell's arguments,
    without its KV caches' per-layer ``pos`` (the port's cache has none)."""
    T, B = SMALL[kind]
    cell = rspecs.build_cell(ref_config(arch).reduced(),
                             RefShapeCfg(f"{kind}_small", T, B, kind),
                             JaxAbstractMesh(*mesh_shape))
    total = 0
    for (path, a), sh in zip(
            jax.tree_util.tree_flatten_with_path(cell.args)[0],
            jax.tree_util.tree_leaves(cell.in_shardings)):
        if jax.tree_util.keystr(path).endswith(".pos") and a.shape:
            continue
        total += math.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize
    return total


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_reduced_qwen3_cells(mesh, kind):
    cfg = get_config("qwen3-0.6b").reduced()
    rec = dryrun.cell_record(cfg, _shape(kind), mesh, extrapolate=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_bytes"] == _ref_argument_bytes(
        "qwen3-0.6b", kind, MESH)
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    # the batch splits over "data" only
    T, B = SMALL[kind]
    tok = rec["batch_shards"]["tokens"]
    assert tok["local"][0] == B // 2 and tok["global"][0] == B
    if kind == "train":
        # the gradients are reduced over "data" and the step writes the
        # parameters and moments in place
        assert rec["collectives"]["all-reduce"]["count"] > 0
        assert rec["memory"]["output_bytes"] \
            < rec["memory"]["argument_bytes"]


def test_extrapolation_equals_the_direct_count(mesh):
    cfg = get_config("qwen3-0.6b").reduced(n_layers=3)
    for kind in ("train", "decode"):
        direct = dryrun._run_costs(cfg, _shape(kind), mesh)
        ext = dryrun.cost_extrapolation(cfg, _shape(kind), mesh)
        assert ext["units"] == 3
        for k in dryrun._KEYS:
            assert ext[k] == direct[k], (kind, k)


def test_seqshard_cuts_the_attention_flops(mesh):
    """phi3's flat attention against flat_seqshard at the prefill: the
    query rows split over "model" cut each device's attention FLOPs.  As
    phi3's 40 heads on the 16-way "model" axis, the reduced model's 6
    heads do not divide the 4-way axis, so flat attention keeps every
    head on each device (heads that do divide split there already, each
    shard's heads on their own: ``dist.sharding.on_shards``)."""
    shape = _shape("prefill")
    flops = {}
    for impl in ("flat", "flat_seqshard"):
        cfg = get_config("phi3-medium-14b").reduced(attn_impl=impl,
                                                     n_heads=6)
        rec = dryrun.cell_record(cfg, shape, mesh, extrapolate=False)
        assert rec["status"] == "ok", rec.get("error")
        flops[impl] = rec["cost"]["flops"]
    assert flops["flat_seqshard"] < flops["flat"], flops


def test_an_op_without_a_sharding_rule_is_an_error_record(mesh,
                                                         monkeypatch):
    """An op that DTensor has no sharding rule for (``renorm``, which no
    model of the port reaches, planted in the MoE router here) makes the
    cell an error record that names it, not a run on a replicated
    fallback."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import moe
    prop = DTensor._op_dispatcher.sharding_propagator
    assert not any(isinstance(v, dict) and torch.ops.aten.renorm.default
                   in v for v in vars(prop).values())
    route = moe.route

    def planted(p, xf, cfg):
        torch.renorm(xf.float(), 2, 0, 1.0)
        return route(p, xf, cfg)

    monkeypatch.setattr(moe, "route", planted)
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    rec = dryrun.cell_record(cfg, _shape("prefill"), mesh,
                             extrapolate=False)
    assert rec["status"] == "error"
    assert "renorm" in rec["op"], rec
    assert rec["memory"]["argument_bytes"] > 0


# ------------------------------------------------------------ repairs

@pytest.mark.parametrize("arch,kind", [("qwen3-moe-30b-a3b", "prefill"),
                                       ("qwen2-moe-a2.7b", "train")])
def test_moe_cell_runs_on_the_scatter_add_rule(mesh, arch, kind):
    """The MoE dispatch's expert counts (a ``scatter_add_`` of ones into a
    replicated table) and, in training, the combine's backward (an
    ``index_add``) run on the port's registered strategies: the reduced
    cells are ``ok``."""
    cfg = get_config(arch).reduced()
    rec = dryrun.cell_record(cfg, _shape(kind), mesh, extrapolate=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cost"]["flops"] > 0


def test_mamba2_train_on_two_pods_is_ok():
    """mamba2-130m train_4k on 2×16×16 (24 heads, which the 16-way "model"
    axis does not divide) at full width, cut to one layer (each layer
    makes the same reshapes): the Mamba reshapes go through
    ``sharding.reshape`` and the SSD runs on each batch shard."""
    from repro_torch.launch.mesh import make_production_mesh
    shape = next(s for s in SHAPES if s.name == "train_4k")
    cfg = dryrun._variant(get_config("mamba2-130m"), 1)
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        rec = dryrun.cell_record(cfg, shape, mesh, extrapolate=False)
    assert rec["status"] == "ok", rec.get("error")
    tok = rec["batch_shards"]["tokens"]
    assert tok["global"][0] == 32 * tok["local"][0]


@pytest.mark.parametrize("op", ["scatter_add", "index_add"])
def test_add_rules_cover_replicated_and_partial(mesh, op):
    """The registered scatter-add and ``index_add`` strategies: all
    replicated, and the index and the added rows sharded along those rows
    with the output (and ``self``) a partial sum, exact on each rank's
    shard (the fake group moves nothing, so rank 0's local values are its
    own partial)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    idx = torch.tensor([0, 2, 2, 1, 3, 0, 1, 1])
    src = torch.arange(8, dtype=torch.float32)
    base = torch.full((4,), 10.0)
    add = ((lambda t, i, v: t.scatter_add(0, i, v)) if op == "scatter_add"
           else (lambda t, i, v: t.index_add(0, i, v)))
    add_ = ((lambda t, i, v: t.scatter_add_(0, i, v)) if op == "scatter_add"
            else (lambda t, i, v: t.index_add_(0, i, v)))
    rep = (Replicate(), Replicate())
    out = add(DTensor.from_local(base.clone(), mesh, rep),
              DTensor.from_local(idx, mesh, rep),
              DTensor.from_local(src, mesh, rep))
    assert tuple(out.placements) == rep
    assert torch.equal(out.to_local(), add(base, idx, src))
    sh = (Replicate(), Shard(0))      # 4 ranks on "model": 2 each
    mine = DTensor.from_local(base.clone(), mesh, (Replicate(), Partial()))
    out = add_(mine, DTensor.from_local(idx[:2], mesh, sh),
               DTensor.from_local(src[:2], mesh, sh))
    assert tuple(out.placements) == (Replicate(), Partial())
    assert torch.equal(out.to_local(), add(base, idx[:2], src[:2]))


def test_repairs_keep_the_plain_path_bits():
    """``moe_apply`` and ``mamba_apply`` (prefill and decode) on plain
    tensors: the repairs act on DTensors only, so each output is
    bit-equal to the plain ops written out as before them."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ssd, ssd_decode_step
    from repro_torch.models import build_model, mamba2, moe
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.transformer import _layer
    g = torch.Generator().manual_seed(3)
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    p = build_model(cfg).init_params(g, device="cpu")
    lp = _layer(p["layers"], 0)["moe"]
    x = torch.randn(2, 24, cfg.d_model, generator=g).to(torch.bfloat16)
    out = moe.moe_apply(lp, x, cfg.moe)
    # the dispatch's tables as plain ops
    xf = x.reshape(-1, cfg.d_model)
    _, top_e = moe.route(lp, xf, cfg.moe)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.zeros(cfg.moe.n_experts, dtype=torch.int64).scatter_add_(
        0, se, torch.ones_like(se))
    cap = moe.capacity(xf.shape[0], cfg.moe)
    got = moe.dispatch(top_e, cap, cfg.moe.n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(se.numel()) - offsets[se]
    assert torch.equal(got[0], order)
    assert torch.equal(got[1], pos < cap)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert torch.equal(out, moe.moe_apply(lp, x, cfg.moe))

    cfg = get_config("mamba2-130m").reduced()
    p = build_model(cfg).init_params(g, device="cpu")
    mp = _layer(p["layers"], 0)["mamba"]
    dims = cfg.mamba
    x = torch.randn(2, 32, cfg.d_model, generator=g).to(torch.bfloat16)
    B, T, _ = x.shape
    di, G, N, H, Pd = (dims.d_inner, dims.n_groups, dims.d_state,
                       dims.n_heads, dims.headdim)
    z, xbc, dt = mamba2._split_proj(x @ mp["in_proj"], dims)
    xbc = mamba2._causal_conv(xbc, mp["conv_w"], mp["conv_b"])
    y = ssd(xbc[..., :di].reshape(B, T, H, Pd),
            F.softplus(dt.float() + mp["dt_bias"]), -torch.exp(mp["A_log"]),
            xbc[..., di:di + G * N].reshape(B, T, G, N),
            xbc[..., di + G * N:].reshape(B, T, G, N), mp["D"],
            chunk=cfg.ssd_chunk)
    y = rmsnorm(y.reshape(B, T, di) * F.silu(z.float()).to(y.dtype),
                mp["norm"])
    want = y @ mp["out_proj"]
    got = mamba2.mamba_apply(mp, x, dims, chunk=cfg.ssd_chunk)
    assert torch.equal(got, want)
    st = mamba2.mamba_state_zeros(B, dims, "cpu")
    st2 = mamba2.mamba_state_zeros(B, dims, "cpu")
    out1, _ = mamba2.mamba_decode(mp, x[:, :1], st, dims)
    z, xbc, dt = mamba2._split_proj(x[:, :1] @ mp["in_proj"], dims)
    window = torch.cat([st2.conv, xbc], dim=1)
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", window.float(),
                                mp["conv_w"].float())
                   + mp["conv_b"].float()).to(x.dtype)
    h_new, y = ssd_decode_step(
        st2.h, xbc_t[:, :di].reshape(B, H, Pd),
        F.softplus(dt[:, 0].float() + mp["dt_bias"]),
        -torch.exp(mp["A_log"]), xbc_t[:, di:di + G * N].reshape(B, G, N),
        xbc_t[:, di + G * N:].reshape(B, G, N), mp["D"])
    y = rmsnorm(y.reshape(B, 1, di) * F.silu(z.float()).to(y.dtype),
                mp["norm"])
    assert torch.equal(out1, y @ mp["out_proj"])
    assert torch.equal(st.h, h_new)


def test_kernel_entries_refuse_dtensors(mesh):
    """A kernel's card path takes plain tensors (``reject_dtensor``); on
    the CPU a DTensor takes the plain version, as the dry run does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels import reject_dtensor
    from repro_torch.kernels.flash_attention import attention
    reject_dtensor("entry", torch.zeros(2))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(1, 2, 8, 16), mesh,
                               (Replicate(), Replicate()), run_check=False)
        with pytest.raises(TypeError, match="entry.*DTensor"):
            reject_dtensor("entry", torch.zeros(2), x)
        with implicit_replication():
            out = attention(x, x, x)
    assert isinstance(out, DTensor) and tuple(out.shape) == (1, 2, 8, 16)


def test_fake_world_is_torn_down_on_error():
    with pytest.raises(ZeroDivisionError):
        with fake_world(4):
            assert dist.get_world_size() == 4
            1 / 0
    assert not dist.is_initialized()
    with fake_world(2):
        with pytest.raises(RuntimeError, match="already running"):
            with fake_world(2):
                pass


# ------------------------------------------------------------ roofline

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert roofline._active_fraction(cfg) == rroof._active_fraction(rcfg)
    for s, rs in zip(SHAPES, REF_SHAPES):
        assert roofline.model_flops(cfg, s) == rroof.model_flops(rcfg, rs)


def test_roofline_terms_use_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.CHIPS) == (989e12, 3.35e12, 50e9, 256)
    shape = next(s for s in SHAPES if s.name == "train_4k")
    rec = {"arch": "qwen3-0.6b", "shape": "train_4k", "status": "ok",
           "cost": {"flops": 989e12, "bytes_accessed": 6.7e12},
           "collectives": {"all-gather": {"count": 1, "bytes": 25e9},
                           "total_bytes": 25e9},
           "memory": {"temp_bytes": 1}}
    r = roofline.roofline_of(rec, get_config("qwen3-0.6b"), shape)
    assert (r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]) \
        == (1.0, 2.0, 0.5)
    assert r["dominant"] == "memory"
    assert r["useful_ratio"] == pytest.approx(
        roofline.model_flops(get_config("qwen3-0.6b"), shape)
        / (989e12 * 256))


def test_variants_cut_the_depth():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for k in (1, 2):
            v = dryrun._variant(cfg, k)
            assert dryrun._units(v) == k
            assert dataclasses.replace(v, n_layers=cfg.n_layers,
                                       n_enc_layers=cfg.n_enc_layers) == cfg
