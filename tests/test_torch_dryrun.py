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
    query rows split over "model" cut each device's attention FLOPs."""
    shape = _shape("prefill")
    flops = {}
    for impl in ("flat", "flat_seqshard"):
        cfg = get_config("phi3-medium-14b").reduced(attn_impl=impl)
        rec = dryrun.cell_record(cfg, shape, mesh, extrapolate=False)
        assert rec["status"] == "ok", rec.get("error")
        flops[impl] = rec["cost"]["flops"]
    assert flops["flat_seqshard"] < flops["flat"], flops


def test_an_op_without_a_sharding_rule_is_an_error_record(mesh):
    """The moe family's dispatch reaches ``scatter_add_``, which DTensor
    has no rule for: the cell is recorded as an error, not run on a
    replicated fallback."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    rec = dryrun.cell_record(cfg, _shape("prefill"), mesh,
                             extrapolate=False)
    assert rec["status"] == "error"
    assert "scatter_add" in rec["op"], rec
    assert rec["memory"]["argument_bytes"] > 0


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
