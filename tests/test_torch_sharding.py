"""The port's logical-axis sharding (``repro_torch.dist.sharding``,
``launch.specs``) against the reference's, on the production meshes.

The reference resolves against ``jax.sharding.AbstractMesh`` (no
devices), the port against its own ``AbstractMesh`` and against
``DeviceMesh``es over a fake world of 256 and 512 ranks.  Every leaf of
every applicable (arch × shape) cell's arguments (parameters, optimizer
state, batch, decode state) must get the reference's spec and shard
shape; a decode-state leaf of the port's per-layer caches takes the
reference's stacked leaf's spec and shard shape without the leading
layer entries.
"""
import logging

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from repro.configs import ARCH_IDS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import shape_applies as ref_applies
from repro.dist import sharding as rshd
from repro.launch import specs as rspecs
from repro.models import build_model as ref_build

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applies
from repro_torch.dist import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import build_model
from repro_torch.tree import leaves_with_path, tree_leaves

torch.set_num_threads(1)
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized(), "a process group outlived the test"


def _meshes(name):
    shape, axes = MESHES[name]
    return JaxAbstractMesh(shape, axes), shd.AbstractMesh(shape, axes)


def test_arch_and_shape_grid_match_the_reference():
    assert ARCH_IDS == REF_ARCHS
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in REF_SHAPES]
    for a in ARCH_IDS:
        for s, rs in zip(SHAPES, REF_SHAPES):
            assert shape_applies(get_config(a), s) \
                == ref_applies(ref_config(a), rs)


def _axes_leaf(x) -> bool:
    """A logical-axes tuple (not a named tuple of them)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _resolve_cases(arch):
    """(shape, axes, port rules, reference rules) of every parameter,
    input and decode-state leaf of ``arch`` at its full config."""
    rcfg = ref_config(arch)
    rmodel = ref_build(rcfg)
    out = []
    leaves = jax.tree_util.tree_leaves(
        rmodel.abstract_params())
    axes = jax.tree_util.tree_leaves(
        rmodel.param_logical_axes(), is_leaf=_axes_leaf)
    out += [(a.shape, ax, shd.PARAM_RULES, rshd.PARAM_RULES)
            for a, ax in zip(leaves, axes)]
    for s in REF_SHAPES:
        if not ref_applies(rcfg, s)[0]:
            continue
        if s.kind == "decode":
            st = rmodel.init_decode_state(s.global_batch, s.seq_len,
                                          abstract_only=True)
            sax = rspecs.decode_state_logical(rmodel, rcfg)
            out += [(a.shape, ax, specs.STATE_RULES, rspecs.STATE_RULES)
                    for a, ax in zip(
                        jax.tree_util.tree_leaves(st),
                        jax.tree_util.tree_leaves(
                            sax, is_leaf=_axes_leaf))]
            continue
        sp = rspecs.input_specs(rcfg, s)
        bax = rspecs.batch_logical(rcfg, sp)
        out += [(sp[k].shape, bax[k], shd.ACT_RULES, rshd.ACT_RULES)
                for k in sorted(sp)]
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_and_shard_shape_match_the_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    cases = _resolve_cases(arch)
    assert cases
    for shape, axes, rules, rrules in cases:
        want = rshd.resolve(jmesh, shape, axes, rrules)
        got = shd.resolve(tmesh, shape, axes, rules)
        assert got == tuple(want), (arch, shape, axes)
        assert shd.shard_shape(tmesh, shape, got) == tuple(
            JaxNamedSharding(jmesh, want).shard_shape(tuple(shape))), \
            (arch, shape, axes)


def test_rules_match_the_reference():
    assert shd.PARAM_RULES == rshd.PARAM_RULES
    assert shd.ACT_RULES == rshd.ACT_RULES
    assert specs.STATE_RULES == rspecs.STATE_RULES


# ------------------------------------------------- build_cell, leaf by leaf

def _ref_flat(tree):
    """(path, NamedSharding) of a reference sharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxNamedSharding))
    return [(jax.tree_util.keystr(p), s) for p, s in flat]


def _ref_state_as_port(model, ref_tree, abstract):
    """The reference's decode-state shardings and global shapes laid out
    as the port's state: a list of (port path, spec, shard shape)."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.hybrid import HybridLM

    def one(sh, shape, drop):
        spec = tuple(sh.spec) + (None,) * (len(shape) - len(sh.spec))
        return spec[drop:], tuple(sh.shard_shape(tuple(shape)))[drop:]
    ref = dict(_ref_flat(ref_tree))
    shapes = {jax.tree_util.keystr(p): a.shape for p, a in
              jax.tree_util.tree_flatten_with_path(abstract)[0]}
    out = []
    if isinstance(model, EncDec):
        for f in ("k", "v"):
            out.append((f".self_kv.{f}",) + one(
                ref[f".self_kv.{f}"], shapes[f".self_kv.{f}"], 0))
            out.append((f".cross_kv['{f}']",) + one(
                ref[f".cross_kv['{f}']"], shapes[f".cross_kv['{f}']"], 0))
    elif isinstance(model, HybridLM):
        for p in range(model.n_periods):
            for f in ("k", "v"):
                key = f".layers['kv'].{f}"
                out.append((f".layers[{p}]['kv'].{f}",)
                           + one(ref[key], shapes[key], 1))
            for j in range(model.n_mamba):
                for f in ("h", "conv"):
                    key = f".layers['mamba'].{f}"
                    out.append((f".layers[{p}]['mamba'][{j}].{f}",)
                               + one(ref[key], shapes[key], 2))
    else:
        fields = ("h", "conv") if model.is_mamba else (
            ("k", "v", "k_scale", "v_scale")
            if model.cfg.kv_dtype == "int8" else ("k", "v"))
        for i in range(model.cfg.n_layers):
            for f in fields:
                key = f".layers.{f}"
                out.append((f".layers[{i}].{f}",)
                           + one(ref[key], shapes[key], 1))
    out.append((".pos",) + one(ref[".pos"], shapes[".pos"], 0))
    return out


def _port_leaves(tree):
    return [(p, (tuple(t.placements), tuple(t.to_local().shape),
                 tuple(t.shape))) for p, t in leaves_with_path(tree)]


def _check_leaves(mesh, got, want, what):
    got = dict(got)
    assert sorted(got) == sorted(p for p, *_ in want), what
    for path, spec, local in want:
        pl, loc, _ = got[path]
        assert pl == shd.placements(mesh, spec), (what, path, spec, pl)
        assert loc == tuple(local), (what, path, loc, local)
    return len(want)


def _plain(ref_tree, ref_abs):
    out = []
    shapes = {jax.tree_util.keystr(p): a.shape for p, a in
              jax.tree_util.tree_flatten_with_path(ref_abs)[0]}
    for path, sh in _ref_flat(ref_tree):
        shape = tuple(shapes[path])
        spec = tuple(sh.spec) + (None,) * (len(shape) - len(sh.spec))
        out.append((path, spec, tuple(sh.shard_shape(shape))))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_build_cell_leaves_match_the_reference(mesh_name):
    """Every leaf of every applicable cell: the port's DTensor arguments'
    placements and local shapes against the reference's in_shardings."""
    jmesh, _ = _meshes(mesh_name)
    shape, axes = MESHES[mesh_name]
    n = 0
    with fake_world(256 if len(shape) == 2 else 512):
        mesh = make_production_mesh(multi_pod=len(shape) == 3,
                                    device_type="cpu")
        for arch in ARCH_IDS:
            rcfg, cfg = ref_config(arch), get_config(arch)
            for s, rs in zip(SHAPES, REF_SHAPES):
                if not shape_applies(cfg, s)[0]:
                    continue
                rcell = rspecs.build_cell(rcfg, rs, jmesh)
                cell = specs.build_cell(cfg, s, mesh)
                what = (arch, s.name, mesh_name)
                # parameters (and moments) are the same trees, key for key
                n += _check_leaves(mesh, _port_leaves(cell.args[0]),
                                   _plain(rcell.in_shardings[0],
                                          rcell.args[0]), what)
                if s.kind == "train":
                    n += _check_leaves(mesh, _port_leaves(cell.args[1]),
                                       _plain(rcell.in_shardings[1],
                                              rcell.args[1]), what)
                    n += _check_leaves(mesh, _port_leaves(cell.args[2]),
                                       _plain(rcell.in_shardings[2],
                                              rcell.args[2]), what)
                elif s.kind == "prefill":
                    n += _check_leaves(mesh, _port_leaves(cell.args[1]),
                                       _plain(rcell.in_shardings[1],
                                              rcell.args[1]), what)
                else:
                    n += _check_leaves(
                        mesh, [("", _port_leaves(cell.args[1])[0][1])],
                        _plain(rcell.in_shardings[1], rcell.args[1]), what)
                    n += _check_leaves(
                        mesh, _port_leaves(cell.args[2]),
                        _ref_state_as_port(build_model(cfg),
                                           rcell.in_shardings[2],
                                           rcell.args[2]), what)
                # the port's shardings tree says the same as its tensors
                for sh, t in zip(tree_leaves(cell.in_shardings[0]),
                                 tree_leaves(cell.args[0])):
                    assert sh.placements() == tuple(t.placements)
    assert n > 800, n


def test_placements_of_multi_axis_entries():
    mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    spec = shd.resolve(mesh, (256, 4096), ("batch", "seq"), shd.ACT_RULES)
    assert spec == (("pod", "data"), None)
    assert shd.placements(mesh, spec) == (Shard(0), Shard(0), Replicate())
    assert shd.shard_shape(mesh, (256, 4096), spec) == (8, 4096)
    with pytest.raises(ValueError, match="order"):
        shd.placements(mesh, (("data", "pod"), None))
    with pytest.raises(ValueError, match="not on the mesh"):
        shd.placements(shd.AbstractMesh((4,), ("model",)),
                       ("data", None))


# ------------------------------------------- the reference's resolver cases

def test_resolver_divisibility_and_uniqueness():
    mesh = shd.AbstractMesh((1, 1), ("data", "model"))
    # both want "model"; only the first gets it
    spec = shd.resolve(mesh, (64, 64), ("heads", "mlp"), shd.PARAM_RULES)
    assert spec[0] == "model" and spec[1] is None
    # 7 % 1 == 0: allowed on a size-1 axis
    mesh2 = shd.AbstractMesh((1,), ("model",))
    assert shd.resolve(mesh2, (7,), ("vocab",), shd.PARAM_RULES)[0] \
        == "model"
    # and dropped on a 16-wide one: 7 replicates, 64 shards
    mesh16 = shd.AbstractMesh((16,), ("model",))
    assert shd.resolve(mesh16, (7, 64), ("vocab", "mlp"),
                       shd.PARAM_RULES) == (None, "model")


def test_resolver_batch_multi_axis():
    mesh = shd.AbstractMesh((1, 1, 1), ("pod", "data", "model"))
    spec = shd.resolve(mesh, (256, 4096), ("batch", "seq"), shd.ACT_RULES)
    assert spec[0] == ("pod", "data")
    assert spec[1] is None


def test_resolver_drops_trailing_axes_until_the_dim_divides():
    mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    # 32 % 32 == 0: both; 2 % 32 != 0 → pod alone; 1 → replicated
    assert shd.resolve(mesh, (32,), ("batch",), shd.ACT_RULES) \
        == (("pod", "data"),)
    assert shd.resolve(mesh, (2,), ("batch",), shd.ACT_RULES) == ("pod",)
    assert shd.resolve(mesh, (1,), ("batch",), shd.ACT_RULES) == (None,)
    ref = JaxAbstractMesh((2, 16, 16), ("pod", "data", "model"))
    for n in (1, 2, 3, 32, 48, 64):
        assert shd.resolve(mesh, (n,), ("batch",), shd.ACT_RULES) == tuple(
            rshd.resolve(ref, (n,), ("batch",), rshd.ACT_RULES))
