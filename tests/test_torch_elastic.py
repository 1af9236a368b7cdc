"""Elastic restore on DTensor (``repro_torch.ckpt.elastic``) in four CPU
processes over gloo: a reduced qwen3 train state (parameters and AdamW
moments) placed on a (2, 2) mesh, rescaled to (1, 4), then to (4,).
After each placement every leaf's ``full_tensor()`` is bit-equal to the
original, its placements are the resolver's, and each rank's local shard
is the slice its mesh coordinate and the reference's shard shape give.
AdamW on the placed leaves gives the unsharded update's bits.

The reference's specs and shard shapes are computed here, with JAX; the
four workers (this file run as a script) import neither JAX nor the
reference."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = (((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4,), ("model",)))
ARCH = "qwen3-0.6b"


def _expected():
    """{mesh key: {parameter path: [spec, shard shape]}} by the
    reference's resolver."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.configs import get_config
    from repro.dist import sharding as rshd
    from repro.models import build_model
    model = build_model(get_config(ARCH).reduced())
    flat = jax.tree_util.tree_flatten_with_path(model.abstract_params())[0]
    axes = jax.tree_util.tree_leaves(
        model.param_logical_axes(),
        is_leaf=lambda x: isinstance(x, tuple))
    out = {}
    for shape, names in MESHES:
        mesh = AbstractMesh(shape, names)
        out[str(shape)] = {
            jax.tree_util.keystr(p): [
                [list(e) if isinstance(e, tuple) else e for e in spec],
                list(NamedSharding(mesh, spec).shard_shape(a.shape))]
            for (p, a), ax in zip(flat, axes)
            for spec in [rshd.resolve(mesh, a.shape, ax, rshd.PARAM_RULES)]}
    return out


def test_reshard_across_meshes_in_four_processes(tmp_path):
    (tmp_path / "expected.json").write_text(json.dumps(_expected()))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
        assert out.strip().endswith("ok"), f"rank {r}:\n{out[-4000:]}"
    results = [json.loads((tmp_path / f"rank{r}.json").read_text())
               for r in range(WORLD)]
    # every rank checked every leaf of every mesh
    n = {r["leaves"] for r in results}
    assert len(n) == 1 and n.pop() > 3 * 3 * 10
    assert len({r["grad_norm"] for r in results}) == 1


# ---------------------------------------------------------------- worker

def _bits(t):
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def _same(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype \
        and torch.equal(_bits(a), _bits(b))


def _local_slice(full, spec, mesh):
    """The block of ``full`` that this rank's coordinate holds under
    ``spec`` (a dim over several axes: major to minor)."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    idx = []
    for d, entry in enumerate(spec):
        axes = [] if entry is None else (
            [entry] if isinstance(entry, str) else list(entry))
        pos, n = 0, 1
        for a in axes:
            size = mesh.shape[names.index(a)]
            pos = pos * size + coord[names.index(a)]
            n *= size
        step = full.shape[d] // n
        idx.append(slice(pos * step, (pos + 1) * step))
    return full[tuple(idx)]


def _logical(model):
    from repro_torch.launch.specs import opt_logical
    ax = model.param_logical_axes()
    return {"params": ax, "opt": opt_logical(ax)}


def _axes_by_path(logical):
    """{leaf path: axes} of a logical tree (whose leaves are tuples)."""
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{pre}[{k!r}]")
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), f"{pre}.{f}")
        else:
            out[pre] = t
    walk(logical, "")
    return out


def worker(rank: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.ckpt.elastic import (reshard_tree,
                                          simulate_failure_and_rescale)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import (AdamWCfg, AdamWState,
                                             adamw_update)
    from repro_torch.tree import tree_map
    expected = json.loads(Path(tmp, "expected.json").read_text())
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp, "store")), WORLD),
        rank=rank, world_size=WORLD)
    try:
        model = build_model(get_config(ARCH).reduced())
        g = torch.Generator().manual_seed(0)
        params = model.init_params(g, device="cpu")
        f32 = lambda p: torch.randn(p.shape, generator=g)  # noqa: E731
        opt = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                         mu=tree_map(f32, params),
                         nu=tree_map(lambda p: f32(p).abs(), params))
        state = {"params": params, "opt": opt}
        logical = _logical(model)
        by_path = _axes_by_path(logical)

        def check(tree, mesh, shape):
            from repro_torch.dist import sharding as shd
            from repro_torch.tree import leaves_with_path
            orig = dict(leaves_with_path(state))
            n = 0
            for path, t in leaves_with_path(tree):
                assert _same(t.full_tensor(), orig[path]), path
                spec = shd.resolve(mesh, t.shape, by_path[path],
                                   shd.PARAM_RULES)
                assert tuple(t.placements) == shd.placements(mesh, spec), \
                    path
                if t.dim():
                    # the parameter's own path, for mu, nu and params
                    key = path[len("['params']"):] \
                        if path.startswith("['params']") \
                        else path[path.index("[", len("['opt']")):]
                    want_spec, want_shape = expected[str(shape)][key]
                    assert [list(e) if isinstance(e, tuple) else e
                            for e in spec] == want_spec, (path, spec)
                    local = t.to_local()
                    assert list(local.shape) == want_shape, path
                    assert _same(local, _local_slice(orig[path], spec,
                                                     mesh)), path
                n += 1
            return n

        meshes = [make_mesh(s, a, "cpu") for s, a in MESHES]
        placed = reshard_tree(state, meshes[0], logical)
        n = check(placed, meshes[0], MESHES[0][0])
        for (old, new), (shape, _) in zip(zip(meshes, meshes[1:]),
                                          MESHES[1:]):
            placed = simulate_failure_and_rescale(placed, old, new, logical)
            n += check(placed, new, shape)

        # AdamW on the placed leaves: the unsharded update's bits (the
        # clip scale is exactly 1 at this norm bound)
        cfg = AdamWCfg(clip_norm=1e9)
        grads = tree_map(lambda p: (torch.randn(p.shape, generator=g)
                                    * 0.01).to(p.dtype), params)
        want_p, want_o, want_m = adamw_update(params, grads, opt, cfg)
        mesh = meshes[0]
        p_d = reshard_tree(params, mesh, logical["params"])
        g_d = reshard_tree(grads, mesh, logical["params"])
        o_d = reshard_tree(opt, mesh, logical["opt"])
        got_p, got_o, got_m = adamw_update(p_d, g_d, o_d, cfg)
        from repro_torch.tree import tree_leaves
        for a, b in zip(tree_leaves((got_p, got_o.mu, got_o.nu)),
                        tree_leaves((want_p, want_o.mu, want_o.nu))):
            assert _same(a.full_tensor(), b)
        for a, b in zip(tree_leaves(got_o.mu), tree_leaves(p_d)):
            assert tuple(a.placements) == tuple(b.placements)   # ZeRO-1
        assert int(got_o.step.full_tensor()) == 8
        gn, wn = float(got_m["grad_norm"]), float(want_m["grad_norm"])
        # the norm's float32 sums run in another order (shard by shard,
        # then over the mesh): a few ulp apart
        assert abs(gn - wn) <= 1e-5 * wn, (gn, wn)
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(
            {"leaves": n, "grad_norm": gn}))
    finally:
        dist.destroy_process_group()
    print("ok")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), sys.argv[3])
