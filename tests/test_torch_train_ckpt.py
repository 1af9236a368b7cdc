"""The port's checkpoints: the reference's file format both ways (a file
written by either package loads in the other, every leaf bit-equal), and
twins of the reference's checkpoint tests (``tests/test_substrate.py``:
a bfloat16 round trip, the manager's keep-last-k and restore, a crash
resume bit-exact against a straight run).  The JAX package reads the
port's files and the port reads the JAX package's; no tolerance."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.ckpt.checkpoint import load_checkpoint as jload_checkpoint
from repro.ckpt.checkpoint import save_checkpoint as jsave_checkpoint
from repro.launch.train import PRESETS as JPRESETS
from repro.models import build_model as jbuild_model
from repro.train.optimizer import adamw_init as jadamw_init

from repro_torch.ckpt.checkpoint import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.serve import PRESETS
from repro_torch.models import build_model
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy, tree_to_numpy)
from repro_torch.train import AdamWCfg, adamw_init, make_train_step
from repro_torch.tree import leaves_with_path, tree_leaves, tree_map

torch.set_num_threads(1)


def _reference_state():
    jm = jbuild_model(JPRESETS["tiny"])
    jp = jm.init_params(jax.random.PRNGKey(0))
    jo = jadamw_init(jp)
    # moments that are not zero, a step that is not 0
    jo = jo._replace(step=jnp.int32(7), mu=jax.tree_util.tree_map(
        lambda a: a + 0.5, jo.mu))
    return {"params": jp, "opt": jo}


def _port_state(ref):
    as_np = jax.tree_util.tree_map(np.asarray, ref)
    return {"params": params_from_numpy(as_np["params"], "cpu"),
            "opt": opt_state_from_numpy(as_np["opt"], "cpu")}


def _bits_equal(ref_tree, port_tree):
    w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                         ref_tree))
    g = tree_leaves(tree_to_numpy(port_tree, jnp.bfloat16))
    assert len(w) == len(g)
    for a, b in zip(w, g):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def test_keys_are_jax_keystr_paths():
    ref = _reference_state()
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [k for k, _ in leaves_with_path(_port_state(ref))] == want
    assert "['opt'].mu['embed']" in want and "['opt'].step" in want


def test_reference_file_loads_in_the_port(tmp_path):
    ref = _reference_state()
    path = tmp_path / "ref.npz"
    jsave_checkpoint(path, ref, step=7)
    like = _port_state(ref)
    like = tree_map(torch.zeros_like, like)
    got = load_checkpoint(path, like)
    _bits_equal(ref, got)
    assert got["params"]["embed"].dtype == torch.bfloat16


def test_port_file_loads_in_the_reference(tmp_path):
    ref = _reference_state()
    path = tmp_path / "port.npz"
    save_checkpoint(path, _port_state(ref), step=7)
    got = jload_checkpoint(path, ref)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))
    assert (path.parent / "port.json").exists()


def _tiny():
    cfg = PRESETS["tiny"]
    model = build_model(cfg)
    return cfg, model, model.init_params(torch.Generator().manual_seed(0),
                                         "cpu")


def test_checkpoint_roundtrip_bf16(tmp_path):
    _, _, params = _tiny()
    opt = adamw_init(params)
    path = tmp_path / "ck.npz"
    save_checkpoint(path, {"p": params, "o": opt}, step=7)
    back = load_checkpoint(path, {"p": params, "o": opt})
    for a, b in zip(tree_leaves(back), tree_leaves({"p": params, "o": opt})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_manager_keeps_last_k_and_restores_latest(tmp_path):
    _, _, params = _tiny()
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (10, 20, 30):
        scaled = tree_map(lambda x: x * (step / 10.0), params)
        mgr.save({"p": scaled}, step, blocking=step == 30)
    files = sorted(pathlib.Path(tmp_path).glob("step_*.npz"))
    assert len(files) == 2
    restored, step = mgr.restore_latest({"p": params})
    assert step == 30
    a = tree_leaves(restored["p"])[0].float()
    b = tree_leaves(params)[0].float()
    torch.testing.assert_close(a, b * 3.0, rtol=2e-2, atol=0)


def test_crash_resume_is_bit_exact(tmp_path):
    """6 steps straight against 3 + checkpoint + restore + 3."""
    cfg, model, p0 = _tiny()
    step_fn = make_train_step(model, AdamWCfg(lr=1e-3, warmup_steps=2,
                                              total_steps=10))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=2)

    def run(params, opt, start, end):
        for s in range(start, end):
            params, opt, _ = step_fn(params, opt, data.batch(s,
                                                             device="cpu"))
        return params, opt

    o0 = adamw_init(p0)
    pa, oa = run(p0, o0, 0, 6)
    pb, ob = run(p0, o0, 0, 3)
    mgr = CheckpointManager(tmp_path)
    mgr.save({"p": pb, "o": ob}, 2)             # on the background thread
    restored, step = mgr.restore_latest({"p": pb, "o": ob})
    pc, oc = run(restored["p"], restored["o"], step + 1, 6)
    for a, b in zip(tree_leaves((pa, oa)), tree_leaves((pc, oc))):
        assert torch.equal(a, b)
