"""Three ``make_train_step`` steps of the moe, vlm, encdec and hybrid
families on the CPU against the reference's jitted steps, and the
training driver on their reduced configs.

The cases, batches, reference models and routing are
``test_torch_train_families``'s (whisper-base's float32 step runs the
reference's unrolled encoder op by op; jamba's bf16 steps give the
reference the port's expert choices, recorded anew before each step).
Tolerances are ``test_torch_train_step``'s three-step ones: the losses
and gradient norms of each step within the loss and gradient tolerances,
every parameter within 4·Σ lr of the reference's (plus 2^-7 in bfloat16).
``donate=True`` (the driver's in-place update) gives the functional
step's bits.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.train.optimizer import AdamWCfg as JAdamWCfg
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.train_step import make_train_step as jmake_train_step

from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models.convert import opt_state_from_numpy
from repro_torch.train import AdamWCfg, adamw_init, make_train_step
from repro_torch.tree import tree_leaves, tree_map

from test_torch_train_families import (CASES, IDS, _batches, _GivenRouting,
                                       _jmodel, _needs_given, _pair)
from test_torch_train_step import GRAD_TOL, LOSS_TOL, _leaves_close

torch.set_num_threads(1)


def _jstep(jmod, jit, cfg):
    """The reference's train step: ``make_train_step`` jitted, or for the
    unrolled whisper its loss and gradients op by op and its AdamW update
    jitted (the port's update is the jitted reference's, bit for bit)."""
    if jit is jax.jit:
        return jax.jit(jmake_train_step(jmod, cfg))
    update = jax.jit(lambda p, g, o: jadamw_update(p, g, o, cfg))

    def step(p, o, batch):
        loss, g = jax.value_and_grad(lambda q: jmod.loss_fn(q, batch))(p)
        p, o, stats = update(p, g, o)
        return p, o, {"loss": loss, **stats}
    return step


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_three_train_steps_match_reference(arch, kind, precision,
                                           monkeypatch):
    jm, jp, tm, tp = _pair(arch, precision)
    jmod, jit = _jmodel(jm, precision)
    cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    tstep = make_train_step(tm, AdamWCfg(**cfg))
    given = _GivenRouting(monkeypatch) if _needs_given(tm, precision) \
        else None
    jo = jadamw_init(jp)
    to = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, jo), "cpu")
    lr_sum = 0.0
    with given.patched() if given else contextlib.nullcontext():
        jstep = _jstep(jmod, jit, JAdamWCfg(**cfg))
        for s in range(3):
            jb, tb = _batches(jm, tm, kind, s)
            if given:
                given.record(tm, tp, tb)
            jp, jo, jmet = jstep(jp, jo, jb)
            tp, to, tmet = tstep(tp, to, tb)
            assert abs(float(tmet["loss"]) - float(jmet["loss"])) \
                <= LOSS_TOL[precision] * (s + 1)
            np.testing.assert_allclose(float(tmet["grad_norm"]),
                                       float(jmet["grad_norm"]),
                                       rtol=GRAD_TOL[precision])
            assert float(tmet["lr"]) == float(jmet["lr"])
            lr_sum += float(jmet["lr"])
            assert int(to.step) == s + 1
            _leaves_close(jp, tp, 0.0, atol=4 * lr_sum
                          + (0.0 if precision == "f32" else 2.0 ** -7))


@pytest.mark.parametrize("arch,kind", CASES[:1] + CASES[2:3] + CASES[4:],
                         ids=IDS[:1] + IDS[2:3] + IDS[4:])
def test_donated_steps_give_the_functional_bits(arch, kind):
    """Two steps writing the state in place give the functional steps'
    parameters and moments bit for bit, in the given tensors' storage."""
    jm, _, tm, tp = _pair(arch, "bf16")
    cfg = AdamWCfg(lr=1e-3, warmup_steps=2, total_steps=10)
    a = (tp, adamw_init(tp))
    b = (tree_map(torch.clone, tp), adamw_init(tp))
    ptrs = [t.data_ptr() for t in tree_leaves(b)]
    functional = make_train_step(tm, cfg)
    donated = make_train_step(tm, cfg, donate=True)
    for s in range(2):
        _, tb = _batches(jm, tm, kind, s)
        a = functional(*a, tb)[:2]
        b = donated(*b, tb)[:2]
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    # every leaf but the step counter kept its storage
    moved = [p != t.data_ptr() for p, t in zip(ptrs, tree_leaves(b))]
    assert sum(moved) == 1


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2-vl-7b",
                                  "jamba-1.5-large-398b"])
def test_train_driver_trains_the_family(arch):
    """``launch.train.main`` on the reduced config (the vlm family through
    its embedding table, as the reference's driver feeds it): finite
    losses, the same from the same seed."""
    cfg = get_config(arch).reduced()
    args = ["--steps", "3", "--batch", "2", "--seq", "32", "--log-every",
            "10", "--device", "cpu"]
    losses = train.main(args, cfg=cfg)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert train.main(args, cfg=cfg) == losses


def test_train_driver_refuses_the_encdec_family():
    """The driver's token batches hold no frames: whisper-base trains
    through ``make_train_step`` on ``data.batch_for``'s batches."""
    with pytest.raises(ValueError, match="batch_for"):
        train.main(["--steps", "1", "--device", "cpu"],
                   cfg=get_config("whisper-base").reduced())
