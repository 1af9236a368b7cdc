"""Checked mode on the port (``REPRO_CHECKED=1``, ``analysis.annotate``).

The two declared-disjoint scatters of the tick (``pool.scatter_pool`` and
the compaction of ``policies.eject_view``) check their indices at run
time under ``REPRO_CHECKED=1``, with the reference's checkify messages
(``tests/test_simcheck.py:262-288``).  The checks change no result, raise
on forged inputs, fold into the loop's error word (read once after the
run) and vanish from the unchecked tick.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis import annotate, layout_check, op_lint
from repro_torch.core import Simulation, policies, scheduler
from repro_torch.core.pool import SlotAssignment, scatter_pool
from repro_torch.core.types import SchedState

# the port's tensors here are small: one intra-op thread per test
# process beats oversubscribing the cores across test workers
torch.set_num_threads(1)

MESSAGES = ("scatter_pool: duplicate destination slot",
            "scatter_pool: live destination out of range",
            "eject_view: duplicate compaction target")


def test_messages_are_the_references():
    assert annotate.CHECKS == MESSAGES


def _tiny(network, faults, n_ticks):
    sim = layout_check._tiny_sim(network, faults, False, device="cpu")
    return Simulation(sim.graph, caps=sim.caps, device="cpu",
                      params=dataclasses.replace(sim.params,
                                                 n_ticks=n_ticks))


def test_checked_mode_is_value_neutral(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKED", raising=False)
    res0 = _tiny("fabric", "chaos", 40).run()
    monkeypatch.setenv("REPRO_CHECKED", "1")
    res1 = _tiny("fabric", "chaos", 40).run()
    leaves = lambda r: [t for t in op_lint._named(r.state, "state")]
    for (p, a), (_, b) in zip(leaves(res0), leaves(res1)):
        assert torch.equal(a, b), p
    for a, b in zip(res0.trace, res1.trace):
        assert torch.equal(a, b)
    assert int(res0.state.counters.finished) > 0


def _forged_scatter(dst):
    """scatter_pool over a hand-forged (invalid) slot assignment."""
    sim = layout_check._tiny_sim("uniform", "none", False, device="cpu")
    cl = sim.init_state().cloudlets
    cl = type(cl)(cl.ints[None], cl.flts[None], cl.layout)
    cols = {n: 0 for n in cl.layout.columns}
    i32 = torch.int32
    asg = SlotAssignment(dst=torch.tensor([dst], dtype=i32),
                         src=torch.arange(len(dst), dtype=i32)[None],
                         live=torch.ones((1, len(dst)), dtype=torch.bool),
                         n_assigned=torch.tensor([len(dst)], dtype=i32),
                         n_dropped=torch.zeros(1, dtype=i32))
    return lambda: scatter_pool(cl, asg, **cols)


@pytest.mark.parametrize("dst,message", [([3, 3], MESSAGES[0]),
                                         ([-5], MESSAGES[1]),
                                         ([1, 128], MESSAGES[1])])
def test_checked_mode_catches_forged_scatter(monkeypatch, dst, message):
    monkeypatch.setenv("REPRO_CHECKED", "1")
    fn = _forged_scatter(dst)
    with annotate.collecting(annotate.new_word("cpu")) as word:
        fn()                                  # folds, raises nothing
    assert annotate.violated(word) == [message]
    with pytest.raises(annotate.CheckError, match=message):
        annotate.throw(word)
    with pytest.raises(annotate.CheckError, match=message):
        fn()                                  # no word open: at once


def test_unchecked_scatter_checks_nothing(monkeypatch):
    monkeypatch.delenv("REPRO_CHECKED", raising=False)
    fn = _forged_scatter([3, 3])
    with annotate.collecting(annotate.new_word("cpu")) as word:
        fn()
    assert int(word) == 0


def _forged_compaction(pos):
    iof = torch.tensor([[[4, 5, 6]]], dtype=torch.int32)
    keep = torch.tensor([[[True, True, False]]])
    return lambda: policies.compact_rows(
        iof, keep, torch.tensor([[pos]], dtype=torch.int32))


def test_checked_mode_catches_forged_compaction(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKED", "1")
    assert _forged_compaction([0, 1, 1])().tolist() == [[[4, 5, -1]]]
    with pytest.raises(annotate.CheckError, match=MESSAGES[2]):
        _forged_compaction([1, 1, 2])()
    monkeypatch.delenv("REPRO_CHECKED")
    _forged_compaction([1, 1, 2])()           # unchecked: no check


def test_eject_view_is_checked_and_unchanged(monkeypatch):
    rng = np.random.default_rng(5)
    B, S, R, I = 2, 3, 4, 10
    sched = SchedState(
        inst_of_rank=torch.from_numpy(
            rng.integers(-1, I, (B, S, R)).astype(np.int32)),
        svc_replicas=torch.from_numpy(
            rng.integers(0, R + 1, (B, S)).astype(np.int32)))
    until = torch.from_numpy(rng.uniform(0, 2, (B, I)).astype(np.float32))
    time = torch.ones(B)
    monkeypatch.delenv("REPRO_CHECKED", raising=False)
    want = policies.eject_view(sched, until, time)
    monkeypatch.setenv("REPRO_CHECKED", "1")
    with annotate.collecting(annotate.new_word("cpu")) as word:
        got = policies.eject_view(sched, until, time)
    assert int(word) == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _check_ops(monkeypatch, checked):
    if checked:
        monkeypatch.setenv("REPRO_CHECKED", "1")
    else:
        monkeypatch.delenv("REPRO_CHECKED", raising=False)
    sim = layout_check._tiny_sim("fabric", "chaos", False, device="cpu")
    loop = layout_check.eager_loop(sim, cap=2)
    loop.step(False)
    rec = op_lint.OpRecorder()
    with rec:
        loop.step(False)
    return [op for op in rec.ops if op.checked]


def test_unchecked_tick_issues_no_check_operation(monkeypatch):
    assert _check_ops(monkeypatch, False) == []
    assert len(_check_ops(monkeypatch, True)) > 0


def _duplicate_slots(monkeypatch):
    """Every lane of every spawn wave of the scheduler lands, live, on
    the pool's first slot."""
    assign = scheduler.assign_free_slots

    def forged(*a, **k):
        asg = assign(*a, **k)
        return asg._replace(dst=torch.zeros_like(asg.dst),
                            live=torch.ones_like(asg.live))

    monkeypatch.setattr(scheduler, "assign_free_slots", forged)


def test_checked_run_raises_after_the_loop(monkeypatch):
    monkeypatch.setenv("REPRO_CHECKED", "1")
    _duplicate_slots(monkeypatch)
    sim = layout_check._tiny_sim("uniform", "none", False, device="cpu")
    with pytest.raises(annotate.CheckError, match=MESSAGES[0]):
        sim.run()
    with pytest.raises(annotate.CheckError, match=MESSAGES[0]):
        sim.run_batch_state(sim.init_state(), [sim.params] * 2, 3)
    monkeypatch.delenv("REPRO_CHECKED")
    sim.run()                                 # unchecked: runs through


def test_capture_key_holds_checked_mode(monkeypatch):
    sim = layout_check._tiny_sim("uniform", "none", False, device="cpu")
    state = sim.init_state()
    monkeypatch.delenv("REPRO_CHECKED", raising=False)
    plain = sim._capture_key(state, 1, (False, True))
    monkeypatch.setenv("REPRO_CHECKED", "1")
    assert sim._capture_key(state, 1, (False, True)) != plain
