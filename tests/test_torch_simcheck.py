"""simcheck on the port (``repro_torch.analysis``) against the reference's.

Three layers, as the reference's own tests:

* **parity with the live reference** — the port's six stream-topology
  digests equal ``repro.analysis.simcheck.check_streams()``'s and the
  pinned ``GOLDEN_STREAM_DIGESTS``; the port's per-phase pool-column
  accesses equal ``repro.analysis.layout_check.replay_accesses``' in all
  seven combos (the reference runs once per module, under the
  non-partitionable threefry its goldens were pinned with);
* **clean on the port** — each section passes on the port's own tick;
* **seeded violations** — each rule is fed a deliberately broken input
  and must fire: the layout rules, key reuse, path collision and unnamed
  streams, the lint's ``f64``/``sync``/``transfer``/``writeback`` rules
  and the capture sentinel.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import layout_check as jlayout
from repro.analysis import simcheck as jsimcheck
from test_torch_phases import jax_reference

from repro_torch import random as rnd
from repro_torch.analysis import layout_check, op_lint, recompile, streams
from repro_torch.analysis.__main__ import main as cli
from repro_torch.analysis.simcheck import LINT_COMBOS, check_streams
from repro_torch.core import Simulation, diamond, scheduler
from repro_torch.core.engine import TickLoop
from repro_torch.core.types import PHASE_COLUMNS

# the port's tensors here are small: one intra-op thread per test
# process beats oversubscribing the cores across test workers
torch.set_num_threads(1)

# Copied from the reference's tests/test_simcheck.py:33-45 (that file does
# not import under this JAX: jax.experimental.enable_x64 is gone).
GOLDEN_STREAM_DIGESTS = {
    "uniform+none": "63d3efb9556990fb",
    "uniform+chaos": "ef15e81868ba91e7",
    "fabric+none": "3c57f57cd8b23c38",
    "fabric+chaos": "bceab1a96eb2745f",
    "fabric+chaos+telemetry": "bceab1a96eb2745f",
    "fabric+chaos+alerting": "bceab1a96eb2745f",
}

# Differences between the port's and the reference's per-phase accesses,
# by (combo, phase) -> (port only, reference only), each with its cause.
# None: the port's tick touches exactly the reference's columns in every
# phase of every combo (the Scaling phase included, which the port
# replays with scale_due=True where the reference's lax.cond traces both
# branches).
LAYOUT_DIFFERENCES: dict = {}


@pytest.fixture(scope="module")
def reference():
    """The reference's stream digests and its accesses of all seven
    combos, computed once."""
    with jax_reference():
        digests = jsimcheck.check_streams()
        layouts = {c: jlayout.replay_accesses(*c) for c in jlayout.COMBOS}
    return digests, layouts


@pytest.fixture(scope="module")
def port_layouts():
    return {c: layout_check.replay_accesses(*c, device="cpu")
            for c in layout_check.COMBOS}


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_stream_digests_match_reference_and_golden(reference):
    ref, _ = reference
    res = check_streams(device="cpu")
    assert res["problems"] == [] and ref["problems"] == []
    assert res["digests"] == ref["digests"]
    assert res["digests"] == GOLDEN_STREAM_DIGESTS


def test_layout_combos_are_the_reference_combos():
    assert layout_check.COMBOS == jlayout.COMBOS


@pytest.mark.parametrize("combo", layout_check.COMBOS,
                         ids=lambda c: "-".join(map(str, c)))
def test_layout_accesses_match_reference(combo, reference, port_layouts):
    _, ref = reference
    got, want = port_layouts[combo], ref[combo]
    diff = {}
    for phase in sorted(set(got) | set(want)):
        a, b = got.get(phase, set()), want.get(phase, set())
        if a != b:
            diff[(combo, phase)] = (sorted(a - b), sorted(b - a))
    expected = {k: v for k, v in LAYOUT_DIFFERENCES.items()
                if k[0] == combo}
    assert diff == expected
    # every phase the reference replays records here too
    assert set(got) == set(want)


# ---------------------------------------------------------------------------
# clean on the port
# ---------------------------------------------------------------------------

def test_layout_check_clean(port_layouts):
    assert layout_check.check_layout_access(replays=port_layouts) == []


@pytest.mark.parametrize("combo", LINT_COMBOS, ids="-".join)
def test_lint_combo_clean(combo):
    assert op_lint.lint_combo(*combo, device="cpu") == []


def test_sentinel_counts_no_capture_when_warm():
    rep = recompile.run_sentinel(n_points=3, device="cpu")
    assert rep.problems == []
    assert rep.warm.captures == 8 and rep.counting.captures == 0
    assert rep.warm.builds == rep.counting.builds == 0


def test_cli_exit_codes(capsys):
    assert cli(["--only", "streams", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[simcheck] streams: clean" in out and "[simcheck] OK" in out
    for combo, digest in GOLDEN_STREAM_DIGESTS.items():
        assert f"stream topology {combo}: {digest}" in out
    for sec in ("intervals", "streams,intervals", "bogus"):
        assert cli(["--only", sec, "--device", "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# seeded violations: layout
# ---------------------------------------------------------------------------

def test_layout_catches_undeclared_access(port_layouts):
    perturbed = dict(PHASE_COLUMNS)
    perturbed["Dispatch"] = tuple(
        c for c in PHASE_COLUMNS["Dispatch"] if c != "wait_ticks")
    probs = layout_check.check_layout_access(phase_columns=perturbed,
                                             replays=port_layouts)
    assert any("undeclared" in p and "wait_ticks" in p
               and "'Dispatch'" in p for p in probs)


def test_layout_catches_stale_declaration(port_layouts):
    perturbed = dict(PHASE_COLUMNS)
    perturbed["Execute"] = PHASE_COLUMNS["Execute"] + ("ghost_col",)
    probs = layout_check.check_layout_access(phase_columns=perturbed,
                                             replays=port_layouts)
    assert any("ever touches" in p and "ghost_col" in p for p in probs)


def test_layout_catches_mode_column_in_core_phase(port_layouts):
    combo = ("uniform", "chaos", False, False)
    forged = dict(port_layouts)
    forged[combo] = dict(forged[combo], Response={("edge", "named")})
    probs = layout_check.check_layout_access(replays=forged)
    assert any("non-registry phase 'Response'" in p and "edge" in p
               for p in probs)


def test_layout_catches_spawn_outside_respawn_phases(port_layouts):
    combo = ("uniform", "none", False, False)
    forged = dict(port_layouts)
    forged[combo] = dict(forged[combo], Execute=forged[combo]["Execute"]
                         | {("rem", "spawn")})
    probs = layout_check.check_layout_access(replays=forged)
    assert any("'Execute' performs whole-row spawn" in p for p in probs)


# ---------------------------------------------------------------------------
# seeded violations: streams
# ---------------------------------------------------------------------------

def _table_root():
    table = rnd.KeyTable(2, "cpu")
    table.fill(np.zeros((1, 2), np.int64))
    return table.root()


@pytest.mark.parametrize("host", [True, False], ids=["host", "table"])
def test_streams_catch_key_reuse(host):
    key = rnd.PRNGKey(0) if host else _table_root()
    with streams.recording() as rec:
        rec.register(key, "root")
        streams.split(key, names=("a", "b"))
        streams.split(key, names=("a", "b"))   # identical derivation
    assert any("key reuse" in p for p in streams.audit_events(rec))


@pytest.mark.parametrize("host", [True, False], ids=["host", "table"])
def test_streams_catch_path_collision(host):
    key = rnd.PRNGKey(0) if host else _table_root()
    with streams.recording() as rec:
        rec.register(key, "root")
        streams.fold_in(key, 1, name="x")
        streams.fold_in(key, 2, name="x")      # distinct stream, same name
    assert any("path collision" in p for p in streams.audit_events(rec))


@pytest.mark.parametrize("host", [True, False], ids=["host", "table"])
def test_streams_catch_unnamed_derivation(host):
    key = rnd.PRNGKey(0) if host else _table_root()
    with streams.recording() as rec:
        rec.register(key, "root")
        orphan = rnd.fold_in(key, 7)           # raw call — unwrapped site
        streams.split(orphan, names=("a", "b"))
    assert any("unnamed stream" in p for p in streams.audit_events(rec))


def test_streams_name_table_children_by_path():
    key = _table_root()
    with streams.recording() as rec:
        rec.register(key, "tick")
        a, b = streams.split(key, names=("a", "b"))
        streams.fold_in(b, 3, name="c")
        # an equal TableKey built anew is the same stream
        again = rnd.TableKey(key.table, key.path + ((2, 0),))
        streams.split(again, names=("x", "y"))
    assert streams.audit_events(rec) == []
    assert streams.topology_lines(rec) == [
        "tick --split(2)--> [a, b]", "tick/b --fold_in(3)--> [c]",
        "tick/a --split(2)--> [x, y]"]


def test_streams_validate_names():
    key = rnd.PRNGKey(0)
    with pytest.raises(ValueError):
        streams.split(key, 3, names=("a", "b"))
    with pytest.raises(ValueError):
        streams.split(key, names=("a", "a"))
    with pytest.raises(ValueError):
        streams.fold_in(key, 1, name="")


def test_streams_are_transparent_outside_recording():
    key = rnd.PRNGKey(0)
    assert torch.equal(streams.split(key, 3, names=("a", "b", "c")),
                       rnd.split(key, 3))
    assert torch.equal(streams.fold_in(key, 5, name="x"),
                       rnd.fold_in(key, 5))
    with streams.recording() as rec:
        rec.register(key, "root")
        named = streams.split(key, 3, names=("a", "b", "c"))
        assert torch.equal(torch.stack(list(named)), rnd.split(key, 3))


# ---------------------------------------------------------------------------
# seeded violations: op lint
# ---------------------------------------------------------------------------

def _combo_sim():
    return layout_check._tiny_sim("uniform", "none", False, device="cpu")


def _lint_with(monkeypatch, hook):
    """Lint the tiny sim with ``hook(state)`` run inside the Response
    phase (``scheduler.complete``) of every step."""
    complete = scheduler.complete

    def patched(state, *a, **k):
        return complete(hook(state), *a, **k)

    monkeypatch.setattr(scheduler, "complete", patched)
    return op_lint.lint_sim(_combo_sim())[0]


def test_lint_catches_undeclared_f64(monkeypatch):
    probs = _lint_with(monkeypatch, lambda s: s._replace(
        time=(s.time.double() * 1.0).float()))
    assert any(p.startswith("f64:") for p in probs)


def test_lint_allows_declared_f64(monkeypatch):
    def widen(t):
        return (t.double() * 1.0).float()

    op_lint.declare_wide(widen)
    try:
        probs = _lint_with(monkeypatch,
                           lambda s: s._replace(time=widen(s.time)))
    finally:
        op_lint._DECLARED_WIDE.pop(widen.__code__)
    assert probs == []
    assert "repro_torch.random.fma32" in op_lint._DECLARED_WIDE.values()


def test_lint_catches_host_read(monkeypatch):
    probs = _lint_with(monkeypatch, lambda s: s._replace(
        time=s.time + 0.0 * float(s.time.sum().item())))
    assert any(p.startswith("sync: _local_scalar_dense") for p in probs)


def test_lint_catches_mask_index(monkeypatch):
    def hook(s):
        t = s.time.clone()
        t[t < 0] = 0.0                       # boolean-mask indexing
        return s._replace(time=t)

    probs = _lint_with(monkeypatch, hook)
    assert any(p.startswith("sync: index_put_") for p in probs)


def test_lint_catches_host_built_tensor(monkeypatch):
    probs = _lint_with(monkeypatch, lambda s: s._replace(
        time=s.time + torch.tensor([0.0])))
    assert any(p.startswith("transfer: lift_fresh") for p in probs)


class _Leaky(TickLoop):
    """A step whose next ``time`` is a fresh tensor, not written back."""

    def step(self, *a, **k):
        super().step(*a, **k)
        self.state = self.state._replace(time=self.state.time + 0.0)


def test_lint_catches_leaf_escaping_write_back():
    sim = _combo_sim()
    loop = layout_check.eager_loop(sim, cap=5)
    loop.__class__ = _Leaky
    probs = op_lint.lint_loop(loop, (False, True))[0]
    assert any(p.startswith("writeback: loop buffer state.time")
               for p in probs)


def test_lint_catches_shared_storage():
    sim = _combo_sim()
    loop = layout_check.eager_loop(sim, cap=5)
    st = loop.state
    loop.state = st._replace(requests=st.requests._replace(
        finish=st.requests.arrival))
    probs = op_lint.check_storage(loop)
    assert any("requests.arrival" in p and "requests.finish" in p
               for p in probs)


def test_tick_ops_by_site_counts_the_phases():
    sites = op_lint.tick_ops_by_site(_combo_sim())
    assert isinstance(sites, collections.Counter)
    assert sum(sites.values()) > 100
    assert any(k.startswith("scheduler.py:") for k in sites)
    assert any(k.endswith("(random.py)") for k in sites)


# ---------------------------------------------------------------------------
# the shared capture key and the sentinel's seeded violation
# ---------------------------------------------------------------------------

def _key(sim, B=1):
    return sim._capture_key(sim.init_state(), B, (False, True))


def test_equal_structures_share_a_capture_key():
    a = _combo_sim()
    b = layout_check._tiny_sim("uniform", "none", False, device="cpu")
    b.params = dataclasses.replace(b.params, spawn_rate=3.0, slo_ms=7.0,
                                   seed=11, wait_hi=0.9)
    b = Simulation(diamond(mi=900.0), caps=b.caps, params=b.params,
                   device="cpu")
    assert a is not b and _key(a) == _key(b)
    assert _key(a) != _key(a, B=8)


def test_capture_key_holds_static_fields_and_app_shapes():
    a = _combo_sim()
    for knob in (dict(lb_policy=1), dict(share_policy=1),
                 dict(n_ticks=5)):
        b = Simulation(diamond(mi=200.0), caps=a.caps,
                       params=dataclasses.replace(a.params, **knob),
                       device="cpu")
        assert _key(b) != _key(a), knob
    wide = Simulation(diamond(mi=200.0), caps=a.caps, params=a.params,
                      device="cpu")
    wide.app = wide.app._replace(
        tmpl_mips=torch.cat([wide.app.tmpl_mips, wide.app.tmpl_mips[:1]]))
    assert _key(wide) != _key(a)


def test_sentinel_catches_changed_static_field():
    seen: set = set()
    sim = _combo_sim()
    with recompile.count_captures("cpu", seen) as warm:
        sim.run()
    changed = Simulation(diamond(mi=200.0), caps=sim.caps,
                         params=dataclasses.replace(sim.params, lb_policy=1),
                         device="cpu")
    with recompile.count_captures("cpu", seen) as cold:
        changed.run()
        _combo_sim().run(seed=3)
    assert warm.captures == 1 and cold.captures == 1
    rep = recompile.SentinelReport(warm, cold, "cpu")
    assert rep.problems and rep.problems[0].startswith("recompile: 1 ")
