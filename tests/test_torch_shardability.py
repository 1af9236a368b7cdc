"""The port's sharding-readiness audit (``repro_torch.analysis.
shardability``) against the reference's (``tests/test_shardability.py``).

Every case of the reference's self-tests, written as torch functions with
the same verdicts (a planted gather, a reduction over C, a scatter-add, a
cumsum, an extent collision, ``default_spec``, the baseline round trip,
growth, a missing combo, the JSON shapes); the units that count a port
idiom as the reference's one primitive; and, per golden combo, the port's
nonzero (phase, class) pairs against the reference's committed baseline
(``src/repro/analysis/shard_baseline.json``, the reference's result on the
JAX it was pinned under: on JAX 0.9.0 its live audit no longer reproduces
it, since the nested-call primitive is named ``jit`` there, not ``pjit``),
and the port's own committed baseline gate clean.  CPU only; the card's
report against the CPU's is in ``test_torch_cuda.py``.
"""
import json
import pathlib

import pytest
import torch

from repro_torch.analysis import shardability as sh
from repro_torch.analysis import simcheck
from repro_torch.core import pool

torch.set_num_threads(1)

C = 16          # pretend cloudlet-axis extent for these tests
SPEC = {"C": (C,)}
REF_BASELINE = (pathlib.Path(__file__).resolve().parents[1] / "src"
                / "repro" / "analysis" / "shard_baseline.json")

# (phase, class) pairs in which the port's audit and the reference's
# committed baseline differ, per combo, each with the op behind it.  The
# port's ops land in exactly the reference's pairs on every golden combo.
PAIR_DIFFERENCES: dict = {}


def _audit(fn, *args, spec=SPEC, combo="adhoc"):
    return sh.audit_ops(sh.record(fn, *args), spec, combo)


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

def test_elementwise_on_sharded_axis_is_local():
    rep = _audit(lambda x: x * 2.0 + 1.0, torch.ones(C))
    assert rep.entries == []
    assert rep.n_local == rep.n_total > 0


def test_planted_cross_shard_gather_reported():
    x = torch.ones(C)
    idx = torch.zeros(C, dtype=torch.int64)
    # lanes read OTHER lanes of the C-sharded operand: needs a gather
    rep = _audit(lambda t, i: t[i], x, idx)
    assert any(e.cls == "gather" and e.prim == "gather"
               for e in rep.entries)


def test_planted_cross_shard_reduction_reported():
    rep = _audit(lambda x: torch.sum(x), torch.ones(C))
    assert any(e.cls == "all_reduce" for e in rep.entries)


def test_reduction_over_unsharded_axis_is_local():
    # reducing the UNLABELED trailing axis keeps every lane independent
    rep = _audit(lambda x: torch.sum(x, dim=1), torch.ones(C, 5))
    assert rep.entries == []


def test_scatter_add_into_sharded_target_is_all_reduce():
    tbl = torch.zeros(C)
    ids = torch.zeros(8, dtype=torch.int64)
    vals = torch.ones(8)
    rep = _audit(lambda t, i, v: t.index_add(0, i, v), tbl, ids, vals)
    assert any(e.cls == "all_reduce" and "scatter" in e.prim
               for e in rep.entries)


def test_cumsum_along_sharded_axis_needs_gather():
    rep = _audit(lambda x: torch.cumsum(x, 0), torch.ones(C))
    assert any(e.cls == "gather" for e in rep.entries)


def test_units_count_as_the_references_primitives():
    """``pool.tree_sum`` reshapes C into 32-wide windows (here 96 lanes:
    3 windows): one ``reduce_sum`` all-reduce, not a reshape gather;
    ``pool.add_drop`` (overflow rows, a flattened batch) is one
    scatter-add; ``pool.take`` one gather."""
    n = 96
    spec = {"C": (n,)}
    rep = _audit(lambda x: pool.tree_sum(x, dim=1), torch.ones(1, n),
                 spec=spec)
    assert [(e.cls, e.prim) for e in rep.entries] \
        == [("all_reduce", "reduce_sum")]
    assert rep.n_total == 1
    rep = _audit(lambda d, i: pool.add_drop(d, i, 1.0),
                 torch.zeros(1, 5), torch.zeros(1, n, dtype=torch.int32),
                 spec=spec)
    assert [(e.cls, e.prim) for e in rep.entries] \
        == [("all_reduce", "scatter-add")]
    rep = _audit(lambda t, i: pool.take(t, i), torch.ones(1, n),
                 torch.zeros(1, 4, dtype=torch.int32), spec=spec)
    assert [(e.cls, e.prim) for e in rep.entries] == [("gather", "gather")]


def test_kernel_wrapper_counts_as_its_plain_version():
    """A kernel wrapper's call is recorded as its plain version's ops on
    CPU copies of its arguments (what the card records too), not as the
    wrapper's own."""
    from repro_torch.kernels.link_share import link_share
    from repro_torch.kernels.link_share import ref as ls_ref
    src = torch.tensor([0, 1, 2, -1, 1], dtype=torch.int32)
    dst = torch.tensor([1, 2, 0, 1, 0], dtype=torch.int32)
    act = torch.tensor([True, True, False, True, True])
    cap = torch.full((3,), 2.0)
    ops = sh.record(link_share, src, dst, act, cap, cap)
    plain = sh.record(ls_ref.link_share_batched, src[None], dst[None],
                      act[None], cap[None], cap[None])
    # the solo call's batch axis (ops.py) apart, the plain version's ops
    # at their own sites, as a top-level call records them
    assert [(o.kind, o.site) for o in ops if not o.site.startswith("ops")] \
        == [(o.kind, o.site) for o in plain]
    assert any(o.site.startswith("ref.py") for o in ops)


# ---------------------------------------------------------------------------
# Spec handling
# ---------------------------------------------------------------------------

def test_extent_collision_rejected():
    with pytest.raises(ValueError, match="labeled both"):
        sh.ShardAudit({"C": (8,), "I": (8,)})


def test_default_spec_separates_axes():
    class Caps:
        max_cloudlets = 96
        max_instances = 12

    spec = sh.default_spec(Caps())
    assert spec["C"] == (96,)
    assert spec["I"] == (12, 13)      # [I] rows and [I+1] accumulators
    sh.ShardAudit(spec)               # collision-free by construction


# ---------------------------------------------------------------------------
# Baseline comparator
# ---------------------------------------------------------------------------

def _report_for(fn, *args):
    return _audit(fn, *args, combo="test+combo")


def test_baseline_roundtrip_is_clean():
    rep = _report_for(lambda x: torch.sum(x), torch.ones(C))
    assert sh.compare_to_baseline([rep], sh.baseline_json([rep])) == []


def test_baseline_catches_new_cross_shard_op():
    clean = _report_for(lambda x: x * 2.0, torch.ones(C))
    grown = _report_for(lambda x: x * torch.sum(x), torch.ones(C))
    probs = sh.compare_to_baseline([grown], sh.baseline_json([clean]))
    assert probs and any("grew" in p for p in probs)


def test_baseline_catches_missing_combo():
    rep = _report_for(lambda x: torch.sum(x), torch.ones(C))
    probs = sh.compare_to_baseline([rep], {"combos": {}})
    assert probs and any("no committed shardability baseline" in p
                         for p in probs)


def test_committed_baseline_covers_golden_combos():
    doc = json.loads(simcheck.SHARD_BASELINE_PATH.read_text())
    for net, fl in simcheck.GOLDEN_COMBOS:
        assert f"{net}+{fl}" in doc["combos"]


def test_report_json_and_phase_table_shapes(tmp_path):
    rep = _report_for(lambda x: torch.sum(x), torch.ones(C))
    doc = rep.to_json()
    assert doc["combo"] == "test+combo"
    assert doc["n_total"] == rep.n_local + len(rep.entries)
    assert all(isinstance(n, int) for n in doc["cross_shard"].values())
    table = rep.phase_table()
    assert all(set(v) == {"gather", "all_reduce"} for v in table.values())
    path = tmp_path / "report.json"
    sh.write_report([rep], str(path))
    full = json.loads(path.read_text())["combos"]["test+combo"]
    assert full["cross_shard"] == doc["cross_shard"]
    assert len(full["entries"]) == len(rep.entries)


# ---------------------------------------------------------------------------
# The golden combos
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return simcheck.check_shardability(device="cpu")


def _pairs(cross_shard: dict) -> set:
    return {tuple(k.split(":")[:2]) for k, n in cross_shard.items() if n}


@pytest.mark.parametrize("combo", [f"{n}+{f}"
                                   for n, f in simcheck.GOLDEN_COMBOS])
def test_phase_class_pairs_match_the_references_baseline(golden, combo):
    reports, _ = golden
    port = _pairs(reports[combo].to_json()["cross_shard"])
    ref = _pairs(json.loads(REF_BASELINE.read_text())
                 ["combos"][combo]["cross_shard"])
    assert port ^ ref == set(PAIR_DIFFERENCES.get(combo, {})), \
        (sorted(port - ref), sorted(ref - port))
    # every phase the engine announced is one of the reference's
    assert {p for p, _ in port} <= set(sh._PHASES)


def test_committed_baseline_gate_is_clean(golden):
    reports, problems = golden
    assert problems == []
    doc = json.loads(simcheck.SHARD_BASELINE_PATH.read_text())
    for combo, rep in reports.items():
        assert doc["combos"][combo] == rep.to_json()


def test_cli_runs_the_section_clean(capsys):
    from repro_torch.analysis.__main__ import main as cli
    assert cli(["--only", "shardability", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[simcheck] shardability: clean" in out
    assert "[simcheck] OK" in out
