"""The port's waiver file (``repro_torch/analysis/waivers.py``) against the
reference's, on the reference's own test inputs (``tests/test_waivers.py``):
a waiver is a dated loan against the analyzers — matching suppresses,
expiry and staleness both fail."""
import datetime

import pytest

from repro.analysis import waivers as jwaivers

from repro_torch.analysis import waivers as twaivers

TODAY = datetime.date(2026, 8, 8)


def _w(mod, rule, site="", expires=datetime.date(2026, 12, 31),
       reason="tracked in #1"):
    return mod.Waiver(rule=rule, site=site, reason=reason, expires=expires)


# (findings, waivers as (rule, site, expires)) of the reference's tests
CASES = {
    "matching": ([("donation", "[uniform+none] donation: 3/9 not donated"),
                  ("f64", "[uniform+none] f64: widening")],
                 [("donation", "", datetime.date(2026, 12, 31))]),
    "site": ([("dup-scatter", "FAIL pool.py:26 ..."),
              ("dup-scatter", "FAIL scheduler.py:99 ...")],
             [("dup-scatter", "pool.py:26", datetime.date(2026, 12, 31))]),
    "expired": ([("donation", "donation: not donated")],
                [("donation", "", datetime.date(2026, 1, 1))]),
    "unused": ([], [("oob-gather", "", datetime.date(2026, 12, 31))]),
    "port rules": ([("writeback", "[uniform+none] writeback: moved"),
                    ("sync", "[fabric+chaos] sync: item")],
                   [("writeback", "uniform", datetime.date(2026, 12, 31)),
                    ("f64", "", datetime.date(2026, 9, 1))]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_waivers_matches_reference(case):
    findings, rows = CASES[case]
    got = twaivers.apply_waivers(
        findings, [_w(twaivers, r, s, e) for r, s, e in rows], today=TODAY)
    want = jwaivers.apply_waivers(
        findings, [_w(jwaivers, r, s, e) for r, s, e in rows], today=TODAY)
    assert got == want


def test_expired_and_unused_waivers_fail():
    surviving, probs = twaivers.apply_waivers(
        [("sync", "sync: item")],
        [_w(twaivers, "sync", expires=datetime.date(2026, 1, 1)),
         _w(twaivers, "transfer")], today=TODAY)
    assert surviving == ["sync: item"]
    assert "expired 2026-01-01" in probs[0]
    assert "matched no finding" in probs[1]


def test_load_waivers_matches_reference(tmp_path):
    p = tmp_path / "waivers.toml"
    p.write_text(
        '[[waiver]]\n'
        'rule = "writeback"\n'
        'site = "pool.py:111"\n'
        'reason = "tracked in #42"\n'
        'expires = 2026-12-31\n')
    got = twaivers.load_waivers(p)
    assert got == [twaivers.Waiver("writeback", "pool.py:111",
                                   "tracked in #42",
                                   datetime.date(2026, 12, 31))]
    assert [vars(w) for w in got] == [vars(w)
                                      for w in jwaivers.load_waivers(p)]


@pytest.mark.parametrize("text,match", [
    ('[[waiver]]\nrule = "f64"\nexpires = 2026-12-31\n', "missing required"),
    ('[[waiver]]\nrule = "x"\nreason = "y"\nexpires = "2026-12-31"\n',
     "TOML date")])
def test_load_waivers_rejects_bad_rows(tmp_path, text, match):
    p = tmp_path / "waivers.toml"
    p.write_text(text)
    with pytest.raises(ValueError, match=match):
        twaivers.load_waivers(p)
    with pytest.raises(ValueError, match=match):
        jwaivers.load_waivers(p)


def test_load_waivers_missing_file_is_empty(tmp_path):
    assert twaivers.load_waivers(tmp_path / "absent.toml") == []


def test_committed_waiver_file_is_empty():
    # every finding of the port's tick is fixed or declared: no waiver
    assert twaivers.load_waivers() == []
    assert twaivers.WAIVERS_PATH.parent.name == "analysis"
    assert "repro_torch" in str(twaivers.WAIVERS_PATH)
