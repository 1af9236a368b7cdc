"""The port's ``link_share`` water-fill against the JAX reference.

The plain version (``repro_torch.kernels.link_share.ref.waterfill``, what
the CUDA kernel computes bit for bit) against the reference's jitted
``ref.link_share`` and its Pallas kernel run in interpret mode: every rate
bit-identical, at the one-hot shape (8192 lanes × 10 hosts, SockShop's
pool) and the scatter shape (8192 × 600) of the reference's occupancy
switch, for 1, 2 and 4 rounds, with client uploads (``src = -1``), lanes
with no destination, inactive lanes and a zero-capacity port.  The
reference drains the ports with one fused multiply-add, here and inside
its compiled simulation tick (``tests/test_torch_network.py`` holds the
latter).

The card kernel's occupancy, emulated: counted once over lane slices
(the blocks of a grid launch) and decremented by the transfers that
freeze, it gives the reference's rates bit for bit at every shape and
round count above.

The wrapper takes the plain version for CPU tensors only and counts no
launch there; the kernel on the card is held against the plain version in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels.link_share import link_share_pallas
from repro.kernels.link_share import ref as jref

from repro_torch.kernels import counts
from repro_torch.kernels.link_share import link_share, waterfill
from repro_torch.kernels.link_share import ref as tref

torch.set_num_threads(1)


def _inputs(C, H, seed, dead_port=True):
    """Transfers over random ports: a tenth client uploads, a twentieth
    with no destination, a quarter inactive; capacities 0.5-100 MB/s with
    port 0 at zero in both directions."""
    r = np.random.default_rng(seed)
    src = r.integers(0, H, C).astype(np.int32)
    src[r.random(C) < 0.1] = -1
    dst = r.integers(0, H, C).astype(np.int32)
    dst[r.random(C) < 0.05] = -1
    active = r.random(C) < 0.75
    cap_e = r.uniform(0.5, 100.0, H).astype(np.float32)
    cap_i = r.uniform(0.5, 100.0, H).astype(np.float32)
    if dead_port:
        cap_e[0] = cap_i[0] = 0.0
    return src, dst, active, cap_e, cap_i


def _port(args, iters):
    return tref.link_share(*(torch.from_numpy(a) for a in args),
                           iters).numpy()


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


SHAPES = [(8192, 10), (8192, 600), (1000, 1), (3001, 37)]


@pytest.mark.parametrize("iters", [1, 2, 4])
@pytest.mark.parametrize("C,H", SHAPES)
def test_waterfill_matches_jitted_reference(C, H, iters):
    args = _inputs(C, H, C + H + iters)
    want = np.asarray(jref.link_share(*args, iters))
    got = _port(args, iters)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    src, dst, active = args[:3]
    assert (got[~active | (dst < 0)] == 0).all()
    assert (got[active & (dst > 0) & (src != 0)] > 0).all()
    assert (got[active & ((dst == 0) | (src == 0))] == 0).all()


@pytest.mark.parametrize("iters", [1, 2, 4])
@pytest.mark.parametrize("C,H", SHAPES[:2])
def test_waterfill_matches_pallas_interpret(C, H, iters):
    args = _inputs(C, H, 7 * C + H + iters)
    want = np.asarray(link_share_pallas(*args, iters=iters, interpret=True))
    np.testing.assert_array_equal(_bits(_port(args, iters)), _bits(want))


def _sliced_waterfill(src, dst, active, cap_e, cap_i, iters, k):
    """Emulation of ``csrc/link_share.cu``'s occupancy over ``k`` lane
    slices (the blocks of a grid launch): each slice counts its live
    transfers' ports once; after each round it subtracts only its
    transfers that froze; the global table is the slices' sum.  The water
    level, the drain and the fill are the plain version's."""
    f32 = torch.float32
    H, C = cap_e.shape[0], src.shape[0]
    live = active & (dst >= 0)
    has_src = src >= 0
    bounds = np.linspace(0, C, k + 1).astype(int)

    def count(mask):      # per slice, then summed: exact integers
        e = sum(tref._count(src[a:b], mask[a:b] & has_src[a:b], H)
                for a, b in zip(bounds, bounds[1:]))
        i = sum(tref._count(dst[a:b], mask[a:b], H)
                for a, b in zip(bounds, bounds[1:]))
        return e, i
    n_e, n_i = count(live)
    rate = torch.zeros(C, dtype=f32)
    rem_e, rem_i = cap_e.clone(), cap_i.clone()
    inf, zero = torch.tensor(float("inf")), torch.tensor(0.0)
    for _ in range(iters):
        lam = torch.minimum(
            torch.where(n_e > 0, rem_e / n_e.clamp_min(1.0), inf).min(),
            torch.where(n_i > 0, rem_i / n_i.clamp_min(1.0), inf).min())
        lam = torch.where(torch.isfinite(lam), lam.clamp_min(0.0), zero)
        rate = rate + torch.where(live, lam, zero)
        rem_e, rem_i = tref.fma32(n_e, -lam, rem_e), tref.fma32(n_i, -lam,
                                                                 rem_i)
        sat_e = (n_e > 0) & (rem_e <= tref.SAT_REL * cap_e)
        sat_i = (n_i > 0) & (rem_i <= tref.SAT_REL * cap_i)
        frozen = live & ((has_src & tref._gather(sat_e, src))
                         | tref._gather(sat_i, dst))
        d_e, d_i = count(frozen)
        n_e, n_i = n_e - d_e, n_i - d_i
        live = live & ~frozen
    fill = torch.minimum(
        torch.where(has_src, tref._gather(rem_e / n_e.clamp_min(1.0), src),
                    inf), tref._gather(rem_i / n_i.clamp_min(1.0), dst))
    return rate + torch.where(live, fill.clamp_min(0.0), zero)


@pytest.mark.parametrize("iters", [1, 2, 4])
@pytest.mark.parametrize("C,H", SHAPES)
def test_decrement_only_occupancy_gives_the_references_rates(C, H, iters):
    """The card's design, emulated: occupancy counted once over 7 lane
    slices and decremented by the transfers that freeze, against the
    reference's jitted water-fill (which recounts every round)."""
    args = _inputs(C, H, 3 * C + H + iters)
    want = np.asarray(jref.link_share(*args, iters))
    got = _sliced_waterfill(*(torch.from_numpy(a) for a in args), iters,
                            k=7).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_rounds_and_the_fused_drain_matter(monkeypatch):
    """On these inputs each extra round changes rates, and rounding the
    port drain twice changes bits: the tests above decide both."""
    args = _inputs(8192, 10, 3, dead_port=False)
    by_iters = [_port(args, k) for k in (1, 2, 4)]
    assert not np.array_equal(by_iters[0], by_iters[1])
    assert not np.array_equal(by_iters[1], by_iters[2])
    cases = [_inputs(C, H, s) for s, (C, H) in enumerate(SHAPES)]
    fused = [_port(a, 2) for a in cases]
    monkeypatch.setattr(tref, "fma32", lambda a, b, c: c + a * b)
    diff = sum(int((_bits(f) != _bits(_port(a, 2))).sum())
               for f, a in zip(fused, cases))
    assert diff > 0


def test_max_min_fairness_on_a_small_case():
    """Two ports: three transfers into host 0 (cap 3), one of them also
    out of host 1 (cap 0.5) — it takes 0.5, the other two split the rest
    (1.25 each); a client upload into host 1 (cap 4) takes all of it."""
    src = np.array([1, -1, -1, -1], np.int32)
    dst = np.array([0, 0, 0, 1], np.int32)
    active = np.ones(4, bool)
    cap_e = np.array([10.0, 0.5], np.float32)
    cap_i = np.array([3.0, 4.0], np.float32)
    args = (src, dst, active, cap_e, cap_i)
    got = _port(args, 2)
    np.testing.assert_array_equal(got, np.float32([0.5, 1.25, 1.25, 4.0]))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jref.link_share(*args, 2)))


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    args = [torch.from_numpy(a) for a in _inputs(512, 4, 1)]
    before = dict(counts)
    got = link_share(*args, iters=2)
    assert counts == before          # no kernel launch counted
    assert torch.equal(got, waterfill(*args, 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        link_share(*(a.to("meta") for a in args), iters=2)
