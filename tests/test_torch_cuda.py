"""The port on the card: the CUDA kernels against their plain versions,
and whole runs on the GPU against the CPU path and the reference's pins.

Every test here needs an NVIDIA GPU and the CUDA toolkit (marker
``cuda``) and skips without one.  The file imports neither JAX nor the
JAX package, so on a machine with the card it runs with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: per-lane outputs, request aggregates, the max-plus product
and the water-fill rates bit-equal; the kernel's instance sums (exact
fixed point, rounded once) against the plain serial float32 sums within
``n_i·2^-24·Σ|x| + n_i·2^-33`` per row (the serial sum's error plus one
rounding plus the fixed-point quantisation).  The fabric scenario on
the GPU against the CPU path: the trajectory (every per-lane column,
request, counter and integer leaf) exact; the float statistics the
instance sums feed (``STAT_LEAVES``) within ``STAT_RTOL`` relative, since
the kernel's instance sums are exact sums rounded once where the plain
version adds serially in float32 (a difference of up to that sum's own
rounding error each tick, about 2^-20 relative at this scenario's few
lanes per instance, accumulated over the run); the ``NetStats`` float
sums within ``NET_ULPS`` (the same sums in the same order on both
devices; they feed no later phase).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (InstanceTemplate, SimCaps, SimParams,
                              Simulation, convert, diamond)
from repro_torch.core.types import Cloudlets, resolve_layout
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.cloudlet_step import cloudlet_finish_pool
from repro_torch.kernels.cloudlet_step import ref as tfinish
from repro_torch.kernels.link_share import link_share
from repro_torch.kernels.link_share import ref as tlink
from repro_torch.kernels.tropical import ops as ttrop
from repro_torch.kernels.tropical import ref as ttrop_ref

pytestmark = pytest.mark.cuda

NET_ULPS = 2
STAT_RTOL = 2.0 ** -17
STAT_LEAVES = ("instances.used_mips", "instances.util_ema",
               "instances.usage_sum", "svc_stats.usage_sum",
               "svc_stats.delay_sum", "svc_stats.exec_sum",
               "svc_stats.wait_sum")

NAMES = ("new_rem", "fin", "tfin", "consumed", "inst_acc", "req_finish",
         "req_crit", "req_out")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def _pool_inputs(C, I, R, seed, dev):
    r = np.random.default_rng(seed)
    L = resolve_layout(SimParams())
    ints = np.zeros((C, len(L.i_fields)), np.int32)
    flts = np.zeros((C, len(L.f_fields)), np.float32)
    ints[:, L.i("status")] = r.choice([0, 1, 2], size=C, p=[.3, .2, .5])
    ints[:, L.i("inst")] = r.integers(-1, I + 2, size=C)   # some past I
    ints[:, L.i("req")] = r.integers(-1, R + 2, size=C)    # some past R
    ints[:, L.i("depth")] = r.integers(0, 4, size=C)
    flts[:, L.f("rem")] = r.uniform(0.1, 500.0, size=C)
    flts[:, L.f("arrival")] = r.uniform(0.0, 12.0, size=C)
    flts[:, L.f("start")] = np.where(r.random(C) < 0.5, -1.0,
                                     r.uniform(0.0, 12.5, size=C))
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    cl = Cloudlets(t(ints), t(flts), L)
    rate = t(r.uniform(0.0, 300.0, size=C).astype(np.float32))
    req = (t(r.uniform(0.0, 12.0, size=R).astype(np.float32)),
           t(r.integers(0, 3, size=R).astype(np.int32)),
           t(r.integers(0, 5, size=R).astype(np.int32)))
    return cl, rate, req


@pytest.mark.parametrize("C,I,R", [(256, 8, 32), (1000, 33, 2000),
                                   (8000, 1000, 100_000)])
@pytest.mark.parametrize("dt", [0.25, 0.1])
def test_cloudlet_finish_kernel_matches_plain(C, I, R, dt, dev):
    cl, rate, req = _pool_inputs(C, I, R, C, dev)
    L = cl.layout
    time = torch.tensor(np.float32(12.5), device=dev)
    before = counts["cloudlet_finish"]
    got = cloudlet_finish_pool(cl, rate, time, dt,
                               *[x.clone() for x in req], n_inst=I)
    again = cloudlet_finish_pool(cl, rate, time, dt,
                                 *[x.clone() for x in req], n_inst=I)
    assert counts["cloudlet_finish"] == before + 2
    col = lambda n: (cl.ints[:, L.i(n)] if n in L.i_fields
                     else cl.flts[:, L.f(n)])
    want = tfinish.cloudlet_finish(
        col("status"), col("rem"), col("inst"), col("req"), col("arrival"),
        col("start"), col("depth"), rate, time, dt, *req, n_inst=I)
    torch.cuda.synchronize()
    for name, g, a, w in zip(NAMES, got, again, want):
        assert torch.equal(g, a), f"{name}: two launches differ"
        if name != "inst_acc":
            assert torch.equal(g, w), name
    bound = tfinish.inst_acc_bound(
        col("status"), col("rem"), col("inst"), col("arrival"),
        col("start"), rate, time, dt, n_inst=I)
    err = (got.inst_acc.double() - want.inst_acc.double()).abs()
    assert bool((err <= bound).all()), float(err.max())


def test_cloudlet_finish_progress_rounds_once(dev):
    # rem - rate*dt = 2 - (2^-24 + 2^-61): just below the float32 midpoint
    # 2 - 2^-24, so it rounds down to 2 - 2^-23; a sum rounded to float64
    # first lands on the midpoint and ties up to 2
    C, I, R = 64, 4, 8
    cl, rate, req = _pool_inputs(C, I, R, 3, dev)
    L = cl.layout
    cl.ints[:, L.i("status")] = 2
    cl.flts[:, L.f("rem")] = 2.0
    rate.fill_(float(np.float32(11860630 * 2.0 ** -23)))
    dt = float(np.float32(11865937 * 2.0 ** -48))
    time = torch.tensor(np.float32(1.0), device=dev)
    got = cloudlet_finish_pool(cl, rate, time, dt, *req, n_inst=I)
    assert bool((got.new_rem == float(np.float32(2.0 - 2.0 ** -23))).all())


@pytest.mark.parametrize("B,M,K,N", [(4, 130, 70, 257), (60, 13, 13, 13),
                                     (2, 1, 1, 1), (1, 64, 0, 64),
                                     (70_000, 2, 3, 2)])
def test_tropical_kernel_matches_plain(B, M, K, N, dev):
    r = np.random.default_rng(B + M + K + N)
    mk = lambda shape: torch.from_numpy(np.where(
        r.random(shape) < 0.7, r.normal(size=shape) * 3.0,
        -np.inf).astype(np.float32)).to(dev)
    x, a = mk((B, M, K)), mk((B, K, N))
    got = ttrop.tropical_matmul(x, a)
    assert torch.equal(got, ttrop_ref.tropical_matmul(x, a))
    s = mk((3, 24, 24))
    want = torch.maximum(s, ttrop_ref.tropical_identity(24, device=dev))
    for _ in range(5):
        want = ttrop_ref.tropical_matmul(want, want)
    assert torch.equal(ttrop.tropical_closure(s), want)


def _golden(device):
    caps = SimCaps(n_clients=16, max_requests=512, max_cloudlets=512,
                   max_instances=8, n_vms=4, d_max=2, max_replicas=2)
    params = SimParams(dt=0.05, n_ticks=300, n_clients=12, spawn_rate=5.0,
                       wait_lo=0.5, wait_hi=1.5, seed=3, net_latency_s=0.05)
    return Simulation(diamond(mi=400.0), caps=caps, params=params,
                      default_template=InstanceTemplate(
                          mips=8000.0, limit_mips=16000.0, replicas=2),
                      vm_mips=np.full(4, 64000.0, np.float32),
                      device=device)


def test_golden_scenario_on_card_matches_cpu_and_pins(dev):
    reset_counts()
    gpu = _golden(dev).run()
    assert counts["cloudlet_finish"] == 300
    cpu = _golden("cpu").run()
    g = convert.state_to_numpy(gpu.state)
    c = convert.state_to_numpy(cpu.state)

    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v
    cd = dict(flat(c))
    for k, v in flat(g):
        np.testing.assert_array_equal(v, cd[k], err_msg=k)
    st = gpu.state
    assert int(st.counters.completed) == 157
    assert int(st.counters.spawned) == 794
    assert int(st.counters.finished) == 789
    resp = st.requests.response.cpu().numpy()
    assert int(resp.view(np.uint32).astype(np.uint64).sum()) \
        == 1306795296637


def _link_inputs(C, H, seed, dev):
    """Transfers over random ports (a tenth client uploads, a twentieth
    with no destination, a quarter inactive), capacities 0.5-100 MB/s
    with port 0 at zero when there are others."""
    r = np.random.default_rng(seed)
    src = r.integers(0, H, C).astype(np.int32)
    src[r.random(C) < 0.1] = -1
    dst = r.integers(0, H, C).astype(np.int32)
    dst[r.random(C) < 0.05] = -1
    active = r.random(C) < 0.75
    cap_e = r.uniform(0.5, 100.0, H).astype(np.float32)
    cap_i = r.uniform(0.5, 100.0, H).astype(np.float32)
    if H > 1:
        cap_e[0] = cap_i[0] = 0.0
    return [torch.from_numpy(a).to(dev)
            for a in (src, dst, active, cap_e, cap_i)]


# SockShop, case1b+net, case2b+net, then ragged: C not a multiple of
# 1024, one host, fewer lanes than a warp
@pytest.mark.parametrize("C,H", [(8192, 10), (8000, 15), (262_144, 781),
                                 (3001, 37), (1000, 1), (5, 3)])
@pytest.mark.parametrize("iters", [1, 2, 4])
def test_link_share_kernel_matches_plain(C, H, iters, dev):
    args = _link_inputs(C, H, C + H + iters, dev)
    before = counts["link_share"]
    got = link_share(*args, iters=iters)
    again = link_share(*args, iters=iters)
    assert counts["link_share"] == before + 2
    want = tlink.waterfill(*args, iters)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two launches differ"
    assert torch.equal(got, want)
    if C >= 1000:
        assert bool((got > 0).any())


def test_link_share_wrapper_checks_its_inputs(dev):
    args = _link_inputs(64, 4, 0, dev)
    with pytest.raises(TypeError, match="dtype"):
        link_share(args[0].long(), *args[1:], iters=2)
    with pytest.raises(ValueError, match="hosts"):
        big = [torch.ones(20_000, device=dev)] * 2
        link_share(*args[:3], *big, iters=2)


def _fabric(device):
    """The reference's golden fabric scenario (test_layouts.matrix_sim
    ("fabric", "none"))."""
    caps = SimCaps(n_clients=16, max_requests=512, max_cloudlets=512,
                   max_instances=8, n_vms=4, d_max=2, max_replicas=2)
    params = SimParams(dt=0.05, n_ticks=300, n_clients=12, spawn_rate=5.0,
                       wait_lo=0.5, wait_hi=1.5, seed=3, network="fabric",
                       nic_egress_mbps=50.0, nic_ingress_mbps=50.0)
    return Simulation(diamond(mi=400.0), caps=caps, params=params,
                      default_template=InstanceTemplate(
                          mips=8000.0, limit_mips=16000.0, replicas=2),
                      vm_mips=np.full(4, 64000.0, np.float32),
                      device=device)


def _ulps(a, b):
    key = lambda x: np.where(x.view(np.int32) < 0,
                             -(x.view(np.int32) & 0x7FFFFFFF),
                             x.view(np.int32)).astype(np.int64)
    return int(np.abs(key(a) - key(b)).max(initial=0))


def test_fabric_scenario_on_card_matches_cpu_and_pins(dev):
    reset_counts()
    gpu = _fabric(dev).run()
    assert counts["link_share"] == 300
    assert counts["cloudlet_finish"] == 300
    cpu = _fabric("cpu").run()
    g = convert.state_to_numpy(gpu.state)
    c = convert.state_to_numpy(cpu.state)
    net_g, net_c = g.pop("net"), c.pop("net")

    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v
    cd = dict(flat(c))
    for k, v in flat(g):
        if k in STAT_LEAVES:
            np.testing.assert_allclose(v, cd[k], rtol=STAT_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, cd[k], err_msg=k)
    for k, v in net_g.items():
        if v.dtype.kind == "f":
            assert _ulps(v, net_c[k]) <= NET_ULPS, k
        else:
            np.testing.assert_array_equal(v, net_c[k], err_msg=k)
    st = gpu.state
    assert int(st.counters.completed) == 163
    assert int(st.counters.spawned) == 830
    assert int(st.counters.finished) == 822
    assert int(st.net.transits) == 606
    resp = st.requests.response.cpu().numpy()
    assert int(resp.view(np.uint32).astype(np.uint64).sum()) \
        == 1292572014442
