"""The port on the card: the CUDA kernels against their plain versions,
and whole runs on the GPU against the CPU path and the reference's pins.

Every test here needs an NVIDIA GPU and the CUDA toolkit (marker
``cuda``) and skips without one.  The file imports neither JAX nor the
JAX package, so on a machine with the card it runs with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the simulator's kernels are held bit for bit.
``cloudlet_finish`` against its plain version run on a CPU copy of the
same inputs (the serial lane-order path the CPU parity tests hold to the
reference): every output, the instance sums included, at the pool shapes
of the tests, case2b and a pool with most lanes on one instance; NaN
where the plain version has NaN.  The max-plus product, the closure
kernel (against the plain squarings) and the water-fill rates bit-equal
(the tropical kernels compared through their int32 view, on inputs
without -0; with NaN and +inf entries, NaN where the plain version has
NaN and every other value equal).  The golden and fabric scenarios on the GPU
against the CPU path: every leaf of the final state exact, ``NetStats``
within ``NET_ULPS`` (0: the same sums in the same order on both
devices).  Both simulator kernels and both tropical kernels, captured in
a CUDA graph and replayed, give the eager launches' bits (one block, and
the cooperative grid at case2b's width).  ``Simulation.run``'s replayed
tick graphs give the eager tick's bits in every leaf and trace (the
golden, fabric and a scaling SockShop scenario, and the chaos combos with
telemetry and alerting on, whose streamed rows equal the eager run's and
the CPU run's too), and ``DecodeGraph``'s logits the eager
``decode_step``'s.  The batch axis: both simulator
kernels over B points in one launch (every route, the cooperative grids
striding over points) bit-equal point by point to each point's unbatched
launch and to the plain version; ``run_batch``'s replayed batched tick
equal to the eager batched tick and each point to its solo run; its
capture free of synchronising calls.

The model-zoo kernels against their plain versions: ``flash_attention``
within ``FLASH_TOL`` (relative, absolute) (float32 inputs: the sums in
another order; bfloat16 inputs: one bf16 rounding of the output, at most
2^-7 of its magnitude, plus the float32 sums' own error; bf16 at head
width 64 and 128 runs the tensor-core kernel, the rest the CUDA-core
one), ``ssd_chunk``
within ``SSD_TOL`` (float32, the sums in another order and the chunk
decay exp(cum_i - cum_j) of a cumsum that rounds differently; chunks of
64 or 128 at state width 64 or 128 and head width 64 or 128 run the
tensor-core kernel in three TF32 passes, about 2^-21 of each product, the
rest the CUDA-core one); two launches bit-identical.  The SSD backward
kernels within ``SSD_BWD_TOL`` of each output's own max |value| against
autograd through the plain version (float32, the sums in another order;
the group's heads summed in ascending order, on the tensor cores within
a slice and then over the slices), two launches bit-identical.
A 2-layer full-width model's card logits against
its CPU logits within ``MODEL_TOL`` (bf16 weights and activations: a few
bf16 rounding steps of logits of magnitude ~1).  The MoE layer on the
card against the CPU within ``MOE_TOL`` (relative, absolute), the CPU
tests' bf16 hidden-state tolerance: the experts' bf16 products rounded
after sums in another order; the routing equal, two calls bit-identical.
The int8 cache's ``_quant`` on the card bit-equal to the CPU's (one
multiply, one IEEE division, round half to even on both).  Training of
the moe, vlm, encdec and hybrid families on their reduced configs: two
runs from one seed bit-equal in every parameter and moment, a float32
step on the card within ``FAMILY_F32_TOL`` of the CPU's with the same
routing, and the MoE dispatch gather's backward bit-equal to the same
fold on the CPU.
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
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.flash_attention import ref as tflash_ref
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.kernels.ssd_scan import ref as tssd_ref

pytestmark = pytest.mark.cuda

NET_ULPS = 0
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}
SSD_TOL = 2e-5
SSD_BWD_TOL = 1e-4      # of each output's own max |value|
MODEL_TOL = 5e-2
MOE_TOL = (2.5e-2, 5e-2)

NAMES = ("new_rem", "fin", "tfin", "consumed", "inst_acc", "req_finish",
         "req_crit", "req_out")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def _pool_inputs(C, I, R, seed, dev, skew=None):
    """Pool-shaped inputs; ``skew`` puts 85 % of the lanes on that
    instance."""
    r = np.random.default_rng(seed)
    L = resolve_layout(SimParams())
    ints = np.zeros((C, len(L.i_fields)), np.int32)
    flts = np.zeros((C, len(L.f_fields)), np.float32)
    ints[:, L.i("status")] = r.choice([0, 1, 2], size=C, p=[.3, .2, .5])
    ints[:, L.i("inst")] = r.integers(-1, I + 2, size=C)   # some past I
    if skew is not None:
        ints[r.random(C) < 0.85, L.i("inst")] = skew
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


def _plain_on(device, cl, rate, time, dt, req, I):
    """The plain version on ``device``, on copies of the inputs."""
    L = cl.layout
    col = lambda n: (cl.ints[:, L.i(n)] if n in L.i_fields
                     else cl.flts[:, L.f(n)]).to(device)
    return tfinish.cloudlet_finish(
        col("status"), col("rem"), col("inst"), col("req"), col("arrival"),
        col("start"), col("depth"), rate.to(device), time.to(device), dt,
        *[x.to(device) for x in req], n_inst=I)


def _same(a, b):
    """Bit-equal, NaN where the other is NaN (its payload may differ)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0)
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# the tests' shapes, case1b, case2b (the multi-tile launch), a pool with
# most lanes on one instance at one tile and across tiles
FINISH_SHAPES = [(256, 8, 32, None), (1000, 33, 2000, None),
                 (8000, 1000, 100_000, None), (262_144, 50_000, 1072, None),
                 (8192, 12, 3000, 5), (40_000, 60, 3000, 9)]


@pytest.mark.parametrize("C,I,R,skew", FINISH_SHAPES)
@pytest.mark.parametrize("dt", [0.25, 0.1])
def test_cloudlet_finish_kernel_matches_plain(C, I, R, skew, dt, dev):
    cl, rate, req = _pool_inputs(C, I, R, C, dev, skew)
    time = torch.tensor(np.float32(12.5), device=dev)
    before = counts["cloudlet_finish"]
    got = cloudlet_finish_pool(cl, rate, time, dt,
                               *[x.clone() for x in req], n_inst=I)
    again = cloudlet_finish_pool(cl, rate, time, dt,
                                 *[x.clone() for x in req], n_inst=I)
    assert counts["cloudlet_finish"] == before + 2
    want = _plain_on("cpu", cl, rate, time, dt, req, I)
    torch.cuda.synchronize()
    for name, g, a, w in zip(NAMES, got, again, want):
        assert torch.equal(g, a), f"{name}: two launches differ"
        assert _same(g, w), name
    assert bool((got.inst_acc[:, 1] > 0).any())


@pytest.mark.parametrize("C,I,R,skew", FINISH_SHAPES[:4])
def test_unpooled_apis_match_plain(C, I, R, skew, dev):
    """The reference's unpooled APIs over ``[C]`` columns: each call one
    ``cloudlet_finish.cu`` launch, every output bit-equal to its plain
    version run on a CPU copy (``cloudlet_step``: inert request lanes,
    ``inst_acc[:n_inst, 0]`` kept)."""
    from repro_torch.kernels.cloudlet_step import (cloudlet_finish,
                                                   cloudlet_step)
    cl, rate, req = _pool_inputs(C, I, R, C + 1, dev, skew)
    L = cl.layout
    col = lambda n: (cl.ints[:, L.i(n)] if n in L.i_fields
                     else cl.flts[:, L.f(n)])
    names = ("status", "rem", "inst", "req", "arrival", "start", "depth")
    time = torch.tensor(np.float32(12.5), device=dev)
    before = counts["cloudlet_finish"]
    got = cloudlet_finish(*[col(n) for n in names], rate, time, 0.1,
                          *[x.clone() for x in req], n_inst=I)
    step = cloudlet_step(col("status"), col("rem"), col("inst"), rate, time,
                         0.1, I)
    assert counts["cloudlet_finish"] == before + 2
    want = _plain_on("cpu", cl, rate, time, 0.1, req, I)
    want_step = tfinish.cloudlet_step(col("status").cpu(), col("rem").cpu(),
                                      col("inst").cpu(), rate.cpu(),
                                      time.cpu(), 0.1, I)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, got, want):
        assert _same(g, w), name
    for name, g, w in zip(("new_rem", "fin", "tfin", "consumed", "used"),
                          step, want_step):
        assert _same(g, w), name


def test_shardability_report_on_card_is_the_cpus(dev):
    """The shardability audit of the golden combos on the card equals the
    CPU's, every op and site included: a kernel wrapper counts as its
    plain version's ops on both."""
    from repro_torch.analysis import shardability
    for net, fl in (("uniform", "none"), ("fabric", "chaos")):
        a = shardability.audit_combo(net, fl, device=dev)
        b = shardability.audit_combo(net, fl, device="cpu")
        assert a.to_json() == b.to_json()
        assert a.entries == b.entries


def test_cloudlet_finish_routes(dev):
    """One block up to 1,024 lanes, a cluster of up to 8 blocks up to
    16,384, a cooperative grid of 4,096-lane tiles above (while the card
    has an SM for each)."""
    from repro_torch.kernels.cloudlet_step import ops
    lib = ops._lib()
    assert ops.route(lib, 1000) == ("one block", 1)
    assert ops.route(lib, 8000) == ("cluster", 8)
    assert ops.route(lib, 8193) == ("cluster", 5)
    assert ops.route(lib, 262_144) == ("cooperative grid", 64)


def test_cloudlet_finish_signed_zeros_and_nan(dev):
    """Terms of -0.0 and 0 (rate -0.0 or 0, rem -0.0) and NaN (a NaN
    arrival or start on a finishing lane) in the instance sums: the
    kernel follows the CPU plain version, NaN for NaN."""
    C, I, R = 4096, 16, 500
    cl, rate, req = _pool_inputs(C, I, R, 21, dev)
    L = cl.layout
    u = torch.from_numpy(np.random.default_rng(22).random(C)).to(dev)
    # disjoint: min and max of zeros of both signs are the backends' own
    rate[u < 0.1] = -0.0
    rate[(u >= 0.1) & (u < 0.2)] = 0.0
    cl.flts[(u >= 0.2) & (u < 0.3), L.f("rem")] = -0.0
    cl.flts[(u >= 0.3) & (u < 0.32), L.f("arrival")] = float("nan")
    cl.flts[(u >= 0.32) & (u < 0.34), L.f("start")] = float("nan")
    time = torch.tensor(np.float32(12.5), device=dev)
    got = cloudlet_finish_pool(cl, rate, time, 0.1,
                               *[x.clone() for x in req], n_inst=I)
    want = _plain_on("cpu", cl, rate, time, 0.1, req, I)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, got, want):
        assert _same(g, w), name
    assert bool(torch.isnan(got.inst_acc).any())
    assert bool((~torch.isnan(got.inst_acc[:, 0])).any())


def test_cloudlet_finish_plain_cuda_branch_matches_cpu(dev):
    """The plain version's CUDA branch (not on the main path) sums in lane
    order too: bit-equal to its CPU branch."""
    for C, I, R, skew in FINISH_SHAPES[1:4] + FINISH_SHAPES[5:]:
        cl, rate, req = _pool_inputs(C, I, R, C, dev, skew)
        time = torch.tensor(np.float32(12.5), device=dev)
        got = _plain_on(dev, cl, rate, time, 0.1, req, I)
        want = _plain_on("cpu", cl, rate, time, 0.1, req, I)
        for name, g, w in zip(NAMES, got, want):
            assert _same(g, w), (C, name)


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


def _trop_rand(shape, r, dev, density=0.7):
    """Signed weights (no -0, so no tie between +0 and -0), -inf off the
    support."""
    return torch.from_numpy(np.where(
        r.random(shape) < density, r.normal(size=shape) * 3.0,
        -np.inf).astype(np.float32)).to(dev)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("B,M,K,N", [(4, 130, 70, 257), (60, 13, 13, 13),
                                     (2, 1, 1, 1), (1, 64, 0, 64),
                                     (70_000, 2, 3, 2),
                                     (2, 1024, 1024, 1024)])
def test_tropical_kernel_matches_plain(B, M, K, N, dev):
    r = np.random.default_rng(B + M + K + N)
    x, a = _trop_rand((B, M, K), r, dev), _trop_rand((B, K, N), r, dev)
    before = counts["tropical_matmul"]
    got = ttrop.tropical_matmul(x, a)
    assert counts["tropical_matmul"] == before + 1
    assert torch.equal(_bits(got), _bits(ttrop_ref.tropical_matmul(x, a)))
    s = _trop_rand((3, 24, 24), r, dev)
    want = torch.maximum(s, ttrop_ref.tropical_identity(24, device=dev))
    for _ in range(5):
        want = ttrop_ref.tropical_matmul(want, want)
    assert torch.equal(_bits(ttrop.tropical_closure(s)), _bits(want))


@pytest.mark.parametrize("depth", [None, 1, 3, 9])
@pytest.mark.parametrize("B,S", [(60, 13), (4, 128), (3, 129), (5, 1),
                                 (2, 127)])
def test_tropical_closure_kernel_matches_plain(B, S, depth, dev):
    """The closure on the card (one closure-kernel launch up to
    ``CLOSURE_MAX_S``, ⌈log₂ depth⌉ products above) against the plain
    squarings, bit for bit, on a DAG's delays and on a general matrix."""
    r = np.random.default_rng(B * S + (depth or 0))
    w = r.uniform(0.1, 2.0, size=(B, S, S))
    dag = np.where(np.triu(r.random((B, S, S)) < 0.3, k=1), w, -np.inf)
    for a in (torch.from_numpy(dag.astype(np.float32)).to(dev),
              _trop_rand((B, S, S), r, dev, density=0.3)):
        before = dict(counts)
        got = ttrop.tropical_closure(a, depth=depth)
        n = {k: counts[k] - before[k] for k in counts}
        if ttrop.closure_route(S) == ttrop.CLOSURE:
            assert n["tropical_closure"] == 1 and n["tropical_matmul"] == 0
        else:
            assert n["tropical_closure"] == 0
            assert n["tropical_matmul"] == ttrop.squarings(S, depth)
        want = ttrop_ref.tropical_closure(a, depth)
        assert torch.equal(_bits(got), _bits(want))


def test_tropical_kernels_keep_nan_and_inf(dev):
    """NaN and +inf entries: NaN where the plain version has NaN (the
    kernels' NaN is the canonical one), every other value equal."""
    r = np.random.default_rng(5)
    x, a = _trop_rand((3, 130, 70), r, dev), _trop_rand((3, 70, 257), r, dev)
    x[0, 5, 3] = float("nan")
    x[1, 7, :5] = float("inf")
    a[2, 9, 11] = float("inf")
    s = _trop_rand((4, 13, 13), r, dev, density=0.2)
    s[0, 2, 5] = float("nan")
    s[1, 4, 6] = float("inf")
    big = _trop_rand((2, 129, 129), r, dev, density=0.05)
    big[0, 3, 8] = float("nan")
    big[1, 10, 20] = float("inf")
    pairs = [(ttrop.tropical_matmul(x, a), ttrop_ref.tropical_matmul(x, a))]
    for m in (s, big):
        pairs.append((ttrop.tropical_closure(m, depth=2),
                      ttrop_ref.tropical_closure(m, 2)))
    for got, want in pairs:
        nan = torch.isnan(want)
        assert bool(nan.any()) and bool(torch.isposinf(want).any())
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got.masked_fill(nan, 0.0),
                           want.masked_fill(nan, 0.0))


def test_tropical_closure_limit_is_the_c_entry_points(dev):
    lib = ttrop._lib(dev)
    assert lib.tropical_closure_max_s() == ttrop.CLOSURE_MAX_S


def test_tropical_wrappers_check_their_inputs(dev):
    x = torch.zeros((2, 4, 4), device=dev)
    with pytest.raises(TypeError, match="float32"):
        ttrop.tropical_matmul(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ttrop.tropical_closure(x.transpose(1, 2))
    with pytest.raises(ValueError, match="chain"):
        ttrop.tropical_matmul(x, torch.zeros((2, 5, 4), device=dev))
    with pytest.raises(ValueError, match="n, n"):
        ttrop.tropical_closure(torch.zeros((2, 4, 5), device=dev))


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


# SockShop, case1b+net, case2b+net (a grid of 16 blocks), then ragged: a
# grid of 3 blocks, the last one short, C not a multiple of 1024, one
# host, fewer lanes than a warp
@pytest.mark.parametrize("C,H", [(8192, 10), (8000, 15), (262_144, 781),
                                 (40_000, 50), (3001, 37), (1000, 1),
                                 (5, 3)])
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


@pytest.mark.parametrize("C", [8000, 262_144])
def test_simulator_kernels_replay_in_a_cuda_graph(C, dev):
    """Both kernels of the tick captured in a CUDA graph (one block, and
    the cooperative grid at case2b's width), with a tropical product and
    a closure-kernel launch, and replayed: the eager launches' bits."""
    I, R, H = (1000, 100_000, 15) if C == 8000 else (50_000, 1072, 781)
    cl, rate, req = _pool_inputs(C, I, R, 1, dev)
    time = torch.tensor(np.float32(12.5), device=dev)
    links = _link_inputs(C, H, 2, dev)
    r = np.random.default_rng(C)
    prod = _trop_rand((2, 256, 256), r, dev)
    delays = _trop_rand((60, 13, 13), r, dev, density=0.3)
    work = [x.clone() for x in req]
    run = lambda: (cloudlet_finish_pool(cl, rate, time, 0.1, *work,
                                        n_inst=I),
                   link_share(*links, iters=2),
                   ttrop.tropical_matmul(prod, prod),
                   ttrop.tropical_closure(delays, depth=4))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                            # scratch and libraries first
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fin, rates, trop, closure = run()
    for t in (trop, closure):
        t.fill_(0.0)
    for w, x in zip(work, req):
        w.copy_(x)
    graph.replay()
    got = [x.clone() for x in fin] + [rates.clone(), trop.clone(),
                                       closure.clone()]
    for w, x in zip(work, req):
        w.copy_(x)
    want = run()
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES + ("rates", "tropical_matmul",
                                   "tropical_closure"),
                          got, [*want[0], *want[1:]]):
        assert torch.equal(g, w), name


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


# ---------------------------------------------------------------------------
# the compiled run: the tick and the decode step replayed as CUDA graphs
# ---------------------------------------------------------------------------

def _scaling(device):
    """SockShop, 60 clients over 6 s with HS scaling every 5 ticks and
    migration on (``test_torch_compiled``'s scaling app)."""
    import dataclasses
    from repro_torch.configs import sockshop
    sim = sockshop.make_sim(60, 6.0, scaling_policy=1, hs_util_hi=0.05,
                            hs_util_lo=0.04, share=300.0,
                            migration_enabled=True, spawn_rate=50.0,
                            device=device)
    sim.params = dataclasses.replace(sim.params, scale_interval=5)
    return sim


def _leaf_bits(tree) -> dict:
    """A state or trace as flat numpy arrays, floats as their bits."""
    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                v = np.asarray(v)
                yield pre + k, v.view(np.uint32) if v.dtype == np.float32 \
                    else v
    if hasattr(tree, "requests"):
        return dict(flat(convert.state_to_numpy(tree)))
    return dict(flat({k: v.cpu().numpy()
                      for k, v in tree._asdict().items()}))


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _chaos(device, network="uniform"):
    """The golden scenario's chaos combo (``test_layouts.matrix_sim``)."""
    net = (dict(network="fabric", nic_egress_mbps=50.0,
                nic_ingress_mbps=50.0) if network == "fabric"
           else dict(net_latency_s=0.05))
    caps = SimCaps(n_clients=16, max_requests=512, max_cloudlets=512,
                   max_instances=8, n_vms=4, d_max=2, max_replicas=2)
    params = SimParams(dt=0.05, n_ticks=300, n_clients=12, spawn_rate=5.0,
                       wait_lo=0.5, wait_hi=1.5, seed=3, faults="chaos",
                       host_mtbf_s=20.0, host_mttr_s=5.0,
                       retry_timeout_s=3.0, retry_budget=2,
                       inst_kill_rate=0.01, **net)
    return Simulation(diamond(mi=400.0), caps=caps, params=params,
                      default_template=InstanceTemplate(
                          mips=8000.0, limit_mips=16000.0, replicas=2),
                      vm_mips=np.full(4, 64000.0, np.float32),
                      device=device)


# MATRIX_GOLDEN's chaos fields (tests/test_layouts.py)
CHAOS_PINS = {"uniform": (54, 1002, 296, 1530248430121, 517, 388),
              "fabric": (78, 803, 626, 1477918938445, 80, 79)}


@pytest.mark.parametrize("network", ["uniform", "fabric"])
def test_chaos_golden_on_card_matches_cpu_and_pins(network, dev):
    reset_counts()
    gpu = _chaos(dev, network).run()
    assert counts["cloudlet_finish"] == 300
    assert counts["link_share"] == (300 if network == "fabric" else 0)
    cpu = _chaos("cpu", network).run()
    _assert_same(_leaf_bits(gpu.state), _leaf_bits(cpu.state))
    _assert_same(_leaf_bits(gpu.trace), _leaf_bits(cpu.trace))
    st = gpu.state
    resp = st.requests.response.cpu().numpy()
    got = (int(st.counters.completed), int(st.counters.spawned),
           int(st.counters.finished),
           int(resp.view(np.uint32).astype(np.uint64).sum()),
           int(st.fstats.failed_attempts), int(st.fstats.retries))
    assert got == CHAOS_PINS[network]


def test_link_share_with_dead_ports_and_cut_transfers(dev):
    """Chaos mode's inputs at case1b+net's shape: ports at capacity 0 (a
    brownout of severity 0) and transfers out of the water-fill (a zone
    cut), bit-equal to the plain version on the card and on the CPU."""
    src, dst, active, cap_e, cap_i = _link_inputs(8000, 15, 41, dev)
    cap_e[::4] = 0.0
    cap_i[1::5] = 0.0
    r = np.random.default_rng(3)
    active &= torch.from_numpy(r.random(8000) >= 0.2).to(dev)
    args = (src, dst, active, cap_e, cap_i)
    got = link_share(*args, iters=2)
    assert torch.equal(got, tlink.waterfill(*args, 2))
    assert torch.equal(got.cpu(), tlink.waterfill(*[a.cpu() for a in args],
                                                  2))
    into_dead = active & (dst >= 0) & (cap_i[dst.clamp_min(0)] == 0)
    assert bool((got[into_dead] == 0).all()) and bool((got > 0).any())


@pytest.mark.parametrize("which", ["golden", "fabric", "scaling", "chaos",
                                   "fabric_chaos"])
def test_captured_run_is_the_eager_run(which, dev):
    """``run()`` replays the tick's graphs (two where it scales): its
    final state and traces equal, bit for bit, the eager run's (a probe
    keeps the ticks eager); one launch of each kernel per tick; a second
    ``run()`` captures nothing and gives the same bits."""
    sim = {"golden": _golden, "fabric": _fabric, "scaling": _scaling,
           "chaos": _chaos,
           "fabric_chaos": lambda d: _chaos(d, "fabric")}[which](dev)
    Simulation.clear_captures()          # the cache is the class's
    n = sim.params.n_ticks
    reset_counts()
    res = sim.run()
    assert counts["cloudlet_finish"] == n
    if which == "fabric":
        assert counts["link_share"] == n
    assert res.compile_time_s > 0.0
    (graphs,) = sim._graphs.values()
    assert len(graphs.graphs) == (2 if which == "scaling" else 1)
    state, trace = sim.run_state(sim.init_state(), probe=lambda name: None)
    _assert_same(_leaf_bits(res.state), _leaf_bits(state))
    _assert_same(_leaf_bits(res.trace), _leaf_bits(trace))
    again = sim.run()
    assert again.compile_time_s == 0.0
    assert list(sim._graphs.values()) == [graphs]
    _assert_same(_leaf_bits(again.state), _leaf_bits(res.state))
    if which == "scaling":
        assert int(res.state.counters.scale_out) > 0


def _obs(device, network="uniform"):
    """The golden chaos combo with telemetry and burn-rate alerting on,
    every completion an SLO miss (alerts fire), latency ejection
    tightened while they do."""
    import dataclasses
    sim = _chaos(device, network)
    sim.params = dataclasses.replace(
        sim.params, telemetry="stream", tel_window_ticks=16,
        tel_windows=8, tel_span_k=4, tel_span_cap=256, alerting="burn",
        slo_budget=0.05, slo_ms=1.0, slo_short_wins=2, slo_long_wins=4,
        slo_for_ticks=2, eject_lat_factor=1.5, slo_eject_tighten=0.3)
    return Simulation(sim.graph, caps=sim.caps, params=sim.params,
                      default_template=InstanceTemplate(
                          mips=8000.0, limit_mips=16000.0, replicas=2),
                      vm_mips=np.full(4, 64000.0, np.float32),
                      device=device)


@pytest.mark.parametrize("network", ["uniform", "fabric"])
def test_captured_obs_run_is_the_eager_and_the_cpu_run(network, dev):
    """With telemetry and alerting on, ``run()`` replays the tick and
    flushes the metric ring between replays: its final state, traces and
    streamed metric and alert rows equal, bit for bit, the eager run's
    on the card and the run on the CPU; every window streams once."""
    from repro_torch.obs import export
    runs = []
    for device, probe in ((dev, None), (dev, lambda name: None),
                          ("cpu", None)):
        sim = _obs(device, network)
        with export.collecting() as rows, export.alert_collecting() as ev:
            if probe is None:
                res = sim.run()
                state, trace = res.state, res.trace
            else:
                state, trace = sim.run_state(sim.init_state(), probe=probe)
                sim.deliver_rows()
                from repro_torch.obs import slo, telemetry
                telemetry.drain_to_exporter(state, sim.params)
                slo.drain_to_exporter(state, sim.params, tags=[0.0])
        runs.append((_leaf_bits(state), _leaf_bits(trace),
                     sorted(tuple(r.values()) for r in rows.rows),
                     ev.rows))
    for other in runs[1:]:
        for a, b in zip(runs[0][:2], other[:2]):
            _assert_same(a, b)
        assert runs[0][2:] == other[2:]
    assert [r[0] for r in runs[0][2]] == list(range(300 // 16))
    assert runs[0][3]


def test_obs_replay_around_a_flush_makes_no_synchronising_call(dev):
    """Replayed ticks 60-69 (the ring flushes after tick 63) under sync
    debug mode "error": the flush's copy is asynchronous into pinned
    memory, its rows handed over once its event has completed."""
    from repro_torch.obs import export
    sim = _obs(dev)
    state, _ = sim.run_state(sim.init_state(), 60)
    torch.cuda.synchronize()
    with export.collecting() as rows:
        torch.cuda.set_sync_debug_mode("error")
        try:
            sim.run_state(state, 10, first_tick=60)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sim.deliver_rows()
    assert sorted(int(r["window"]) for r in rows.rows) == [0, 1, 2, 3]


def test_tick_capture_makes_no_synchronising_call(dev):
    """The warm-up, the capture and the replays under sync debug mode
    "error": no pageable copy, no pinned allocation in the tick, no
    read back."""
    sim = _fabric(dev)
    state = sim.init_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert sim.compile(state) > 0.0
        sim.run_state(state, 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# the batch axis: both simulator kernels over B points in one launch, and
# the batched tick replayed
# ---------------------------------------------------------------------------

def _stack_pools(pools):
    cl = Cloudlets(torch.stack([p[0].ints for p in pools]),
                   torch.stack([p[0].flts for p in pools]), pools[0][0].layout)
    rate = torch.stack([p[1] for p in pools])
    req = tuple(torch.stack([p[2][k] for p in pools]) for k in range(3))
    return cl, rate, req


# one block (B=3), a cluster (B=8, SockShop's shape), the cooperative grid
# with its blocks striding over 3 x 64 (point, tile) pairs
@pytest.mark.parametrize("B,C,I,R", [(3, 1000, 33, 2000),
                                     (8, 8192, 60, 3000),
                                     (3, 262_144, 50_000, 1072)])
def test_batched_cloudlet_finish_is_each_points_launch(B, C, I, R, dev):
    pools = [_pool_inputs(C, I, R, C + b, dev, skew=5 if b == 1 else None)
             for b in range(B)]
    cl, rate, req = _stack_pools(pools)
    time = torch.tensor([12.5 + b for b in range(B)], dtype=torch.float32,
                        device=dev)
    dt = torch.tensor([0.1, 0.25, 0.05, 0.1, 0.2, 0.1, 0.3, 0.1][:B],
                      dtype=torch.float32, device=dev)
    before = counts["cloudlet_finish"]
    got = cloudlet_finish_pool(cl, rate, time, dt, *[x.clone() for x in req],
                               n_inst=I)
    assert counts["cloudlet_finish"] == before + 1
    for b, (pcl, prate, preq) in enumerate(pools):
        one = cloudlet_finish_pool(pcl, prate, time[b], dt[b],
                                   *[x.clone() for x in preq], n_inst=I)
        plain = _plain_on("cpu", pcl, prate, time[b], float(dt[b]), preq, I)
        torch.cuda.synchronize()
        for name, g, o, w in zip(NAMES, got, one, plain):
            assert torch.equal(g[b], o), (b, name)
            assert _same(g[b], w), (b, name)


@pytest.mark.parametrize("B,C,H", [(8, 8192, 10), (2, 262_144, 781),
                                   (9, 262_144, 781), (5, 40_000, 50)])
def test_batched_link_share_is_each_points_launch(B, C, H, dev):
    """One launch for every point: a block a point, and the cooperative
    grid (case2b+net's 16 blocks a point: 2 points in one round, 9 in two
    rounds of at most 8 groups on 132 SMs; 5 points of 3 blocks)."""
    points = [_link_inputs(C, H, 7 * b + C, dev) for b in range(B)]
    args = [torch.stack([p[k] for p in points]) for k in range(5)]
    before = counts["link_share"]
    got = link_share(*args, iters=2)
    assert counts["link_share"] == before + 1
    for b, p in enumerate(points):
        one = link_share(*p, iters=2)
        want = tlink.waterfill(*[x.cpu() for x in p], 2)
        torch.cuda.synchronize()
        assert torch.equal(got[b], one), b
        assert torch.equal(got[b].cpu(), want), b


def _intervals_sweep(sim):
    """Points of ``sim`` whose scaling intervals differ (the per-point
    ``"mask"`` tick) and two that share it."""
    import dataclasses
    return [dataclasses.replace(sim.params, scale_interval=si,
                                hs_util_hi=th, n_clients=nc)
            for si, th, nc in [(5, 0.05, 60), (7, 0.04, 40), (5, 0.1, 50)]]


@pytest.mark.parametrize("which", ["fabric", "scaling"])
def test_batched_replay_is_the_eager_batch_and_each_solo_run(which, dev):
    """``run_batch`` replays one batched tick graph (the scaling SockShop
    with per-point intervals: the ordinary tick and the masked one): its
    bits are the eager batched tick's, one launch of each kernel per
    tick, and each point is that point's solo run on the card."""
    import dataclasses
    sim = {"fabric": _fabric, "scaling": _scaling}[which](dev)
    if which == "fabric":
        sweeps = [dataclasses.replace(sim.params, nic_egress_mbps=m,
                                      nic_ingress_mbps=m, n_clients=nc)
                  for m, nc in [(50.0, 12), (4.0, 16), (20.0, 8)]]
    else:
        sweeps = _intervals_sweep(sim)
    n = sim.params.n_ticks
    reset_counts()
    res = sim.run_batch(sweeps)
    assert counts["cloudlet_finish"] == n
    if which == "fabric":
        assert counts["link_share"] == n
    state, trace = sim.run_batch_state(sim.init_state(), sweeps,
                                       probe=lambda name: None)
    _assert_same(_leaf_bits(res.state), _leaf_bits(state))
    _assert_same(_leaf_bits(res.trace), _leaf_bits(trace))
    from repro_torch.core import batch_item
    base = sim.params
    for b, p in enumerate(sweeps):
        sim.params = p
        solo = sim.run()
        one = batch_item(res, b)
        _assert_same(_leaf_bits(one.state), _leaf_bits(solo.state))
        _assert_same(_leaf_bits(one.trace), _leaf_bits(solo.trace))
    sim.params = base
    if which == "scaling":
        assert int(res.state.counters.scale_out.sum()) > 0


def test_batched_capture_makes_no_synchronising_call(dev):
    """The batched tick's warm-up, capture (both variants of a per-point
    cadence) and replays under sync debug mode "error"."""
    sim = _scaling(dev)
    sweeps = _intervals_sweep(sim)
    state = sim.init_state()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sim.run_batch_state(state, sweeps, 20)
        sim.run_batch_state(state, sweeps, 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    graphs = Simulation._graphs[sim._capture_key(state, len(sweeps),
                                                 (False, "mask"))]
    assert sorted(map(str, graphs.graphs)) == ["False", "mask"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m",
                                  "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b",
                                  "qwen2-vl-7b"])
def test_decode_graph_is_the_eager_decode_step(arch, dev):
    """``serve.DecodeGraph`` at 2 layers of the architecture's full width:
    40 replayed steps give the eager ``decode_step``'s logits bit for bit,
    across a reset."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import DecodeGraph
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    graph = DecodeGraph(model, params, 4, 48, dev)
    assert graph.compile_time_s > 0.0
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 40))).to(dev)
    for wave in range(2):
        state = model.init_decode_state(4, 48, device=dev)
        graph.reset()
        for t in range(40 if wave == 0 else 5):
            want, state = model.decode_step(params, tok[:, t:t + 1], state)
            got = graph.step(tok[:, t:t + 1])
            assert torch.equal(got, want), (wave, t)
        assert int(graph.state.pos) == int(state.pos)


@pytest.mark.parametrize("arch,over", [
    ("whisper-base", {}),                            # encdec, cross K/V
    ("qwen3-0.6b", dict(kv_dtype="int8")),           # the int8 cache
    ("phi3-medium-14b", dict(kv_dtype="int8")),
], ids=["whisper-base", "qwen3-0.6b-int8", "phi3-medium-14b-int8"])
def test_decode_graph_variants_are_the_eager_decode_step(arch, over, dev):
    """``serve.DecodeGraph`` of whisper-base's decoder (from the same
    non-zero cross K/V in the graph's state and the eager one) and of the
    int8 KV cache, at 2 layers of full width: 20 replayed steps give the
    eager ``decode_step``'s logits and state bit for bit, across a reset
    that zeroes every leaf."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import DecodeGraph, _leaves
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), n_layers=2, **over)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    graph = DecodeGraph(model, params, 4, 32, dev)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 20))).to(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    for wave in range(2):
        state = model.init_decode_state(4, 32, device=dev)
        graph.reset()
        assert not any(bool(t.any()) for t in _leaves(graph.state))
        if cfg.family == "encdec":
            for name in ("k", "v"):
                x = torch.randn(state.cross_kv[name].shape, generator=g,
                                device=dev).to(torch.bfloat16)
                state.cross_kv[name].copy_(x)
                graph.state.cross_kv[name].copy_(x)
        for t in range(20 if wave == 0 else 5):
            want, state = model.decode_step(params, tok[:, t:t + 1], state)
            got = graph.step(tok[:, t:t + 1])
            assert torch.equal(got, want), (wave, t)
        for a, b in zip(_leaves(graph.state), _leaves(state)):
            assert torch.equal(a, b), wave


def test_quant_on_card_is_the_cpu_bits(dev):
    from repro_torch.models.attention import _quant
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 8, 33, 128)).astype(np.float32) * 3.0)
    x[0, 0, 0] = 0.0
    for src in (x, x.to(torch.bfloat16)):
        q_cpu, s_cpu = _quant(src)
        q, s = _quant(src.to(dev))
        assert torch.equal(q.cpu(), q_cpu)
        assert torch.equal(s.cpu().view(torch.int32),
                           s_cpu.view(torch.int32))


@pytest.mark.parametrize("n_tok", [4, 600], ids=["decode", "prefill"])
def test_moe_layer_on_card_matches_cpu_and_repeats(n_tok, dev):
    """``moe_apply`` at qwen3-moe-30b-a3b's routing (128 experts, top 8,
    capacity factor 1.25: 1 slot an expert at 4 tokens, most collisions
    dropped) on narrowed widths: the card's result within the bf16
    tolerance of the CPU's, the same routing, and two calls on the card
    bit-identical (the combine is a fold, no atomics)."""
    from repro_torch.models.common import initialize, tree_to
    from repro_torch.models.moe import (MoECfg, capacity, dispatch,
                                        moe_apply, moe_schema, route)
    cfg = MoECfg(n_experts=128, top_k=8, d_expert=128)
    d = 512
    params = initialize(moe_schema(d, cfg), torch.Generator().manual_seed(0),
                        "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, n_tok, d)).astype(np.float32)).to(torch.bfloat16)
    want = moe_apply(params, x, cfg)
    on_card = tree_to(params, dev)
    a = moe_apply(on_card, x.to(dev), cfg)
    b = moe_apply(on_card, x.to(dev), cfg)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    e_cpu = route(params, x.reshape(-1, d), cfg)[1]
    e_card = route(on_card, x.to(dev).reshape(-1, d), cfg)[1]
    assert torch.equal(e_card.cpu(), e_cpu)
    keep = dispatch(e_cpu, capacity(n_tok, cfg), cfg.n_experts)[1]
    assert not bool(keep.all())
    torch.testing.assert_close(a.cpu().float(), want.float(),
                               rtol=MOE_TOL[0], atol=MOE_TOL[1])


# ---------------------------------------------------------------------------
# model-zoo kernels
# ---------------------------------------------------------------------------

def _qkv(B, Hq, Hkv, Tq, Tk, D, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda H, T: torch.randn((B, H, T, D), generator=g,
                                  device=dev).to(dtype)
    return mk(Hq, Tq), mk(Hkv, Tk), mk(Hkv, Tk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", [
    (1, 16, 8, 1024, 1024, 128, True),     # qwen3-0.6b heads
    (2, 4, 4, 100, 100, 64, True),         # MHA, ragged
    (1, 8, 1, 77, 333, 32, True),          # MQA, Tq < Tk, ragged
    (1, 4, 2, 200, 70, 16, True),          # Tq > Tk: fully masked rows
    (2, 4, 2, 90, 150, 64, False),         # non-causal
    # the edges of the tensor-core kernel (bf16 at D 64 and 128)
    (1, 16, 2, 300, 300, 64, True),        # GQA group 8, ragged
    (1, 8, 4, 77, 333, 128, True),         # Tq < Tk (chunked prefill)
    (1, 4, 2, 200, 70, 128, True),         # Tq > Tk: fully masked rows
    (2, 8, 4, 333, 333, 128, True),        # B = 2, ragged
    (2, 8, 8, 257, 150, 128, False),       # non-causal, MHA
    (1, 8, 8, 129, 129, 128, True),        # one row past a query tile
    (1, 32, 4, 333, 333, 128, True),       # qwen3-moe heads: group 8
    (1, 48, 1, 257, 257, 128, True),       # granite-20b: MQA, group 48
    (1, 28, 4, 333, 333, 128, True),       # qwen2-vl heads: group 7
    (1, 8, 8, 1500, 1500, 64, False),      # whisper's encoder
    (1, 8, 8, 777, 1500, 64, False),       # whisper's cross, Tq < Tk
    (1, 8, 8, 2000, 1500, 64, False),      # cross, Tq > Tk, not causal
])
def test_flash_attention_kernel_matches_plain(B, Hq, Hkv, Tq, Tk, D, causal,
                                              dtype, dev):
    q, k, v = _qkv(B, Hq, Hkv, Tq, Tk, D, dtype, dev)
    before = counts["flash_attention"]
    a = tflash.attention(q, k, v, causal=causal)
    b = tflash.attention(q, k, v, causal=causal)
    assert counts["flash_attention"] == before + 2
    p = tflash_ref.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert a.dtype == dtype and torch.equal(a, b)
    assert bool(torch.isfinite(a).all())
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(a.float(), p.float(), rtol=rtol, atol=atol)
    if causal and Tq > Tk:
        dead = v.float().sum(2)[:, :, None] / (-(-Tk // 128) * 128)
        dead = dead.repeat_interleave(Hq // Hkv, dim=1)
        torch.testing.assert_close(a[:, :, :Tq - Tk].float(),
                                   dead.expand(-1, -1, Tq - Tk, -1),
                                   rtol=rtol, atol=atol)


def test_flash_attention_takes_unaligned_inputs(dev):
    """TMA reads from 16-byte aligned addresses: the wrapper copies a
    contiguous view that starts off them."""
    q, k, v = _qkv(1, 8, 4, 200, 200, 128, torch.bfloat16, dev)
    want = tflash.attention(q, k, v)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(tflash.attention(shifted, k, v), want)


def test_flash_attention_wrapper_checks_its_inputs(dev):
    q, k, v = _qkv(1, 4, 2, 64, 64, 64, torch.float32, dev)
    with pytest.raises(TypeError):
        tflash.attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        tflash.attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        tflash.attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                         v[..., :48].contiguous())
    with pytest.raises(ValueError, match="heads"):
        q3, _, _ = _qkv(1, 3, 2, 64, 64, 64, torch.float32, dev)
        tflash.attention(q3, k, v)


def _ssd_inputs(M, K, L, P, N, group, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    dt = r(M, K, L, 1) * 0.25 + 0.05
    la = dt * -(r(M, 1, 1, 1) * 1.5 + 0.5)
    return (n(M, K, L, P), dt, la, n(M // group, K, L, N) / N ** 0.5,
            n(M // group, K, L, N) / N ** 0.5)


@pytest.mark.parametrize("M,K,L,P,N,group", [
    (24, 8, 128, 64, 128, 24),             # mamba2-130m, one group
    (6, 3, 16, 8, 16, 3),                  # small chunks, G = 2
    (4, 5, 100, 32, 64, 1),                # ragged chunk, per-head B/C
    (48, 8, 128, 64, 128, 24),             # tensor cores, two B/C groups
    (24, 4, 64, 64, 128, 24),              # tensor cores, L = 64
    (8, 3, 128, 64, 64, 4),                # tensor cores, N = 64
    (24, 256, 128, 64, 128, 24),           # mamba2-130m's prefill_32k
    (128, 8, 128, 128, 128, 128),          # tensor cores, jamba's P = 128
    (8, 3, 64, 128, 64, 4),                # tensor cores, P = 128 at 64
])
def test_ssd_chunk_kernel_matches_plain(M, K, L, P, N, group, dev):
    args = _ssd_inputs(M, K, L, P, N, group, dev)
    before = counts["ssd_chunk"]
    a = tssd.ssd_chunk(*args, group=group)
    b = tssd.ssd_chunk(*args, group=group)
    assert counts["ssd_chunk"] == before + 2
    p = tssd_ref.ssd_chunk(*args, group=group)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, p):
        assert torch.equal(x, y) and x.shape == z.shape
        torch.testing.assert_close(x, z, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_layer_on_card_matches_cpu(dev):
    """The whole SSD layer (pad, kernel, carry) on the card against the
    CPU path, ragged T and two groups."""
    g = np.random.default_rng(0)
    B, T, H, P, G, N = 2, 300, 4, 16, 2, 32
    x = g.normal(size=(B, T, H, P)).astype(np.float32)
    dt = g.uniform(0.05, 0.3, size=(B, T, H)).astype(np.float32)
    A = -g.uniform(0.5, 2.0, size=(H,)).astype(np.float32)
    Bm = (g.normal(size=(B, T, G, N)) / np.sqrt(N)).astype(np.float32)
    Cm = (g.normal(size=(B, T, G, N)) / np.sqrt(N)).astype(np.float32)
    D = g.normal(size=(H,)).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)]
    want = tssd.ssd(*cpu, chunk=128)
    got = tssd.ssd(*[a.to(dev) for a in cpu], chunk=128)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


def test_ssd_chunk_wrapper_checks_its_inputs(dev):
    x, dt, la, b, c = _ssd_inputs(4, 2, 16, 8, 16, 2, dev)
    with pytest.raises(TypeError):
        tssd.ssd_chunk(x.double(), dt, la, b, c, group=2)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_chunk(x.transpose(0, 1).contiguous().transpose(0, 1), dt,
                       la, b, c, group=2)
    with pytest.raises(ValueError, match="shape"):
        tssd.ssd_chunk(x, dt, la, b, c, group=1)
    with pytest.raises(ValueError):
        tssd.ssd_chunk(x, dt.cpu(), la, b, c, group=2)
    with pytest.raises(ValueError, match="chunks"):
        big = _ssd_inputs(1, 1, 256, 8, 8, 1, dev)
        tssd.ssd_chunk(*big)
    # N = 256 is no tensor-core shape, and the CUDA-core kernel would
    # hold it in more shared memory than a block has
    assert tssd.route(128, 256, 64) == tssd.CUDA_CORES
    with pytest.raises(ValueError, match="shared memory"):
        tssd.ssd_chunk(*_ssd_inputs(1, 1, 128, 64, 256, 1, dev))
    # the tensor-core kernel's TMA loads need 16-byte aligned rows
    x, dt, la, b, c = _ssd_inputs(2, 1, 64, 64, 64, 2, dev)
    off = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    off.copy_(x)
    with pytest.raises(RuntimeError, match="launch failed"):
        tssd.ssd_chunk(off, dt, la, b, c, group=2)


def test_ssd_route_is_the_c_entry_points_rule(dev):
    """``ops.route`` states the rule by which ``ssd_chunk_launch`` picks
    its kernel; the library's own ``ssd_chunk_route`` must agree."""
    lib = tssd._lib()
    for L in (16, 32, 64, 100, 128):
        for N in (16, 32, 64, 128, 256):
            for P in (16, 32, 64, 128):
                assert lib.ssd_chunk_route(L, N, P) == tssd.route(L, N, P)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_two_layer_full_width_model_on_card_matches_cpu(arch, dev):
    """prefill_step of a 2-layer model at the architecture's full width:
    the card (through both kernels) against the CPU path, same weights."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_to
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 300)))
    want = prefill_step(model, params, {"tokens": tok})
    on_card = tree_to(params, dev)
    name = "ssd_chunk" if cfg.family == "ssm" else "flash_attention"
    before = counts[name]
    got = prefill_step(model, on_card, {"tokens": tok.to(dev)})
    assert counts[name] == before + 2
    torch.testing.assert_close(got.cpu(), want, rtol=MODEL_TOL,
                               atol=MODEL_TOL)


# ---------------------------------------------------------------------------
# simcheck on the card: the shared capture cache, the sentinel, checked mode
# ---------------------------------------------------------------------------

def test_capture_cache_is_shared_and_replays_each_instance(dev):
    """Two ``Simulation``s of one structure that differ in every swept
    value and in the application's values: the second replays the first's
    capture (no capture time), and its run equals its own eager run."""
    import dataclasses
    from repro_torch.analysis.layout_check import _tiny_sim
    from repro_torch.core.types import DynParams
    Simulation.clear_captures()
    a = _tiny_sim("fabric", "chaos", False, device=dev)
    a.params = dataclasses.replace(a.params, n_ticks=120)
    a = Simulation(a.graph, caps=a.caps, params=a.params, device=dev)
    first = a.run()
    assert first.compile_time_s > 0.0
    floats = {f: getattr(a.params, f) * 1.25 + 0.01
              for f in DynParams._fields if f not in ("hs_mode", "tel_tag")
              and hasattr(a.params, f)
              and isinstance(getattr(a.params, f), float)}
    floats.update(n_clients=a.params.n_clients + 1,
                  num_limit=a.params.num_limit - 1,
                  retry_budget=a.params.retry_budget + 1,
                  net_latency_s=a.params.net_latency_s * 1.25 + 0.01,
                  scale_interval=a.params.scale_interval + 1)
    pb = dataclasses.replace(a.params, **floats)
    b = Simulation(diamond(mi=350.0), caps=a.caps, params=pb, device=dev)
    assert b._capture_key(b.init_state(), 1, (False, True)) == \
        a._capture_key(a.init_state(), 1, (False, True))
    res = b.run()
    assert res.compile_time_s == 0.0 and len(Simulation._graphs) == 1
    assert int(res.state.counters.finished) > 0
    assert not torch.equal(res.state.requests.arrival,
                           first.state.requests.arrival)
    state, trace = b.run_state(b.init_state(), probe=lambda name: None)
    _assert_same(_leaf_bits(res.state), _leaf_bits(state))
    _assert_same(_leaf_bits(res.trace), _leaf_bits(trace))


def test_sentinel_counting_pass_captures_nothing(dev):
    from repro_torch.analysis import recompile
    Simulation.clear_captures()
    rep = recompile.run_sentinel(n_points=2, device=dev)
    assert rep.warm.captures == 8
    assert rep.counting.captures == 0 and rep.counting.builds == 0
    assert rep.problems == []


def test_checked_replayed_run_raises_after_the_loop(dev, monkeypatch):
    """Under ``REPRO_CHECKED=1`` a forged spawn wave (every lane live on
    slot 0) replays without a synchronising call and raises when the run
    reads its error word, once, after the loop."""
    from repro_torch.analysis import annotate, op_lint
    from repro_torch.core import scheduler
    monkeypatch.setenv("REPRO_CHECKED", "1")
    assign = scheduler.assign_free_slots
    monkeypatch.setattr(scheduler, "assign_free_slots", lambda *a, **k: (
        lambda asg: asg._replace(dst=torch.zeros_like(asg.dst),
                                 live=torch.ones_like(asg.live)))(
            assign(*a, **k)))
    sim = _golden(dev)
    state = sim.init_state()
    sim.compile(state)
    torch.cuda.synchronize()

    def replay():
        with pytest.raises(annotate.CheckError,
                           match="duplicate destination slot"):
            sim.run_state(state, 10)

    n, sites = op_lint.sync_sites(replay)
    assert n == 1 and all("annotate.py" in k for k in sites), sites


def test_simcheck_sections_clean_on_card(dev):
    from repro_torch.analysis.simcheck import run_simcheck
    rep = run_simcheck(only={"lint", "layout", "streams"}, device=dev)
    assert rep.ok, rep.problems


# ---------------------------------------------------------------------------
# training on the card: the flash backward kernel, the log-sum-exp output,
# the train step
# ---------------------------------------------------------------------------

# the backward kernel against autograd through the plain version
# (relative, absolute as a fraction of the output's max magnitude): float32
# sums in another order; bfloat16: the outputs' own bf16 rounding (2^-8),
# and Δ = Σ dO·O taken from the forward's bf16 output, whose rounding
# reaches dS where dP - Δ cancels
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -6,
                                                          2.0 ** -7)}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


def _bwd_close(got, want, dtype):
    rtol, afrac = BWD_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        atol = afrac * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", [
    (1, 16, 8, 512, 512, 128, True),       # qwen3-0.6b heads (group 2)
    (2, 4, 2, 256, 256, 64, True),         # the presets' heads
    (2, 4, 4, 100, 100, 64, True),         # MHA, ragged
    (1, 8, 1, 77, 333, 32, True),          # MQA, Tq < Tk, ragged
    (1, 4, 2, 200, 70, 16, False),         # non-causal, Tq > Tk
    (2, 4, 2, 90, 150, 64, False),         # non-causal
    (1, 14, 2, 129, 129, 128, True),       # group 7, one row past a tile
    # bf16 below: the tensor-core kernels' edges (f32: the CUDA cores')
    (2, 2, 2, 384, 384, 128, True),        # MHA, T a multiple of 128
    (1, 4, 2, 1000, 1000, 128, True),      # ragged 1000
    (1, 4, 2, 1000, 1000, 64, True),
    (1, 7, 1, 129, 129, 64, True),         # group 7, one row past a tile
    (1, 16, 1, 256, 256, 128, True),       # MQA 16/1
    (1, 16, 1, 200, 200, 64, True),
    (1, 4, 2, 300, 700, 128, True),        # causal Tq < Tk
    (1, 4, 1, 77, 333, 64, True),
    (1, 4, 4, 600, 1500, 64, False),       # non-causal Tq < Tk
    (1, 4, 2, 1500, 600, 64, False),       # non-causal Tq > Tk
    (1, 4, 2, 300, 129, 128, False),
])
def test_flash_bwd_kernel_matches_plain(B, Hq, Hkv, Tq, Tk, D, causal,
                                        dtype, dev):
    """Each route's kernels (``ops.route_bwd``) against autograd through
    the plain version, two calls bit-equal."""
    q, k, v = _qkv(B, Hq, Hkv, Tq, Tk, D, dtype, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    out, lse = tflash.launch(q, k, v, causal, None, with_lse=True)
    before = counts["flash_attention_bwd"]
    a = tflash.launch_bwd(q, k, v, out, dout, lse, causal, None)
    b = tflash.launch_bwd(q, k, v, out, dout, lse, causal, None)
    assert counts["flash_attention_bwd"] == before + 2 * tflash.BWD_LAUNCHES
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = tflash_ref.attention_bwd(q, k, v, dout, causal=causal)
    torch.cuda.synchronize()
    _bwd_close(a, want, dtype)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_unaligned_views_give_the_aligned_bits(D, dev):
    """The tensor-core backward reads by TMA from 16-byte aligned addresses:
    views one element off (``launch_bwd`` copies them) give the aligned
    inputs' bits."""
    assert tflash.route_bwd(torch.bfloat16, D) == tflash.TENSOR_CORES
    q, k, v = _qkv(1, 4, 2, 200, 200, D, torch.bfloat16, dev)
    g = torch.Generator(device=dev).manual_seed(9)
    dout = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
    out, lse = tflash.launch(q, k, v, True, None, with_lse=True)
    want = tflash.launch_bwd(q, k, v, out, dout, lse, True, None)

    def off_by_one(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view
    got = tflash.launch_bwd(*(off_by_one(t) for t in (q, k, v, out, dout)),
                            lse, True, None)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", [
    (1, 16, 8, 300, 300, 128, True),       # flash_fwd_sm90 in bf16
    (2, 4, 2, 100, 100, 64, True),
    (1, 8, 1, 77, 333, 32, True),          # flash_fwd, Tq < Tk
    (2, 4, 2, 90, 150, 16, False),
])
def test_flash_lse_matches_plain(B, Hq, Hkv, Tq, Tk, D, causal, dtype, dev):
    """The forward kernels' log-sum-exp output; the output itself is the
    launch without it, bit for bit."""
    q, k, v = _qkv(B, Hq, Hkv, Tq, Tk, D, dtype, dev)
    out, lse = tflash.launch(q, k, v, causal, None, with_lse=True)
    assert torch.equal(out, tflash.launch(q, k, v, causal, None))
    want = tflash_ref.logsumexp(q, k, causal=causal)
    torch.testing.assert_close(lse, want, rtol=LSE_TOL[dtype],
                               atol=LSE_TOL[dtype])


def test_flash_autograd_runs_the_kernels(dev):
    """``attention`` under grad: one forward launch with the log-sum-exp,
    the backward kernels in backward, the same gradients as
    ``launch_bwd``; without grad the serving launch alone."""
    q, k, v = _qkv(2, 4, 2, 200, 200, 64, torch.bfloat16, dev)
    assert tflash.route_bwd(q.dtype, 64) == tflash.TENSOR_CORES
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    before = dict(counts)
    out = tflash.attention(qs, ks, vs)
    dout = torch.randn_like(out)
    out.backward(dout)
    assert counts["flash_attention"] == before["flash_attention"] + 1
    assert counts["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + tflash.BWD_LAUNCHES
    o, lse = tflash.launch(q, k, v, True, None, with_lse=True)
    want = tflash.launch_bwd(q, k, v, o, dout, lse, True, None)
    for g, w in zip((qs.grad, ks.grad, vs.grad), want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        tflash.attention(qs[:, :, :100], ks[:, :, :50], vs[:, :, :50])


def test_ssd_chunk_raises_under_grad(dev):
    """Under grad the forward refuses, before launching, a shape the
    backward kernels do not take (a ragged chunk at head width 128);
    without grad the same shape runs the forward kernel."""
    x, dt, la, b, c = _ssd_inputs(4, 2, 100, 128, 128, 4, dev)
    before = dict(counts)
    with pytest.raises(ValueError, match="backward"):
        tssd.ssd_chunk(x.requires_grad_(True), dt, la, b, c, group=4)
    assert counts == before
    with torch.no_grad():
        tssd.ssd_chunk(x, dt, la, b, c, group=4)
    assert counts["ssd_chunk"] == before["ssd_chunk"] + 1


def _ssd_grads(M, K, L, P, N, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    return n(M, K, L, P), n(M, K, N, P), n(M, K, L, 1), n(M, K, 1, 1)


@pytest.mark.parametrize("M,K,L,P,N,group", [
    (192, 32, 128, 64, 128, 24),     # mamba2-130m train_4k, B 8
    (16, 4, 128, 64, 128, 4),        # four B/C rows of 4 heads
    (128, 8, 128, 128, 128, 128),    # jamba's widths, P = 128: 4 slices
    (24, 4, 64, 64, 64, 24),         # L = N = 64
    (48, 8, 64, 64, 64, 24),         # several slices of a B/C row
    (6, 3, 16, 16, 16, 3),           # the reduced configs' chunk
    (4, 2, 100, 32, 64, 1),          # a ragged chunk, per-head B/C
])
def test_ssd_chunk_bwd_kernel_matches_plain(M, K, L, P, N, group, dev):
    """Each output within ``SSD_BWD_TOL`` of its own max |value| against
    autograd through the plain version; two launches bit-identical; the
    tensor-core shapes at one slice of a B/C row's heads a block or at
    several (``heads_per_block``)."""
    args = _ssd_inputs(M, K, L, P, N, group, dev)
    grads = _ssd_grads(M, K, L, P, N, dev)
    if (L, N, P) == (64, 64, 64) and M == 48:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert tssd.heads_per_block(K, M // group, group, sms) < group
    before = counts["ssd_chunk_bwd"]
    a = tssd.launch_bwd(*args, *grads, group)
    b = tssd.launch_bwd(*args, *grads, group)
    assert counts["ssd_chunk_bwd"] == before + 2 * tssd.bwd_launches(L, N,
                                                                      P)
    p = tssd_ref.ssd_chunk_bwd(*args, *grads, group=group)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, p):
        assert torch.equal(x, y) and x.shape == z.shape
        tol = SSD_BWD_TOL * float(z.abs().max())
        torch.testing.assert_close(x, z, rtol=0, atol=tol)


def test_ssd_chunk_bwd_wrapper_checks_its_inputs(dev):
    args = _ssd_inputs(4, 2, 16, 8, 16, 2, dev)
    grads = _ssd_grads(4, 2, 16, 8, 16, dev)
    with pytest.raises(TypeError):
        tssd.launch_bwd(args[0].double(), *args[1:], *grads, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.launch_bwd(*args, grads[0].transpose(0, 1).contiguous()
                        .transpose(0, 1), *grads[1:], 2)
    with pytest.raises(ValueError, match="shape"):
        tssd.launch_bwd(*args, *grads[:3], grads[3][:, :1], 2)
    with pytest.raises(ValueError):
        tssd.launch_bwd(*args, grads[0].cpu(), *grads[1:], 2)
    with pytest.raises(ValueError, match="groups"):
        tssd.launch_bwd(*args, *grads, 3)
    # head width 128 launches at a tensor-core shape, 256 raises, as 128
    # does at a chunk the tensor cores do not take
    wide = _ssd_inputs(2, 1, 64, 128, 64, 1, dev)
    tssd.launch_bwd(*wide, *_ssd_grads(2, 1, 64, 128, 64, dev), 1)
    for L, P in ((64, 256), (16, 128)):
        big = _ssd_inputs(2, 1, L, P, 64, 1, dev)
        with pytest.raises(ValueError, match="head widths"):
            tssd.launch_bwd(*big, *_ssd_grads(2, 1, L, P, 64, dev), 1)
    # every shape ``route_bwd`` takes fits a block's shared memory, as the
    # C library counts it, and the library's route agrees; a state past
    # its limit would not fit
    lib = tssd._lib_bwd()
    for L, N, P in ((128, 128, 64), (128, 128, 128), (64, 64, 64),
                    (128, 64, 128), (64, 128, 128), (16, 16, 16),
                    (100, 64, 32), (16, 128, 64), (128, 128, 32),
                    (tssd.BWD_MAX_L, tssd.BWD_MAX_N, tssd.BWD_MAX_P)):
        kind = tssd.route_bwd(L, N, P)
        assert lib.ssd_chunk_bwd_route(L, N, P) == (
            1 if kind == tssd.TENSOR_CORES else 0)
        assert lib.ssd_chunk_bwd_smem_bytes(L, N, P) <= tssd._SMEM_BYTES
    assert lib.ssd_chunk_bwd_smem_bytes(128, 256, 64) > tssd._SMEM_BYTES
    with pytest.raises(ValueError, match="state widths"):
        tssd.launch_bwd(*_ssd_inputs(2, 1, 16, 16, 256, 1, dev),
                        *_ssd_grads(2, 1, 16, 16, 256, dev), 1)


def test_ssd_autograd_runs_the_kernels(dev):
    """``ssd_chunk`` under grad: one forward launch, the backward kernels
    in backward, the gradients ``launch_bwd`` gives; the whole layer's
    gradients on the card against the CPU's."""
    args = _ssd_inputs(8, 4, 64, 32, 64, 4, dev)
    grads = _ssd_grads(8, 4, 64, 32, 64, dev)
    ins = [t.clone().requires_grad_(True) for t in args]
    before = dict(counts)
    outs = tssd.ssd_chunk(*ins, group=4)
    torch.autograd.backward(outs, grads)
    assert counts["ssd_chunk"] == before["ssd_chunk"] + 1
    assert counts["ssd_chunk_bwd"] == \
        before["ssd_chunk_bwd"] + tssd.bwd_launches(64, 64, 32)
    want = tssd.launch_bwd(*args, *grads, 4)
    for t, w in zip(ins, want):
        assert torch.equal(t.grad, w)
    g = np.random.default_rng(0)
    B, T, H, P, G, N = 2, 300, 4, 16, 2, 32
    cpu = [torch.from_numpy(a) for a in (
        g.normal(size=(B, T, H, P)).astype(np.float32),
        g.uniform(0.05, 0.3, size=(B, T, H)).astype(np.float32),
        -g.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
        (g.normal(size=(B, T, G, N)) / np.sqrt(N)).astype(np.float32),
        (g.normal(size=(B, T, G, N)) / np.sqrt(N)).astype(np.float32),
        g.normal(size=(H,)).astype(np.float32))]
    gy = torch.from_numpy(g.normal(size=(B, T, H, P)).astype(np.float32))
    res = []
    for d in ("cpu", dev):
        ins = [a.to(d).requires_grad_(True) for a in cpu]
        res.append(torch.autograd.grad(tssd.ssd(*ins, chunk=128), ins,
                                       gy.to(d)))
    for a, b in zip(*res):
        torch.testing.assert_close(b.cpu(), a, rtol=0,
                                   atol=SSD_BWD_TOL * float(a.abs().max()))


def test_ssd_chunk_p128_forward_matches_plain(dev):
    """Head width 128 on both kernels: jamba-1.5-large's Mamba widths (L =
    N = P = 128) on the tensor-core kernel, in two passes of 64 columns,
    and a ragged chunk on the CUDA-core kernel, X staged 64 columns at a
    time."""
    for L, want in ((128, tssd.TENSOR_CORES), (100, tssd.CUDA_CORES)):
        assert tssd.route(L, 128, 128) == want
        args = _ssd_inputs(16, 8, L, 128, 128, 16, dev)
        a = tssd.ssd_chunk(*args, group=16)
        b = tssd.ssd_chunk(*args, group=16)
        p = tssd_ref.ssd_chunk(*args, group=16)
        torch.cuda.synchronize()
        for x, y, z in zip(a, b, p):
            assert torch.equal(x, y)
            torch.testing.assert_close(x, z, rtol=SSD_TOL, atol=SSD_TOL)


def _mamba_run(dev, steps=3, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import AdamWCfg, adamw_init, make_train_step
    cfg = get_config("mamba2-130m").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               dev)
    opt = adamw_init(params)
    step = make_train_step(model, AdamWCfg(lr=1e-3, warmup_steps=2,
                                           total_steps=10))
    data = SyntheticLM(cfg.vocab, 64, 2)
    losses = []
    for s in range(steps):
        params, opt, m = step(params, opt, data.batch(s, device=dev))
        losses.append(m["loss"])
    return params, opt, losses


def test_mamba_train_step_on_card_repeats_bit_for_bit(dev):
    """Two runs of the reduced mamba2-130m from the same seed: every
    parameter and moment bit-equal (no atomics in either SSD kernel),
    both SSD kernels on the path."""
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_leaves
    red = get_config("mamba2-130m").reduced()
    before = dict(counts)
    pa, oa, la = _mamba_run(dev)
    n_layers = 2
    assert counts["ssd_chunk"] - before["ssd_chunk"] == 3 * 2 * n_layers
    assert counts["ssd_chunk_bwd"] - before["ssd_chunk_bwd"] \
        == 3 * n_layers * tssd.bwd_launches(red.ssd_chunk, red.mamba.d_state,
                                            red.mamba.headdim)
    pb, ob, lb = _mamba_run(dev)
    for x, y in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        assert torch.equal(x, y)
    assert all(bool(torch.isfinite(x)) for x in la)


def _tiny_run(dev, steps=3, seed=0):
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.serve import PRESETS
    from repro_torch.models import build_model
    from repro_torch.train import AdamWCfg, adamw_init, make_train_step
    cfg = PRESETS["tiny"]
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed),
                               dev)
    opt = adamw_init(params)
    step = make_train_step(model, AdamWCfg(lr=1e-3, warmup_steps=2,
                                           total_steps=10))
    data = SyntheticLM(cfg.vocab, 64, 2)
    losses = []
    for s in range(steps):
        params, opt, m = step(params, opt, data.batch(s, device=dev))
        losses.append(m["loss"])
    return params, opt, losses


def test_train_step_on_card_repeats_bit_for_bit(dev):
    """Two runs of the tiny preset from the same seed: every parameter
    and moment bit-equal (no atomics on the path), the flash kernels in
    both directions on it."""
    from repro_torch.launch.serve import PRESETS
    from repro_torch.tree import tree_leaves
    # bf16 at head width 64: the tensor-core backward
    assert tflash.route_bwd(torch.bfloat16, PRESETS["tiny"].head_dim) == \
        tflash.TENSOR_CORES
    before = dict(counts)
    pa, oa, la = _tiny_run(dev)
    n_layers = 4
    assert counts["flash_attention"] - before["flash_attention"] == \
        3 * 2 * n_layers                       # forward + remat recompute
    assert counts["flash_attention_bwd"] - before["flash_attention_bwd"] \
        == 3 * n_layers * tflash.BWD_LAUNCHES
    pb, ob, lb = _tiny_run(dev)
    for x, y in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        assert torch.equal(x, y)
    assert all(bool(torch.isfinite(x)) for x in la)


# ---------------------------------------------------------------------------
# training of the moe, vlm, encdec and hybrid families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["qwen2-moe-a2.7b", "qwen2-vl-7b", "whisper-base",
                "jamba-1.5-large-398b"]
# float32 train step, card against CPU: the loss within 1e-5 and each
# gradient leaf within 1e-4 of its own max |grad| (the CUDA-core flash
# and SSD kernels and cuBLAS sum in another order than the CPU)
FAMILY_F32_TOL = (1e-5, 1e-4)


def _family_batch(cfg, step, dev, T=32, B=2):
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data import batch_for
    return batch_for(cfg, ShapeCfg("t", T, B, "train"), step, device=dev)


def _family_kernels(cfg):
    """A step's flash and SSD launches: each attention layer's forward
    twice (remat) and its backward, each Mamba layer's likewise."""
    L = cfg.n_layers
    n_attn = (L // cfg.attn_period if cfg.family == "hybrid"
              else cfg.n_enc_layers + 2 * L if cfg.family == "encdec"
              else L)
    want = {"flash_attention": 2 * n_attn,
            "flash_attention_bwd": n_attn * tflash.BWD_LAUNCHES}
    if cfg.family == "hybrid":
        n_ssd = L - n_attn
        want.update(ssd_chunk=2 * n_ssd, ssd_chunk_bwd=n_ssd * (
            tssd.bwd_launches(cfg.ssd_chunk, cfg.mamba.d_state,
                              cfg.mamba.headdim)))
    return want


def _family_run(arch, dev, steps=3):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamWCfg, adamw_init, make_train_step
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    opt = adamw_init(params)
    step = make_train_step(model, AdamWCfg(lr=1e-3, warmup_steps=2,
                                           total_steps=10), donate=True)
    losses = []
    for s in range(steps):
        params, opt, m = step(params, opt, _family_batch(cfg, s, dev))
        losses.append(m["loss"])
    return cfg, params, opt, losses


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_on_card_repeats_bit_for_bit(arch, dev):
    """Two runs of the reduced config from the same seed on
    ``data.batch_for``'s batches: every parameter and moment bit-equal
    (the MoE backward folds each token's slots in expert order; no
    atomics in the flash and SSD backwards), the mixers' kernels on the
    path each step."""
    from repro_torch.tree import tree_leaves
    before = dict(counts)
    cfg, pa, oa, la = _family_run(arch, dev)
    want = _family_kernels(cfg)
    assert {k: counts[k] - before[k] for k in want} == \
        {k: 3 * v for k, v in want.items()}
    _, pb, ob, lb = _family_run(arch, dev)
    for x, y in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        assert torch.equal(x, y)
    assert all(bool(torch.isfinite(x)) for x in la)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_on_card_matches_cpu(arch, dev, monkeypatch):
    """One float32 train step's loss and gradients of the reduced config,
    card (the kernels both ways) against CPU (the plain versions), on the
    same weights and batch (``batch_for``'s, bit-equal on both devices):
    within ``FAMILY_F32_TOL``; the MoE layers route alike in every
    choice."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, hybrid, transformer
    from repro_torch.models.common import tree_to
    from repro_torch.models.moe import route
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.tree import leaves_with_path, tree_map
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = tree_map(lambda p: p.float(), model.init_params(
        torch.Generator().manual_seed(1), "cpu"))
    batch = _family_batch(cfg, 2, "cpu")
    card_batch = _family_batch(cfg, 2, dev)
    for k in batch:
        assert torch.equal(batch[k], card_batch[k].cpu()), k
    sets = []
    inner = transformer.moe_apply

    def recorded(p, x, c):
        sets.append(route(p, x.reshape(-1, x.shape[-1]), c)[1].cpu())
        return inner(p, x, c)
    for mod in (transformer, hybrid):
        monkeypatch.setattr(mod, "moe_apply", recorded)
    lc, gc = value_and_grad(model, params, batch)
    n = len(sets)
    ld, gd = value_and_grad(model, tree_to(params, dev), card_batch)
    for a, b in zip(sets[:n], sets[n:]):
        assert torch.equal(a, b)
    assert abs(float(ld) - float(lc)) <= FAMILY_F32_TOL[0]
    for (path, a), (_, b) in zip(leaves_with_path(gc),
                                 leaves_with_path(gd)):
        torch.testing.assert_close(
            b.cpu(), a, rtol=0,
            atol=FAMILY_F32_TOL[1] * float(a.abs().max()), msg=path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_gather_backward_on_card_is_the_cpu_fold(dtype, dev):
    """The dispatch gather's backward (each token's slot gradients folded
    in ascending expert id) on the card: bit-equal to its plain version,
    the same fold on a CPU copy, and to itself on a second call; a
    routing with dropped assignments."""
    from repro_torch.models import moe as tmoe
    r = np.random.default_rng(3)
    n_tok, E, K, d = 600, 16, 4, 64
    top_e = torch.from_numpy(np.argsort(
        -(r.normal(size=(n_tok, E)) - np.arange(E) * 0.2), axis=1,
        kind="stable")[:, :K].copy())
    cap = tmoe.capacity(n_tok, tmoe.MoECfg(E, K, 8, capacity_factor=0.8))
    order, _, slot, tos, live = tmoe.dispatch(top_e, cap, E)
    _, rows, dropped = tmoe.assignment_slots(order, slot, top_e, E * cap)
    assert bool(dropped.any())
    x = torch.from_numpy(r.normal(size=(n_tok, d))).to(dtype)
    g = torch.from_numpy(r.normal(size=(E * cap, d))).to(dtype)

    def grad(device):
        xs = x.to(device).requires_grad_(True)
        t = [a.to(device) for a in (tos, live, rows, dropped)]
        xe = tmoe.gather_tokens(xs, *t)
        return torch.autograd.grad(xe, xs, g.to(device))[0]
    want = grad("cpu")
    a, b = grad(dev), grad(dev)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), want)
