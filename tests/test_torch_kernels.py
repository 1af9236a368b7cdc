"""The port's kernels: plain versions against the JAX reference, and the
CUDA kernels against their plain versions on the card.

``cloudlet_finish`` — the plain version against the reference's ``ref``
jitted with ``time``/``dt`` traced (as inside its compiled tick): every
output bit-identical.  Against the Pallas kernel in interpret mode: bit-
identical except ``new_rem`` when ``rate·dt`` is inexact — the interpret
kernel rounds the product before subtracting, the compiled tick (and the
port) fuse ``rem - rate·dt`` — so there the bound is half an ULP of the
product ``rate·dt``.

The card kernel's order for the instance sums, emulated in numpy (a
stable sort of each tile's lanes by instance, then each instance's runs
folded tile after tile): every ``inst_acc`` bit of the jitted reference,
with tiles small enough that every shape spans several, on a pool with
most lanes on one instance and with terms of -0.0 and 0.

``tropical_matmul`` / ``tropical_closure`` — exact (each term one add,
max is order-free).

The CUDA kernels against their plain versions on the card are in
``test_torch_cuda.py`` (no JAX there, so it runs where the card is).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cloudlet_step import cloudlet_finish_ref as jref_finish
from repro.kernels.cloudlet_step.kernel import cloudlet_finish_pallas
from repro.kernels.tropical import ref as jtrop_ref
from repro.kernels.tropical.kernel import tropical_matmul_pallas
from repro.kernels.tropical.ops import tropical_closure as jclosure
from repro.kernels.tropical.ops import tropical_matmul as jtrop_ops

from repro_torch.core.types import Cloudlets, SimParams, resolve_layout
from repro_torch.kernels import counts
from repro_torch.kernels.cloudlet_step import cloudlet_finish_pool
from repro_torch.kernels.cloudlet_step import ref as tfinish
from repro_torch.kernels.tropical import ops as ttrop
from repro_torch.kernels.tropical import ref as ttrop_ref

# the port's tensors here are small: one intra-op thread per test
# process beats oversubscribing the cores across test workers
torch.set_num_threads(1)

NAMES = ("new_rem", "fin", "tfin", "consumed", "inst_acc", "req_finish",
         "req_crit", "req_out")
FINISH_SHAPES = [(256, 8, 32, 64), (1000, 33, 2000, 256),
                 (512, 16, 64, 512)]


def _finish_args(C, I, R, seed):
    """Pool-shaped inputs (the reference's fused-tick test generator)."""
    r = np.random.default_rng(seed)
    status = r.choice([0, 1, 2], size=C, p=[0.3, 0.2, 0.5]).astype(np.int32)
    rem = r.uniform(0.1, 500.0, size=C).astype(np.float32)
    inst = r.integers(-1, I, size=C).astype(np.int32)
    req = r.integers(-1, R, size=C).astype(np.int32)
    arrival = r.uniform(0.0, 12.0, size=C).astype(np.float32)
    start = np.where(r.random(C) < 0.5, -1.0,
                     r.uniform(0.0, 12.5, size=C)).astype(np.float32)
    depth = r.integers(0, 4, size=C).astype(np.int32)
    rate = r.uniform(0.0, 300.0, size=C).astype(np.float32)
    req_finish = r.uniform(0.0, 12.0, size=R).astype(np.float32)
    req_crit = r.integers(0, 3, size=R).astype(np.int32)
    req_out = r.integers(0, 5, size=R).astype(np.int32)
    return (status, rem, inst, req, arrival, start, depth, rate,
            req_finish, req_crit, req_out)


def _port_finish(args, time, dt, I):
    t = [torch.from_numpy(np.array(a)) for a in args]
    return tfinish.cloudlet_finish(*t[:8], torch.tensor(np.float32(time)),
                                   float(np.float32(dt)), *t[8:], n_inst=I)


@pytest.mark.parametrize("dt", [0.25, 0.1, 0.05])
@pytest.mark.parametrize("C,I,R,bc", FINISH_SHAPES)
def test_cloudlet_finish_matches_jitted_reference(C, I, R, bc, dt):
    args = _finish_args(C, I, R, C + I)
    time = 12.5
    want = jax.jit(lambda t, d, *a: jref_finish(*a[:8], t, d, *a[8:],
                                                n_inst=I))(
        jnp.float32(time), jnp.float32(dt), *args)
    got = _port_finish(args, time, dt, I)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("dt", [0.25, 0.1])
@pytest.mark.parametrize("C,I,R,bc", FINISH_SHAPES)
def test_cloudlet_finish_matches_pallas_interpret(C, I, R, bc, dt):
    args = _finish_args(C, I, R, C + I)
    time = 12.5
    want = cloudlet_finish_pallas(*[jnp.asarray(a) for a in args[:8]],
                                  time, dt,
                                  *[jnp.asarray(a) for a in args[8:]],
                                  n_inst=I, bc=bc, interpret=True)
    got = _port_finish(args, time, dt, I)
    for name, g, w in zip(NAMES, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name != "new_rem":
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        prog = (args[7] * np.float32(dt)).astype(np.float32)
        bound = np.spacing(np.abs(prog)) / 2
        assert (np.abs(g.astype(np.float64) - w) <= bound).all()
        if dt == 0.25:          # rate·dt exact: no rounding to differ by
            np.testing.assert_array_equal(g, w, err_msg=name)


def _kernel_inst_acc(status, inst, rows, n_inst, tile):
    """numpy emulation of ``csrc/cloudlet_finish.cu``'s instance sums.
    Per tile of ``tile`` lanes: a stable sort of the lanes by instance row
    (``n_inst + 1`` for a lane that adds nothing, past the end), the terms
    copied into sorted order and each row's run [start, end) written to
    the tile's table where a key starts and ends, the tile marked in the
    row's mask.  Then, per row, the runs of its marked tiles folded tile
    after tile, one float32 add at a time; unmarked table entries hold
    garbage, as the kernel's table is never cleared."""
    C, none = status.shape[0], n_inst + 1
    irow = np.where(inst >= 0, inst, n_inst)
    key = np.where((status == 2) & (irow <= n_inst), irow, none)
    tiles = max(1, -(-C // tile))
    runs = np.full((tiles, n_inst + 1, 2), 12345, np.int64)
    marked = np.zeros((tiles, n_inst + 1), bool)
    sterms = np.zeros((tiles, tile, 5), np.float32)
    for t in range(tiles):
        k = np.full(tile, none)
        part = key[t * tile:(t + 1) * tile]
        k[:part.shape[0]] = part
        order = np.argsort(k, kind="stable")
        sk = k[order]
        p = np.nonzero(sk < none)[0]
        sterms[t, p] = rows[t * tile + order[p]]
        prev = np.concatenate([[-1], sk[:-1]])
        nxt = np.concatenate([sk[1:], [-1]])
        head, tail = p[prev[p] != sk[p]], p[nxt[p] != sk[p]]
        runs[t, sk[head], 0] = head
        marked[t, sk[head]] = True
        runs[t, sk[tail], 1] = tail + 1
    acc = np.zeros((n_inst + 1, 5), np.float32)
    for t in range(tiles):
        start = np.where(marked[t], runs[t, :, 0], 0)
        n = np.where(marked[t], runs[t, :, 1] - runs[t, :, 0], 0)
        for q in range(int(n.max(initial=0))):
            m = n > q
            acc[m] = acc[m] + sterms[t, start[m] + q]
    return acc


def _jitted_reference(args, time, dt, I):
    return jax.jit(lambda t, d, *a: jref_finish(*a[:8], t, d, *a[8:],
                                                n_inst=I))(
        jnp.float32(time), jnp.float32(dt), *args)


def _emulated_inst_acc(args, time, dt, I, tile):
    t = [torch.from_numpy(np.array(a)) for a in args]
    status, rem, inst, _, arrival, start, _, rate = t[:8]
    *_, rows = tfinish.lane_math(status, rem, inst, arrival, start, rate,
                                 torch.tensor(np.float32(time)),
                                 float(np.float32(dt)))
    return _kernel_inst_acc(args[0], args[2], rows.numpy(), I, tile)


@pytest.mark.parametrize("tile", [64, 4096])
@pytest.mark.parametrize("dt", [0.25, 0.1])
@pytest.mark.parametrize("C,I,R,bc", FINISH_SHAPES)
def test_kernel_order_gives_the_references_instance_sums(C, I, R, bc, dt,
                                                         tile):
    # the card's tile-sort-and-fold order, emulated, against the reference
    # jitted as inside its compiled tick: every inst_acc bit; at a tile of
    # 64 lanes every shape spans several tiles
    args = _finish_args(C, I, R, C + I)
    want = np.asarray(_jitted_reference(args, 12.5, dt, I).inst_acc)
    got = _emulated_inst_acc(args, 12.5, dt, I, tile)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if tile == 64:
        assert -(-C // tile) > 1


@pytest.mark.parametrize("tile", [64, 1024, 4096])
def test_kernel_order_on_a_skewed_pool_with_signed_zeros(tile):
    """Most lanes on one instance (a run that spans every tile), and terms
    that are -0.0 or zero: lanes with rate -0.0 or 0 consume -0.0 or 0.0
    MI, lanes with rem -0.0 finish at once."""
    C, I, R = 3000, 20, 400
    args = list(_finish_args(C, I, R, 5))
    r = np.random.default_rng(6)
    args[2] = np.where(r.random(C) < 0.85, 7, args[2]).astype(np.int32)
    rate, rem = args[7].copy(), args[1].copy()
    rate[r.random(C) < 0.1] = -0.0
    rate[r.random(C) < 0.1] = 0.0
    rem[r.random(C) < 0.1] = -0.0
    args[7], args[1] = rate, rem
    want = _jitted_reference(args, 12.5, 0.1, I)
    acc = np.asarray(want.inst_acc)
    got = _emulated_inst_acc(args, 12.5, 0.1, I, tile)
    np.testing.assert_array_equal(got.view(np.int32), acc.view(np.int32))
    # the case is what it says: one long run, signed zeros in the terms
    execm = args[0] == 2
    assert (execm & (args[2] == 7)).sum() > 0.8 * execm.sum()
    *_, rows = tfinish.lane_math(*(torch.from_numpy(np.array(args[i]))
                                   for i in (0, 1, 2, 4, 5, 7)),
                                 torch.tensor(np.float32(12.5)), 0.1)
    rows = rows.numpy()[execm]
    assert (np.signbit(rows) & (rows == 0)).any() and (rows == 0).any()
    assert acc[7, 0] > 0 and acc[7, 1] > 0


def _pool(args):
    """The same inputs as a stacked default-layout pool."""
    L = resolve_layout(SimParams())
    C = args[0].shape[0]
    ints = np.zeros((C, len(L.i_fields)), np.int32)
    flts = np.zeros((C, len(L.f_fields)), np.float32)
    for name, a in zip(("status", "rem", "inst", "req", "arrival", "start",
                        "depth"), args[:7]):
        if name in L.i_fields:
            ints[:, L.i(name)] = a
        else:
            flts[:, L.f(name)] = a
    return L, ints, flts


def test_pool_wrapper_reads_columns_through_the_layout():
    C, I, R, _ = FINISH_SHAPES[1]
    args = _finish_args(C, I, R, 7)
    L, ints, flts = _pool(args)
    cl = Cloudlets(torch.from_numpy(ints), torch.from_numpy(flts), L)
    t = [torch.from_numpy(np.array(a)) for a in args]
    before = dict(counts)
    got = cloudlet_finish_pool(cl, t[7], torch.tensor(np.float32(3.0)), 0.1,
                               *t[8:], n_inst=I)
    assert counts == before          # the CPU path launches no kernel
    want = _port_finish(args, 3.0, 0.1, I)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


# ---------------------------------------------------------------- unpooled

STEP_NAMES = ("new_rem", "fin", "tfin", "consumed", "used")


def _close_rem(name, g, w, rate, dt):
    """``new_rem`` within half an ULP of ``rate·dt`` (a fused or a rounded
    product, ROADMAP's FMA rule); every other output bit-equal."""
    g, w = np.asarray(g), np.asarray(w)
    if name != "new_rem":
        np.testing.assert_array_equal(g, w, err_msg=name)
        return
    prog = (rate * np.float32(dt)).astype(np.float32)
    assert (np.abs(g.astype(np.float64) - w)
            <= np.spacing(np.abs(prog)) / 2).all()


@pytest.mark.parametrize("dt", [0.25, 0.1])
@pytest.mark.parametrize("C,I,R,bc", FINISH_SHAPES)
def test_unpooled_cloudlet_finish_matches_reference(C, I, R, bc, dt):
    """``ops.cloudlet_finish`` over ``[C]`` columns on the CPU: the jitted
    reference's ``ref.cloudlet_finish`` bit for bit (its compiled program
    fuses ``rem - rate·dt`` as the port does), the Pallas kernel in
    interpret mode with ``new_rem`` within half an ULP of ``rate·dt``."""
    from repro_torch.kernels.cloudlet_step import cloudlet_finish
    args = _finish_args(C, I, R, C + 3 * I)
    t = [torch.from_numpy(np.array(a)) for a in args]
    got = cloudlet_finish(*t[:8], 12.5, dt, *t[8:], n_inst=I)
    want = jax.jit(lambda tm, d, *a: jref_finish(*a[:8], tm, d, *a[8:],
                                                 n_inst=I))(
        jnp.float32(12.5), jnp.float32(dt), *args)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    pallas = cloudlet_finish_pallas(*[jnp.asarray(a) for a in args[:8]],
                                    12.5, dt,
                                    *[jnp.asarray(a) for a in args[8:]],
                                    n_inst=I, bc=bc, interpret=True)
    for name, g, w in zip(NAMES, got, pallas):
        _close_rem(name, g.numpy(), w, args[7], dt)


@pytest.mark.parametrize("dt", [0.25, 0.1])
@pytest.mark.parametrize("C,I,R,bc", FINISH_SHAPES)
def test_unpooled_cloudlet_step_matches_reference(C, I, R, bc, dt):
    """``ops.cloudlet_step`` (and ``ref.cloudlet_step``) on the CPU against
    the reference's jitted ``ref.cloudlet_step`` and its legacy
    ``cloudlet_step_pallas`` in interpret mode: ints and bools exact,
    floats bit-equal but ``new_rem`` (half an ULP of ``rate·dt``)."""
    from repro.kernels.cloudlet_step import cloudlet_step_ref as jref_step
    from repro.kernels.cloudlet_step.kernel import cloudlet_step_pallas

    from repro_torch.kernels.cloudlet_step import (cloudlet_step,
                                                   cloudlet_step_ref)
    status, rem, inst, _, _, _, _, rate = _finish_args(C, I, R, C + I)[:8]
    cols = [torch.from_numpy(a) for a in (status, rem, inst)]
    before = dict(counts)
    got = cloudlet_step(*cols, torch.from_numpy(rate), 12.5, dt, I)
    assert counts == before          # the CPU path launches no kernel
    plain = cloudlet_step_ref(*cols, torch.from_numpy(rate),
                              torch.tensor(np.float32(12.5)), dt, I)
    jit = jax.jit(lambda tm, d, *a: jref_step(*a, tm, d, I))(
        jnp.float32(12.5), jnp.float32(dt), status, rem, inst, rate)
    pallas = cloudlet_step_pallas(status, rem, inst, rate, 12.5, dt,
                                  n_inst=I, bc=bc, interpret=True)
    for name, g, p, j, k in zip(STEP_NAMES, got, plain, jit, pallas):
        np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=name)
        assert g.dtype == {"fin": torch.bool}.get(name, torch.float32)
        _close_rem(name, g.numpy(), j, rate, dt)
        _close_rem(name, g.numpy(), k, rate, dt)


def test_unpooled_apis_refuse_other_devices():
    from repro_torch.kernels.cloudlet_step import (cloudlet_finish,
                                                   cloudlet_step)
    x = torch.zeros(4, device="meta")
    xi = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        cloudlet_step(xi, x, xi, x, 0.0, 0.1, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cloudlet_finish(xi, x, xi, xi, x, x, xi, x, 0.0, 0.1, x, xi, xi, 2)


def _trop_rand(rng, shape, density=0.7):
    x = rng.normal(size=shape).astype(np.float32) * 3.0
    return np.where(rng.random(size=shape) < density, x,
                    -np.inf).astype(np.float32)


@pytest.mark.parametrize("B,M,K,N", [(1, 128, 128, 128), (2, 256, 128, 128),
                                     (1, 128, 256, 384), (3, 5, 7, 3),
                                     (1, 130, 64, 257), (2, 1, 1, 1)])
def test_tropical_matmul_matches_reference(B, M, K, N):
    rng = np.random.default_rng(B * 1000 + M + K + N)
    x = _trop_rand(rng, (B, M, K))
    a = _trop_rand(rng, (B, K, N))
    got = ttrop.tropical_matmul(torch.from_numpy(x), torch.from_numpy(a))
    want = jtrop_ref.tropical_matmul(jnp.asarray(x), jnp.asarray(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pal = jtrop_ops(jnp.asarray(x), jnp.asarray(a), use_pallas=True,
                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


def test_tropical_matmul_matches_pallas_aligned():
    rng = np.random.default_rng(3)
    x = _trop_rand(rng, (3, 256, 256))
    a = _trop_rand(rng, (3, 256, 256))
    pal = tropical_matmul_pallas(jnp.asarray(x), jnp.asarray(a), bm=128,
                                 bn=128, bk=64, interpret=True)
    got = ttrop.tropical_matmul(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


def test_tropical_chunked_plain_version_is_exact():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_trop_rand(rng, (2, 40, 300)))
    a = torch.from_numpy(_trop_rand(rng, (2, 300, 50)))
    full = torch.amax(x[..., :, :, None] + a[..., None, :, :], dim=-2)
    saved = ttrop_ref._CHUNK_ELEMS
    try:
        ttrop_ref._CHUNK_ELEMS = 4000      # force many k-chunks
        np.testing.assert_array_equal(
            ttrop_ref.tropical_matmul(x, a).numpy(), full.numpy())
    finally:
        ttrop_ref._CHUNK_ELEMS = saved


@pytest.mark.parametrize("n,depth", [(24, None), (13, 4), (40, 9)])
def test_tropical_closure_matches_reference(n, depth):
    rng = np.random.default_rng(n)
    w = rng.uniform(0.1, 2.0, size=(n, n)).astype(np.float32)
    a = np.where(np.triu(rng.random((n, n)) < 0.3, k=1), w,
                 -np.inf).astype(np.float32)
    got = ttrop.tropical_closure(torch.from_numpy(a), depth=depth)
    want = jclosure(jnp.asarray(a), depth=depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_refuse_other_devices():
    x = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError):
        ttrop.tropical_matmul(x, x)


@pytest.mark.parametrize("n,seed", [(2, 0), (8, 1), (13, 2), (30, 3)])
def test_critical_path_analysis_matches_reference(n, seed):
    """Alg 2 through the tropical op (plain version on the CPU) against
    the reference's ``response_times``/``response_times_batched``, and
    the DP ``critical_path``/``path_delay`` against the reference's."""
    from repro.core import build_graph as jbuild
    from repro.core import critical_path as jcp
    from repro.core import path_delay as jpd
    from repro.core import response_times as jrt
    from repro.core.critical_path import response_times_batched as jrtb
    from repro_torch.core import build_graph as tbuild
    from repro_torch.core import critical_path as tcp
    from repro_torch.core import path_delay as tpd
    from repro_torch.core import response_times as trt
    from repro_torch.core.critical_path import response_times_batched as trtb
    rng = np.random.default_rng(seed)
    names = [f"s{i}" for i in range(n)]
    calls = {names[i]: [names[j] for j in range(i + 1, n)
                        if rng.random() < 0.35] for i in range(n)}
    calls = {k: v for k, v in calls.items() if v}
    args = (names, calls, [("a", names[0], 1.0), ("b", names[-1], 1.0)],
            {nm: 100.0 for nm in names})
    jg, tg = jbuild(*args), tbuild(*args)
    delays = rng.uniform(0.5, 5.0, size=n)
    np.testing.assert_array_equal(trt(tg, delays, device="cpu"),
                                  jrt(jg, delays))
    batch = rng.uniform(0.1, 3.0, size=(5, n)).astype(np.float32)
    np.testing.assert_array_equal(trtb(tg, batch, device="cpu"),
                                  jrtb(jg, batch))
    for api in range(2):
        rt, path = tcp(tg, delays, api)
        assert (rt, path) == jcp(jg, delays, api)
        assert tpd(path, delays) == jpd(path, delays)
