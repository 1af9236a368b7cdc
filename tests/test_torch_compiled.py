"""The parts of the port's compiled run that are not CUDA-specific, on the
CPU against the JAX package.

On the card ``Simulation.run`` replays the tick as CUDA graphs and
``serve_waves`` replays ``decode_step``; the graphs are captured from the
same step these tests run eagerly:

* the key table (``random.KeyTable``): every stream the tick draws from,
  derived on the host for each tick before the loop, equals word for
  word the keys an eager derivation with ``split`` gives along the tick's
  named streams, and ``jax.random.split`` / ``fold_in`` under the
  non-partitionable threefry;
* the bulk draws with a key read from the table (its words as 0-d
  tensors) are bit-equal to the same draws with the host key;
* ``TickLoop``'s step (keys from the table, traces into preallocated
  buffers, the next state written back in place) over 60 ticks of
  SockShop with scaling every 5 ticks and migration on: bit-identical
  leaf for leaf, traces exact, to the reference's ``run()``; run in
  windows with ``first_tick`` it equals one run;
* ``DecodeState.pos`` is a 0-d int32 tensor, and 12 decode steps match
  the reference's ``decode_step`` within ``test_torch_models.DECODE_TOL``
  (2e-2: bf16 weights and activations), for both model families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_layouts import matrix_sim
from test_torch_models import DECODE_TOL, _f, _pair, _tokens
from test_torch_phases import jax_reference
from test_torch_sim import _assert_runs_match, _port_matrix_sim

from repro.configs import sockshop as jsockshop

from repro_torch import kernels
from repro_torch import random as trnd
from repro_torch.configs import sockshop as tsockshop
from repro_torch.core import policies
from repro_torch.core.engine import (FABRIC_KEY_NAMES, KEY_NAMES, TickLoop,
                                     _write_back, carry_path)
from repro_torch.core.types import DynParams

N_TICKS = 40


def _sim(network: str, lb: int):
    with jax_reference():
        jsim = matrix_sim(network, "none")
    jsim.params = dataclasses.replace(jsim.params, lb_policy=lb)
    return _port_matrix_sim(jsim)


def _path(names, *steps):
    """A key path from stream names: ``(split names, name)`` pairs, or
    ``(num, index)`` for an unnamed split (``randint``'s)."""
    out = []
    for group, pick in steps:
        out.append((group, pick) if isinstance(group, int)
                   else (len(group), group.index(pick)))
    return tuple(out)


def _expected_paths(network: str, lb: int) -> set:
    names = FABRIC_KEY_NAMES if network == "fabric" else KEY_NAMES
    gen2 = ("api", "wait")
    paths = {_path(names, (names, "gen"), (gen2, "api")),
             _path(names, (names, "gen"), (gen2, "wait")),
             _path(names, (names, "spawn")),
             _path(names, (names, "derive"))}
    if lb == policies.LB_RANDOM:
        paths |= {_path(names, (names, "lb"), (2, i)) for i in (0, 1)}
    if network == "fabric":
        net2 = ("lb", "payload")
        for s in ("net_gen", "net_derive"):
            paths.add(_path(names, (names, s), (net2, "payload")))
            if lb == policies.LB_RANDOM:
                paths |= {_path(names, (names, s), (net2, "lb"), (2, i))
                          for i in (0, 1)}
    return paths


@pytest.mark.parametrize("network,lb", [
    ("uniform", policies.LB_ROUND_ROBIN), ("fabric", policies.LB_ROUND_ROBIN),
    ("uniform", policies.LB_RANDOM)])
def test_key_table_matches_eager_and_reference_keys(network, lb):
    sim = _sim(network, lb)
    state = sim.init_state()
    roots, carry = trnd.chain(state.rng, N_TICKS, carry_path(sim.params))
    loop = TickLoop(sim._tick, DynParams.from_params(sim.params), sim.app,
                    state, N_TICKS)
    loop.keys.fill(roots)
    for k in range(N_TICKS):
        loop.step(sim.scale_due(k))
    table = loop.keys.table[:N_TICKS].numpy()
    assert set(loop.keys.columns) == _expected_paths(network, lb)

    # eager: the host chain of carries, each path split by split
    key = state.rng
    jkey = jnp.asarray(state.rng.numpy().astype(np.uint32))
    with jax.threefry_partitionable(False):
        for t in range(N_TICKS):
            assert roots[t].tolist() == key.tolist()
            np.testing.assert_array_equal(np.asarray(jkey), roots[t])
            for path, col in loop.keys.columns.items():
                k, jk = key, jkey
                for num, i in path:
                    k, jk = trnd.split(k, num)[i], jax.random.split(jk,
                                                                    num)[i]
                assert table[t, col].tolist() == k.tolist(), (t, path)
                np.testing.assert_array_equal(np.asarray(jk), table[t, col])
                np.testing.assert_array_equal(
                    trnd.fold_in(k, t).numpy(),
                    np.asarray(jax.random.fold_in(jk, t)))
            (num, i), = carry_path(sim.params)
            key, jkey = trnd.split(key, num)[i], jax.random.split(jkey,
                                                                  num)[i]
    assert carry.tolist() == key.tolist()


DRAWS = {
    "random_bits": lambda k: trnd.random_bits(k, (33,)),
    "uniform": lambda k: trnd.uniform(k, (33,), 0.5, 2.0),
    "normal": lambda k: trnd.normal(k, (33,)),
    "normal_fma": lambda k: trnd.normal_fma(
        k, (33,), torch.full((33,), 0.3), torch.full((33,), 2.0)),
    "normal_fma_lone": lambda k: trnd.normal_fma(
        k, (33,), torch.tensor(0.3), torch.full((33,), 2.0), lone=True),
    "randint": lambda k: trnd.randint(k, (33,), 0, 1 << 30),
}


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_bulk_draws_from_a_table_key_equal_the_host_key(draw):
    fn = DRAWS[draw]
    roots, _ = trnd.chain(trnd.PRNGKey(7), 4, ((5, 0),))
    table = trnd.KeyTable(4, "cpu")
    table.fill(roots)
    for t in range(4):
        node = trnd.split(table.root(), 5)[2]
        host = trnd.split(torch.from_numpy(roots[t]), 5)[2]
        words = trnd._key_words(node)
        assert all(isinstance(w, torch.Tensor) and w.dim() == 0
                   for w in words)
        got, want = fn(node), fn(host)
        assert got.dtype == want.dtype
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want), t
        table.advance()


def test_key_derivations_take_host_keys_only():
    table = trnd.KeyTable(2, "cpu")
    table.fill(np.zeros((2, 2), np.int64))
    # a loop's root chain starts from a host key; a table key's streams
    # are derived by path steps (splits, and folds since chaos mode)
    with pytest.raises(ValueError, match="host key"):
        trnd.chain(table.root(), 2, ((5, 0),))
    folded = trnd.fold_in(table.root(), 3)
    assert folded.path == ((trnd.FOLD, 3),) and folded.table is table
    with pytest.raises(ValueError, match="steps in a key table"):
        table.fill(np.zeros((3, 2), np.int64))


def _scaling_sim(make_sim, **kw):
    """SockShop, 60 clients over 6 s (60 ticks) with HS scaling every 5
    ticks and migration on."""
    sim = make_sim(60, 6.0, scaling_policy=policies.SCALE_HORIZONTAL,
                   hs_util_hi=0.05, hs_util_lo=0.04, share=300.0,
                   migration_enabled=True, spawn_rate=50.0, **kw)
    sim.params = dataclasses.replace(sim.params, scale_interval=5)
    return sim


def test_tick_loop_with_scaling_and_migration_matches_reference():
    """60 ticks, a scaling tick every 5: the step's writes back, traces
    and table keys give the reference's run bit for bit."""
    with jax_reference():
        jres = _scaling_sim(jsockshop.make_sim).run()
    tsim = _scaling_sim(tsockshop.make_sim, device="cpu")
    assert tsim.params.n_ticks == 60
    tres = tsim.run()
    assert tres.compile_time_s == 0.0
    _assert_runs_match(jres, tres)
    assert int(tres.state.counters.scale_out) > 0


def test_windows_with_first_tick_equal_one_run():
    """``run_state`` in windows that do not align with the scaling
    interval, each from the last one's state, equals one run."""
    sim = _scaling_sim(tsockshop.make_sim, device="cpu")
    state = sim.init_state()
    whole, wtrace = sim.run_state(state)
    for k, v in enumerate(state.requests.arrival.tolist()):
        assert v == -1.0, k          # the start state is left as it was
    parts, traces, t0 = state, [], 0
    for w in (7, 20, 33):
        parts, tr = sim.run_state(parts, w, first_tick=t0)
        traces.append(tr)
        t0 += w
    from repro_torch.core import convert
    a, b = convert.state_to_numpy(whole), convert.state_to_numpy(parts)

    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v
    fb = dict(flat(b))
    for k, v in flat(a):
        np.testing.assert_array_equal(v, fb[k], err_msg=k)
    for f, x in zip(wtrace._fields, wtrace):
        y = torch.cat([getattr(tr, f) for tr in traces])
        assert torch.equal(x, y), f


def test_write_back_survives_swapped_leaves():
    """An output leaf that is another input leaf is read before any copy
    overwrites it."""
    from repro_torch.core.types import Counters
    a = Counters(*[torch.tensor(i) for i in range(12)])
    out = a._replace(spawned=a.finished, finished=a.spawned,
                     completed=a.completed + 10)
    held = [t for t in a]
    _write_back(a, out)
    assert [int(t) for t in a][:5] == [1, 0, 2, 3, 14]
    assert all(x is y for x, y in zip(a, held))


def test_launch_tally_keeps_launches_apart_from_counts():
    before = dict(kernels.counts)
    with kernels.tally() as t:
        kernels.launched("link_share")
        kernels.launched("link_share")
    assert kernels.counts == before and t["link_share"] == 2
    kernels.add_counts(t)
    assert kernels.counts["link_share"] == before["link_share"] + 2
    kernels.counts.update(before)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_decode_position_on_the_device_matches_reference(arch):
    jm, jp, tm, tp = _pair(arch, f32=False)
    B, T = 2, 12
    tok = _tokens(tm.cfg.vocab, B, T, seed=4)
    js = jm.init_decode_state(B, T + 4)
    ts = tm.init_decode_state(B, T + 4, device="cpu")
    assert isinstance(ts.pos, torch.Tensor) and ts.pos.dim() == 0
    assert ts.pos.dtype == torch.int32
    state_tensors = [ts.pos] + [t for ls in ts.layers for t in ls]
    step = jax.jit(jm.decode_step)
    for t in range(T):
        jl, js = step(jp, jnp.asarray(tok[:, t:t + 1]), js)
        tl, ts = tm.decode_step(tp, torch.from_numpy(tok[:, t:t + 1])
                                .long(), ts)
        assert int(ts.pos) == t + 1
        # the state is written in place: the same tensors every step
        assert all(x is y for x, y in zip(
            state_tensors, [ts.pos] + [u for ls in ts.layers for u in ls]))
        np.testing.assert_allclose(_f(tl), _f(jl), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"step {t}")
