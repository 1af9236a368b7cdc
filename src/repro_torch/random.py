"""Threefry-2x32 counter-based random numbers, bit for bit with the
non-partitionable derivation of ``jax.random`` (``jax_threefry_partitionable
= False``): ``PRNGKey``, ``split``, ``fold_in``, ``random_bits``, ``uniform``,
``normal`` and ``randint``; ``split``, ``uniform``, the bits and the
bfloat16 ``normal_bf16`` also in the partitionable derivation (JAX's
default, which the synthetic data pipeline's reference draws under).

Keys are derived on the host: the simulation's key schedule is a pure
function of the seed and the tick (it never reads simulation data), so
deriving keys there costs the device nothing and never synchronises it.
Only the bulk bits behind ``uniform``/``normal``/``normal_bf16``/
``randint`` are generated on the caller's ``device``.  A bulk draw takes its key in one of two
forms: a host key (an int64 CPU tensor ``[2]`` holding two uint32 words,
which ``split``/``fold_in`` also take), whose words enter the launches as
constants; or a ``TableKey``, a stream of a ``KeyTable`` read on the device
at the table's step counter, whose words enter ``threefry2x32`` as 0-d
tensors, so a loop captured once as a CUDA graph draws from new keys at
every replay.  uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF``.

The draws carry no batch axis.  Every point of a sweep
(``Simulation.run_batch``) starts from the same seed and the key schedule
depends on nothing else, so all points draw the same bits: a batched tick
draws once, from one row of the ``KeyTable``, and broadcasts the draw over
its points.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on two uint32 lanes:
    Python ints (key derivations, on the host), int64 numpy arrays (a key
    table's streams, on the host) or int64 tensors (bulk bits, on the
    caller's device; the key words as ints or 0-d tensors) alike."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _host_words(key: torch.Tensor) -> tuple:
    if not isinstance(key, torch.Tensor) or key.device.type != "cpu" \
            or key.shape != (2,):
        raise ValueError("key derivations take a host key: a CPU tensor "
                         "of shape [2]")
    k1, k2 = key.tolist()
    return int(k1), int(k2)


def _key_words(key) -> tuple:
    """A bulk draw's key words: Python ints for a host key, 0-d tensors
    for a table key."""
    if isinstance(key, TableKey):
        return key.table.words(key.path)
    return _host_words(key)


def _hash_counts(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``jax._src.prng.threefry_2x32``: hash a flat uint32 count vector,
    the first half through lane 0 and the second through lane 1."""
    k1, k2 = _key_words(key)
    n = count.shape[0]
    if n % 2:
        count = torch.cat([count, count.new_zeros(1)])
    h = count.shape[0] // 2
    y0, y1 = threefry2x32(k1, k2, count[:h], count[h:])
    return torch.cat([y0, y1])[:n]


def _hash_words(key: torch.Tensor, count: list) -> list:
    """``_hash_counts`` on a few Python ints (the key derivations: no
    tensor ops, nothing on any device)."""
    k1, k2 = _host_words(key)
    n = len(count)
    if n % 2:
        count = count + [0]
    h = len(count) // 2
    lanes = [threefry2x32(k1, k2, a, b) for a, b in zip(count[:h], count[h:])]
    return ([y0 for y0, _ in lanes] + [y1 for _, y1 in lanes])[:n]


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey`` for an int32 seed (x64 disabled)."""
    s = int(np.int32(seed))
    return torch.tensor([0, s & M32], dtype=torch.int64)


def split(key, num: int = 2, partitionable: bool = False):
    """``jax.random.split`` → ``[num, 2]`` keys; of a ``TableKey``, its
    ``num`` child streams (a list).  ``partitionable``: the derivation of
    ``jax_threefry_partitionable = True`` (JAX's default from 0.5), where
    key i is the hash of the count pair (0, i)."""
    if partitionable:
        k1, k2 = _host_words(key)
        return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                            dtype=torch.int64)
    if isinstance(key, TableKey):
        return [TableKey(key.table, key.path + ((num, i),))
                for i in range(num)]
    words = _hash_words(key, list(range(2 * num)))
    return torch.tensor(words, dtype=torch.int64).reshape(num, 2)


def fold_in(key, data: int):
    """``jax.random.fold_in`` with a scalar uint32 datum; of a
    ``TableKey``, the child stream below a fold step."""
    if isinstance(key, TableKey):
        return TableKey(key.table, key.path + ((FOLD, int(data) & M32),))
    return torch.tensor(_hash_words(key, [0, int(data) & M32]),
                        dtype=torch.int64)


# The first entry of a path step that folds in a datum (``(FOLD, data)``)
# where a split step is ``(num, index)``.
FOLD = "fold"


def _child(k1, k2, step):
    """The words of the key one path step below key words ``k1``/``k2``
    (ints, or numpy arrays of many keys): ``(num, index)`` is key
    ``index`` of ``split(key, num)``, ``(FOLD, data)`` is ``fold_in(key,
    data)``, which hashes the count pair ``(0, data)``."""
    if step[0] == FOLD:
        return threefry2x32(k1, k2, 0, step[1])
    return _split_child(k1, k2, *step)


def _split_child(k1, k2, num: int, i: int):
    """The words of key ``i`` of ``split(key, num)`` for key words
    ``k1``/``k2`` (ints, or numpy arrays of many keys): word ``j`` of the
    split's flat output is lane ``j``'s first output for ``j < num``, else
    lane ``j - num``'s second, and lane ``c`` hashes ``(c, num + c)``."""
    out = []
    for j in (2 * i, 2 * i + 1):
        lane, half = (j, 0) if j < num else (j - num, 1)
        out.append(threefry2x32(k1, k2, lane, num + lane)[half])
    return out[0], out[1]


def chain(key: torch.Tensor, n: int, path: Tuple[tuple, ...]):
    """The root keys of ``n`` steps of a loop whose next root is the key
    at ``path`` (steps as ``_child`` takes them) of the current one,
    beginning at host key ``key``: ``([n, 2]`` int64 words, the host key
    after the last step)."""
    k1, k2 = _host_words(key)
    roots = np.empty((n, 2), np.int64)
    for t in range(n):
        roots[t] = k1, k2
        for step in path:
            k1, k2 = _child(k1, k2, step)
    return roots, torch.tensor([k1, k2], dtype=torch.int64)


class TableKey(NamedTuple):
    """The stream at ``path`` (``(num, index)`` splits and ``(FOLD,
    data)`` folds) below the current step's root key of ``table``."""
    table: "KeyTable"
    path: Tuple[tuple, ...]


class KeyTable:
    """The keys of a loop of steps, derived on the host before the loop
    and read on the device at a step counter.

    ``fill(roots)`` takes each step's root key (``chain``) and writes, for
    each of those steps, the key of every stream drawn from so far into
    the ``[cap, streams, 2]`` device table; ``root()`` is the current
    step's root as a ``TableKey``, which ``split`` descends and a bulk draw
    reads at ``step`` (a 0-d int64 device counter that ``advance()``
    moves).  The step's row is gathered once, at its first draw.  A stream
    first drawn from adds a column, derived on the host for the filled
    steps: that may happen before a CUDA graph capture, never under one.
    ``fill`` copies through pinned memory without synchronising."""

    def __init__(self, cap: int, device):
        self.device = torch.device(device)
        self.cap = cap
        self.step = torch.zeros((), dtype=torch.int64, device=self.device)
        self.table = torch.zeros((cap, 0, 2), dtype=torch.int64,
                                 device=self.device)
        self.columns: Dict[tuple, int] = {}
        self.roots = np.zeros((0, 2), np.int64)
        self._row = None

    def root(self) -> TableKey:
        return TableKey(self, ())

    def derive(self, roots: np.ndarray, paths=None) -> np.ndarray:
        """The host table ``[n, len(paths), 2]``: each path's key below
        each of the ``n`` root keys (every column's, by default)."""
        paths = list(self.columns) if paths is None else paths
        memo = {(): roots}
        out = np.empty((len(roots), len(paths), 2), np.int64)
        for c, path in enumerate(paths):
            for d in range(1, len(path) + 1):
                if path[:d] not in memo:
                    keys = memo[path[:d - 1]]
                    memo[path[:d]] = np.stack(_child(
                        keys[:, 0], keys[:, 1], path[d - 1]), axis=1)
            out[:, c] = memo[path]
        return out

    def _upload(self, rows: np.ndarray, dst: torch.Tensor) -> None:
        host = torch.from_numpy(rows)
        if self.device.type == "cuda":
            host = host.pin_memory()
        dst.copy_(host, non_blocking=True)

    def fill(self, roots: np.ndarray) -> None:
        """Load the root keys of the next ``len(roots)`` steps (at most
        ``cap``) and rewind the counter."""
        if len(roots) > self.cap:
            raise ValueError(f"{len(roots)} steps in a key table of "
                             f"{self.cap}")
        self.roots = np.asarray(roots, np.int64)
        if self.columns and len(roots):
            self._upload(self.derive(self.roots), self.table[:len(roots)])
        self.rewind()

    def rewind(self) -> None:
        self.step.zero_()
        self._row = None

    def advance(self) -> None:
        self.step.add_(1)
        self._row = None

    def words(self, path) -> tuple:
        col = self.columns.get(path)
        if col is None:
            if self.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"key stream {path} is first drawn from "
                                   "under a CUDA graph capture; draw it "
                                   "once before capturing")
            col = self.columns[path] = len(self.columns)
            rows = np.zeros((self.cap, 1, 2), np.int64)
            rows[:len(self.roots)] = self.derive(self.roots, [path])
            new = torch.empty((self.cap, 1, 2), dtype=torch.int64,
                              device=self.device)
            self._upload(rows, new)
            self.table = torch.cat([self.table, new], dim=1)
            self._row = None
        if self._row is None:
            self._row = self.table.index_select(0, self.step.view(1))[0]
        return self._row[col, 0], self._row[col, 1]


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """32 random bits per element (int64 holding a uint32), on ``device``."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if size >= M32:
        raise NotImplementedError("more than 2**32 - 1 random words")
    counts = torch.arange(size, dtype=torch.int64, device=device)
    return _hash_counts(key, counts).reshape(shape)


def random_bits_partitionable(key: torch.Tensor, shape: Sequence[int],
                              device=None) -> torch.Tensor:
    """``random_bits`` under ``jax_threefry_partitionable = True``: element
    i is the xor of the two words of the hash of the count pair (0, i)."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if size >= M32:
        raise NotImplementedError("more than 2**32 - 1 random words")
    counts = torch.arange(size, dtype=torch.int64, device=device)
    k1, k2 = _host_words(key)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return (y0 ^ y1).reshape(shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick: [1, 2) from the top 23 bits, minus 1 → [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None,
            partitionable: bool = False) -> torch.Tensor:
    """``jax.random.uniform`` (float32)."""
    lo = np.float32(minval)
    hi = np.float32(maxval)
    draw = random_bits_partitionable if partitionable else random_bits
    f = _unit_floats(draw(key, shape, device))
    span = float(np.float32(hi - lo))
    return torch.clamp_min(f * span + float(lo), float(lo))


# (device, draw sizes) -> the counter lanes of ``uniform_many``: constant
# for the sizes, so kept (built outside a CUDA graph capture)
_LANES: dict = {}


def _lanes(sizes: tuple, device) -> tuple:
    """The two counter lanes ``_hash_counts`` hashes for draws of
    ``sizes`` words, concatenated draw by draw."""
    key = (torch.device(device), sizes)
    hit = _LANES.get(key)
    if hit is None:
        x0, x1 = [], []
        for n in sizes:
            h = (n + 1) // 2
            c = np.arange(2 * h, dtype=np.int64)
            c[n:] = 0
            x0.append(c[:h])
            x1.append(c[h:])
        hit = tuple(torch.from_numpy(np.concatenate(x)).to(device)
                    for x in (x0, x1))
        if not (key[0].type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _LANES[key] = hit
    return hit


def uniform_many(draws, device=None) -> list:
    """``uniform(key, shape)`` (on [0, 1)) for each ``(key, shape)`` of
    ``draws``, hashed in one pass: each lane runs threefry under its own
    draw's key words, so every draw gets ``uniform``'s bits for the
    operations of one draw."""
    shapes = [tuple(int(d) for d in shape) for _, shape in draws]
    sizes = tuple(math.prod(sh) for sh in shapes)
    x0, x1 = _lanes(sizes, device)
    k1, k2 = [], []
    for (key, _), n in zip(draws, sizes):
        h = (n + 1) // 2
        for w, out in zip(_key_words(key), (k1, k2)):
            out.append(w.expand(h) if isinstance(w, torch.Tensor) else
                       torch.full((h,), w, dtype=torch.int64, device=device))
    y0, y1 = threefry2x32(torch.cat(k1), torch.cat(k2), x0, x1)
    u0, u1 = _unit_floats(y0), _unit_floats(y1)
    out, a = [], 0
    for shape, n in zip(shapes, sizes):
        h = (n + 1) // 2
        out.append(torch.cat([u0[a:a + h], u1[a:a + h]])[:n].reshape(shape))
        a += h
    return out


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add ``a*b + c`` with one rounding.  XLA's CPU
    backend contracts multiply-add chains into FMAs, so every site where the
    reference's compiled program does so goes through here to give the
    same bits.  Python-number operands are float32 values (rounded here if
    not).

    Emulated in float64: the float32 product is exact there, the sum is
    rounded to odd (round to nearest, then, if that was inexact and the
    last bit is even, one step toward the exact sum, whose error TwoSum
    gives exactly), and rounding a round-to-odd float64 to float32 is
    the correctly rounded result — plain float64 rounding twice is not,
    when ``|c|`` dwarfs ``a*b``."""
    p = a.double() * _f64(b)
    c = _f64(c)
    s = p + c
    bc = s - p                       # TwoSum: err = (p + c) - s exactly
    err = (p - (s - bc)) + (c - bc)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


def _f64(v):
    return v.double() if isinstance(v, torch.Tensor) else float(np.float32(v))


def _fma32_poly(a: torch.Tensor, b, c) -> torch.Tensor:
    """``fma32`` without the round-to-odd step (float64 rounds twice), for
    the fixed polynomials of ``log1p`` and ``erf_inv`` only: over every
    input ``normal`` can give them it yields XLA's bits (the exhaustive
    test of the two functions holds it so) with about a quarter of
    ``fma32``'s launches; they run a few dozen times per ``normal`` draw."""
    return (a.double() * _f64(b) + _f64(c)).float()


def div32(x: torch.Tensor, s) -> torch.Tensor:
    """``x / s`` for a Python number or a device tensor ``s`` (a sweep's
    per-point values, shaped to broadcast), rounded as one IEEE division
    on every device.  (PyTorch's CUDA path turns division by a host
    scalar into multiplication by its reciprocal, which can differ in the
    last bit; a tensor on the device keeps it a true division.)"""
    if isinstance(s, torch.Tensor):
        return x / s
    return x / torch.full((), float(np.float32(s)), dtype=x.dtype,
                          device=x.device)


def _f32(h: str) -> float:
    """A float32 constant from the hex of its float64 widening (as the
    constants appear in XLA's lowered LLVM IR)."""
    return float(np.float32(struct.unpack(">d", bytes.fromhex(h))[0]))


# XLA's CPU ``log-plus-one``: a Cephes rational approximation for
# |x| < sqrt(2) - 1, else a Cephes ``logf`` of 1 + x.  Evaluated in the
# order (and with the FMA contractions) of the compiled reference; held
# bit for bit over every input ``normal`` can produce.
_L1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
            6.5787325942061044846969E0, 2.9911919328553073277375E1,
            6.0949667980987787057556E1, 5.7112963590585538103336E1,
            2.0039553499201281259648E1)
_L1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
            2.2176239823732856465394E2, 3.0909872225312059774938E2,
            2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOGF_C = tuple(_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000"))
_LN2_LO, _LN2_HI = _f32("BF2BD01060000000"), _f32("3FE6300000000000")
_SQRTHF = _f32("3FE6A09E60000000")
_SMALL = _f32("3FDA8279A0000000")
_FLT_MIN = _f32("3810000000000000")


def _logf(u: torch.Tensor) -> torch.Tensor:
    """Cephes ``logf`` for finite u > 0 (the only inputs ``log1p`` gives)."""
    bits = torch.clamp_min(u, _FLT_MIN).view(torch.int32)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).float() + 1.0
    small = mant < _SQRTHF
    e = e - small.float()
    x = (mant - 1.0) + torch.where(small, mant, 0.0)
    z = x * x
    x3 = z * x
    c = _LOGF_C
    y1 = _fma32_poly(_fma32_poly(x, c[0], c[1]), x, c[6])
    y2 = _fma32_poly(_fma32_poly(x, c[2], c[3]), x, c[7])
    y3 = _fma32_poly(_fma32_poly(x, c[4], c[5]), x, c[8])
    p = _fma32_poly(_fma32_poly(y1, x3, y2), x3, y3)
    q = _fma32_poly(p, x3, e * _LN2_LO)
    r = _fma32_poly(-z, 0.5, x) + q
    return _fma32_poly(e, _LN2_HI, r)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA's CPU backend computes it, for x > -1."""
    def poly(coef):
        p = torch.full_like(x, float(np.float32(coef[0])))
        for ci in coef[1:]:
            p = _fma32_poly(p, x, float(np.float32(ci)))
        return p
    x2 = x * x
    s = poly(_L1P_NUM) / poly(_L1P_DEN)
    small = x + _fma32_poly(x2, -0.5, (x * x2) * s)
    return torch.where(x.abs() < _SMALL, small, _logf(x + 1.0))


# XLA's CPU ``exponential`` for float32: Cephes' ``expf`` range reduction
# and polynomial, with the input clamped to [-104, 88.8] and the exponent
# to [-127, 127] (2^-127 flushes to 0).  The constants are those of the
# lowered LLVM IR; the backend contracts every multiply feeding an add or
# a subtract into an FMA, and flushes denormals to zero.
_EXP_LO, _EXP_HI = _f32("C055F33340000000"), _f32("4056333340000000")
_LOG2E = _f32("3FF7154760000000")
_EXP_C1, _EXP_C2 = _f32("3FE6300000000000"), _f32("BF2BD01060000000")
_EXP_P = tuple(_f32(h) for h in (
    "3F2A0D2CE0000000", "3F56E879C0000000", "3F81112100000000",
    "3FA5553820000000", "3FC5555540000000")) + (0.5,)


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as XLA's CPU backend computes it (held bit for bit
    against ``jax.jit(jnp.exp)``)."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma32(x, _LOG2E, 0.5)), -127.0, 127.0)
    a = fma32(n, -_EXP_C1, x)
    a = fma32(n, -_EXP_C2, a)
    z = fma32(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = fma32(z, a, c)
    z = fma32(z, a * a, a) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    # the backend flushes denormal results to zero
    return torch.where(out < _FLT_MIN, 0.0, out)


# M. Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011),
# single-precision form: the polynomial XLA lowers ``chlo.erf_inv`` to.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _sqrt32(w: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, through float64 (torch's vectorised
    CPU sqrt is not always correctly rounded; XLA's and CUDA's are)."""
    return torch.sqrt(w.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function (Giles' polynomial, as XLA: Horner
    steps contracted into FMAs)."""
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt32(w) - 3.0)
    c = lambda i: torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                              float(np.float32(_ERFINV_GE5[i])))
    p = c(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32_poly(p, w, c(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape: Sequence[int],
           device=None) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``sqrt(2)·erf_inv(u)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return erf_inv(u) * _SQRT2


_BF16_NORMAL_LO = -0.99609375     # nextafter(-1, 0) in bfloat16
_BF16_SQRT2 = 1.4140625           # sqrt(2) in bfloat16
_BF16_NORMALS: Dict[torch.device, torch.Tensor] = {}


def _bf16_normal_table(device) -> torch.Tensor:
    """``normal_bf16``'s value for each of the 256 random bytes, as the
    reference computes it: the byte's top 7 bits as a bfloat16 mantissa
    in [1, 2), minus 1, times ``1 - lo`` (2 in bfloat16) plus ``lo``, each
    step rounded to bfloat16, then ``max(lo, ·)``; XLA's float32
    ``erf_inv`` of that, rounded to bfloat16; times sqrt(2) rounded to
    bfloat16.  Built on the host, once per device."""
    device = torch.device(device)
    table = _BF16_NORMALS.get(device)
    if table is None:
        byte = torch.arange(256, dtype=torch.int64)
        m = ((byte >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16) - 1
        lo = torch.tensor(_BF16_NORMAL_LO, dtype=torch.bfloat16)
        span = torch.tensor(1.0, dtype=torch.bfloat16) - lo
        u = torch.maximum(lo, m * span + lo)
        e = erf_inv(u.float()).to(torch.bfloat16)
        table = (e.float() * _BF16_SQRT2).to(torch.bfloat16).to(device)
        _BF16_NORMALS[device] = table
    return table


def normal_bf16(key: torch.Tensor, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.bfloat16)`` under the
    partitionable threefry (JAX's default): ``random_bits`` at 8 bits
    (the low byte of the partitionable draw's word) mapped through the
    bfloat16 chain of ``_bf16_normal_table``; 128 distinct values in
    [-2.890625, 2.515625]."""
    byte = random_bits_partitionable(key, shape, device) & 0xFF
    return _bf16_normal_table(byte.device)[byte]


def normal_fma(key: torch.Tensor, shape: Sequence[int], std: torch.Tensor,
               mean: torch.Tensor, lone: bool = False,
               device=None) -> torch.Tensor:
    """``mean + std·normal(key, shape)`` rounded once (one fused
    multiply-add), as the reference's compiled tick evaluates its spawn
    lengths and payloads.

    ``lone`` says ``std`` was gathered from a one-entry table (one
    service, one API).  For a draw of more than one element XLA turns such
    a gather into a broadcast of the scalar and folds ``normal``'s sqrt(2)
    into it, hoisting the product out of the tick loop: the tick computes
    ``mean + erf_inv(u)·r`` with ``r = round(std·sqrt(2))``, not ``mean +
    std·round(erf_inv(u)·sqrt(2))``.  A one-element draw needs no
    broadcast, and a larger table keeps its gather: both keep the order
    of ``normal``."""
    e = erf_inv(uniform(key, shape, _NORMAL_LO, 1.0, device))
    if lone and math.prod(shape) > 1:
        return fma32(e, std * _SQRT2, mean)
    return fma32(std, e * _SQRT2, mean)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint`` (int32, ``minval < maxval`` ≤ 2**31 - 1)."""
    k = split(key, 2)
    higher = random_bits(k[0], shape, device)
    lower = random_bits(k[1], shape, device)
    span = (int(maxval) - int(minval)) & M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((higher % span) * mult) & M32) + (lower % span)) & M32
    return (off % span + int(minval)).to(torch.int32)


# The float64 sites above are the port's declared widenings: simcheck's op
# lint (``analysis.op_lint``) allows float64 inside them and nowhere else
# in the tick.
from .analysis import op_lint as _op_lint  # noqa: E402

_op_lint.declare_wide(fma32, _fma32_poly, _sqrt32)
