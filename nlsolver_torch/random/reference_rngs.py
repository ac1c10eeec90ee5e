"""Bit-exact re-creations of the reference RNG functors (counterpart of
``nlsolver_tpu.random.reference_rngs``).

Reference: ``nlsolver::rng`` (nlsolver.h:1176-1382): halton, recurrent,
splitmix64, xoshiro256+, xorshift128+.  The solvers' own randomness is a
``torch.Generator`` (``sampling.py``); these exist for

  * trajectory parity against the reference binary (the replays of
    ``solvers/*_reference.py``, the golden trajectories of
    ``nlsolver_torch.parity``);
  * users porting experiments that depend on the reference streams.

A 64-bit word is a (hi, lo) pair of 32-bit halves, each held in ``int64``
and kept in ``[0, 2^32)``, on the device of the run: ``>>`` on a
non-negative ``int64`` is then a logical shift, a left shift never
reaches the sign bit, and products are formed from 16-bit limbs so that
no ``int64`` product overflows (the port relies on no wrap-around).
Seeding quirks are reproduced: splitmix starts from 12374563468
(nlsolver.h:1265), and xoshiro's third word is seeded from
``(uint64)splitmix.yield()``, a float in [0, 1) truncated to ZERO
(nlsolver.h:1295), so only two of its four words carry entropy.  A
variate is computed in float64 whatever dtype it is emitted in (the JAX
package's arithmetic with ``jax_enable_x64``).

Every generator is a pair of pure functions, ``init`` and
``next(state) -> (u, state)``; ``sample`` draws a sequence.
"""
from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_MAX64_F = 18446744073709551615.0
_I64 = torch.int64


class U64(NamedTuple):
    hi: torch.Tensor   # int64 in [0, 2^32)
    lo: torch.Tensor   # int64 in [0, 2^32)


def u64(hi: int, lo: int, device=None) -> U64:
    return U64(torch.tensor(hi, dtype=_I64, device=device),
               torch.tensor(lo, dtype=_I64, device=device))


def from_int(v: int, device=None) -> U64:
    return u64((v >> 32) & _M32, v & _M32, device)


def to_int(a: U64) -> int:
    """The word as a Python integer (reads the device)."""
    return (int(a.hi) << 32) | int(a.lo)


def to_float(a: U64, dtype=torch.float32) -> torch.Tensor:
    """``(scalar_t)u64 / (scalar_t)(2^64 - 1)``, the C++ conversion: the
    word becomes a float64 with one rounding, then is divided by 2^64 (an
    exact scaling) and cast to ``dtype``."""
    wide = a.hi.to(torch.float64) * 4294967296.0 + a.lo.to(torch.float64)
    return (wide / torch.tensor(_MAX64_F, dtype=torch.float64, device=wide.device)).to(dtype)


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    return U64((a.hi + b.hi + (lo >> 32)) & _M32, lo & _M32)


def xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def shl(a: U64, k: int) -> U64:
    if k == 0:
        return a
    zero = torch.zeros_like(a.lo)
    if k == 32:
        return U64(a.lo, zero)
    if k > 32:
        return U64((a.lo << (k - 32)) & _M32, zero)
    return U64(((a.hi << k) & _M32) | (a.lo >> (32 - k)), (a.lo << k) & _M32)


def shr(a: U64, k: int) -> U64:
    if k == 0:
        return a
    zero = torch.zeros_like(a.hi)
    if k == 32:
        return U64(zero, a.hi)
    if k > 32:
        return U64(zero, a.hi >> (k - 32))
    return U64(a.hi >> k, (a.lo >> k) | ((a.hi << (32 - k)) & _M32))


def rotl(a: U64, k: int) -> U64:
    left = shl(a, k)
    right = shr(a, 64 - k)
    return U64(left.hi | right.hi, left.lo | right.lo)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """32 x 32 -> (hi32, lo32) of two words in ``[0, 2^32)`` through
    16-bit limbs: every partial product stays below 2^32."""
    a_lo, a_hi = a & _M16, a >> 16
    b_lo, b_hi = b & _M16, b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> 16) + (lh & _M16) + (hl & _M16)
    lo = (ll & _M16) | ((mid & _M16) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def _mul_lo32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of ``a * b``: the 16-bit limbs' cross products
    (below 2^33 together) shifted by 16 stay below 2^50."""
    cross = (a >> 16) * (b & _M16) + (a & _M16) * (b >> 16)
    return ((a & _M16) * (b & _M16) + ((cross & _M16) << 16)) & _M32


def mul(a: U64, b: U64) -> U64:
    """The low 64 bits of ``a * b``."""
    hi, lo = _mul32(a.lo, b.lo)
    return U64((hi + _mul_lo32(a.lo, b.hi) + _mul_lo32(a.hi, b.lo)) & _M32, lo)


# ---------------------------------------------------------------- splitmix64

_GOLDEN = 0x9E3779B97F4A7C15   # golden ratio increment
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
SPLITMIX_DEFAULT_SEED = 12374563468  # nlsolver.h:1265


class SplitmixState(NamedTuple):
    s: U64


def splitmix_init(seed: int = SPLITMIX_DEFAULT_SEED, device=None) -> SplitmixState:
    return SplitmixState(from_int(seed, device))


@lru_cache(maxsize=None)
def _constant(v: int, device: torch.device) -> U64:
    return from_int(v, device)


def splitmix_next_u64(state: SplitmixState) -> Tuple[U64, SplitmixState]:
    """splitmix64 step (nlsolver.h:1266-1278)."""
    dev = state.s.hi.device
    s = add(state.s, _constant(_GOLDEN, dev))
    r = mul(xor(s, shr(s, 30)), _constant(_MIX1, dev))
    r = mul(xor(r, shr(r, 27)), _constant(_MIX2, dev))
    r = xor(r, shr(r, 31))
    return r, SplitmixState(s)


def splitmix_next(state: SplitmixState, dtype=torch.float32):
    r, state = splitmix_next_u64(state)
    return to_float(r, dtype), state


# ------------------------------------------------------------- xoshiro256+

class XoshiroState(NamedTuple):
    s0: U64
    s1: U64
    s2: U64
    s3: U64


def xoshiro_init(device=None) -> XoshiroState:
    """Reference seeding (nlsolver.h:1291-1297): s0 = splitmix u64,
    s1 = s0 >> 32, s2 = (uint64)(float splitmix yield) == 0, s3 = 0."""
    s0, _ = splitmix_next_u64(splitmix_init(device=device))
    zero = u64(0, 0, device)
    return XoshiroState(s0, shr(s0, 32), zero, zero)


def xoshiro_next(state: XoshiroState, dtype=torch.float32):
    """xoshiro256+ step (nlsolver.h:1298-1311)."""
    s0, s1, s2, s3 = state
    result = add(s0, s3)
    t = shl(s1, 17)
    s2 = xor(s2, s0)
    s3 = xor(s3, s1)
    s1 = xor(s1, s2)
    s0 = xor(s0, s3)
    s2 = xor(s2, t)
    s3 = rotl(s3, 45)
    return to_float(result, dtype), XoshiroState(s0, s1, s2, s3)


# ------------------------------------------------------------ xorshift128+

class XorshiftState(NamedTuple):
    x0: U64
    x1: U64


def xorshift_init(device=None) -> XorshiftState:
    """Reference seeding (nlsolver.h:1345-1349): x0 = splitmix u64,
    x1 = x0 >> 32."""
    x0, _ = splitmix_next_u64(splitmix_init(device=device))
    return XorshiftState(x0, shr(x0, 32))


def xorshift_next(state: XorshiftState, dtype=torch.float32):
    """xorshift128+ step (nlsolver.h:1350-1360); the variate is the
    standard u64 -> float conversion of t + s, then the divide."""
    t, s = state.x0, state.x1
    t = xor(t, shl(t, 23))
    t = xor(t, shr(t, 18))
    t = xor(t, xor(s, shr(s, 5)))
    return to_float(add(t, s), dtype), XorshiftState(s, t)


# ----------------------------------------------------------------- halton

class HaltonState(NamedTuple):
    b: torch.Tensor
    y: torch.Tensor
    n: torch.Tensor
    d: torch.Tensor
    x: torch.Tensor


def halton_init(base: float = 2.0, dtype=torch.float32, device=None) -> HaltonState:
    def z(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return HaltonState(z(base), z(1.0), z(0.0), z(1.0), z(1.0))


def halton_next(state: HaltonState):
    """Van der Corput / Halton step (nlsolver.h:1182-1195).  Its branch
    and its loop read the state on the host."""
    b, y, n, d, _ = state
    x = d - n
    if bool(x == 1.0):
        n2, d2, y2 = torch.ones_like(d), d * b, y
    else:
        yc, nc = d, n
        while bool(x <= yc):
            yc = yc / b
            nc = (b + 1.0) * yc - x
        n2, d2, y2 = nc, d, yc
    return n2 / d2, HaltonState(b, y2, n2, d2, x)


# ---------------------------------------------------------------- recurrent

class RecurrentState(NamedTuple):
    alpha: torch.Tensor
    z: torch.Tensor


def recurrent_init(seed: float = 0.5, dtype=torch.float32, device=None) -> RecurrentState:
    alpha = torch.tensor(0.618034, dtype=dtype, device=device)
    z = alpha + torch.tensor(seed, dtype=dtype, device=device)
    return RecurrentState(alpha, z - torch.floor(z))


def recurrent_next(state: RecurrentState):
    """Additive recurrence modulo 1 (nlsolver.h:1236-1241)."""
    z = state.z + state.alpha
    z = z - torch.floor(z)
    return z, RecurrentState(state.alpha, z)


# ------------------------------------------------------------------ common

_BITS = {
    "splitmix": (lambda device: splitmix_init(device=device), splitmix_next),
    "xoshiro": (xoshiro_init, xoshiro_next),
    "xorshift": (xorshift_init, xorshift_next),
}
_FLOATS = {"halton": (halton_init, halton_next), "recurrent": (recurrent_init, recurrent_next)}

# user-registered generators: kind -> (init_fn(dtype, device) -> state,
#                                       next_fn(state) -> (u, state))
_CUSTOM = {}


def register(kind: str, init_fn, next_fn) -> None:
    """Register a user generator under ``kind`` for every place that takes
    a named generator (the replays' ``rng="<kind>"``): the reference
    harness's RNG-functor interop (test_functions.h:40-48).  A generator
    is ``init_fn(dtype, device) -> state`` (a tuple of tensors) and
    ``next_fn(state) -> (u, state)``.  The registry is this package's own."""
    _CUSTOM[kind] = (init_fn, next_fn)


def unregister(kind: str) -> None:
    """Remove a user generator; a kind that is not registered is ignored."""
    _CUSTOM.pop(kind, None)


@contextlib.contextmanager
def registered(kind: str, init_fn, next_fn):
    """``register`` for the duration of a ``with`` block; whatever stood
    under ``kind`` before comes back after it."""
    before = _CUSTOM.get(kind)
    register(kind, init_fn, next_fn)
    try:
        yield
    finally:
        if before is None:
            unregister(kind)
        else:
            _CUSTOM[kind] = before


def make(kind: str, dtype=torch.float32, device=None):
    """``(init_state, next_fn)`` of a generator kind on ``device``.

    ``dtype`` is the width of the emitted variates (and of the state of
    halton and recurrent: the reference's ``recurrent<double>`` stream
    differs from ``recurrent<float>``, rounding accumulating in the modular
    addition)."""
    if kind in _CUSTOM:
        init_fn, next_fn = _CUSTOM[kind]
        return init_fn(dtype, device), next_fn
    if kind in _FLOATS:
        init_fn, next_fn = _FLOATS[kind]
        return init_fn(dtype=dtype, device=device), next_fn
    if kind not in _BITS:
        raise ValueError(f"unknown generator {kind!r}; built in: "
                         f"{sorted(_BITS) + sorted(_FLOATS)}, registered: {sorted(_CUSTOM)}")
    init_fn, bit_next = _BITS[kind]
    return init_fn(device), (lambda s: bit_next(s, dtype))


def sample(state, next_fn, n: int):
    """``n`` variates in order: ``([n] tensor, final state)``."""
    us = []
    for _ in range(n):
        u, state = next_fn(state)
        us.append(u)
    return torch.stack(us), state
