"""Bit-parity std::mt19937 and libstdc++ uniform_real_distribution<double>
(counterpart of ``nlsolver_tpu.random.mt19937``).

The reference's test harness shows user-RNG interop by wrapping
``std::mt19937`` in a U[0, 1) functor (test_functions.h:40-48) and handing
it to any solver.  This is the same generator as a state machine on
tensors, registered through ``reference_rngs.register`` (``register_mt``,
or ``registered_mt`` for a ``with`` block) so that the replays take
``rng="mt"``: the golden suite replays a real mt19937-driven reference DE
run draw for draw (tests/data/reference_trajectories.tsv, de_rand_mt rows).

  * MT19937 (Matsumoto & Nishimura 1998): the 624-word state seeded as the
    C++ ``mt19937(seed)`` constructor (init_genrand, computed with numpy on
    the host), tempering, and the 397-offset twist in three
    dependency-ordered slices ([0, 227), [227, 454), [454, 624)).
  * libstdc++ ``generate_canonical<double, 53>``: TWO 32-bit draws a
    variate, low word first, ``(x0 + x1 2^32) / 2^64`` in float64, clamped
    to ``nextafter(1, 0)`` where the rounded sum reaches 1.

Words are ``int64`` tensors in ``[0, 2^32)`` on the run's device; the
canonical arithmetic is float64 whatever dtype the variate is emitted in.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

N = 624
M = 397
UPPER = 0x80000000
LOWER = 0x7FFFFFFF
MATRIX_A = 0x9908B0DF
_ONE_MINUS = float(np.nextafter(1.0, 0.0))


class MTState(NamedTuple):
    mt: torch.Tensor    # [624] int64 words
    idx: torch.Tensor   # () int32, 0..624 (624: twist before the next draw)
    dt: torch.Tensor    # () zero of the variates' dtype (a dtype marker)


def seed_table(seed: int = 42) -> np.ndarray:
    """The C++ ``mt19937(seed)`` constructor (init_genrand), on the host."""
    mt = np.empty(N, np.uint32)
    mt[0] = np.uint32(seed)
    with np.errstate(over="ignore"):    # uint32 wrap-around is the algorithm
        for i in range(1, N):
            prev = mt[i - 1]
            mt[i] = (np.uint32(1812433253) * (prev ^ (prev >> np.uint32(30)))
                     + np.uint32(i))
    return mt


def init(seed: int = 42, dtype=torch.float64, device=None) -> MTState:
    return MTState(
        mt=torch.as_tensor(seed_table(seed).astype(np.int64), device=device),
        idx=torch.tensor(N, dtype=torch.int32, device=device),
        dt=torch.zeros((), dtype=dtype, device=device),
    )


def _twist(mt: torch.Tensor) -> torch.Tensor:
    def mix(cur, nxt, far):
        y = (cur & UPPER) | (nxt & LOWER)
        return far ^ (y >> 1) ^ ((y & 1) * MATRIX_A)

    a = mix(mt[0:227], mt[1:228], mt[397:624])          # new[0:227]
    b = mix(mt[227:454], mt[228:455], a[0:227])         # new[227:454]
    c = mix(mt[454:623], mt[455:624], b[0:169])         # new[454:623]
    last = mix(mt[623:624], a[0:1], b[169:170])         # new[623] wraps to new[0]
    return torch.cat([a, b, c, last])


def next_u32(state: MTState) -> Tuple[torch.Tensor, MTState]:
    """One tempered word; the position in the table is read on the host."""
    mt, idx = state.mt, int(state.idx)
    if idx >= N:
        mt, idx = _twist(mt), 0
    y = mt[idx]
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    y = y ^ (y >> 18)
    return y, MTState(mt=mt, idx=torch.full_like(state.idx, idx + 1), dt=state.dt)


def next_canonical(state: MTState) -> Tuple[torch.Tensor, MTState]:
    """One uniform_real_distribution<double>(0, 1) draw (two raw words),
    emitted in the state's dtype."""
    x0, state = next_u32(state)
    x1, state = next_u32(state)
    f64 = torch.float64
    u = (x0.to(f64) + x1.to(f64) * 4294967296.0) / torch.tensor(18446744073709551616.0,
                                                                 dtype=f64, device=x0.device)
    u = torch.where(u >= 1.0, torch.full_like(u, _ONE_MINUS), u)
    return u.to(state.dt.dtype), state


def _generator(seed: int):
    return (lambda dtype, device: init(seed, dtype=dtype, device=device)), next_canonical


def register_mt(kind: str = "mt", seed: int = 42) -> None:
    """Expose mt19937(seed) to the replays as ``rng=kind`` (the reference
    harness's interop pattern), in this package's registry."""
    from . import reference_rngs

    reference_rngs.register(kind, *_generator(seed))


def registered_mt(kind: str = "mt", seed: int = 42) -> contextlib.AbstractContextManager:
    """``register_mt`` for the duration of a ``with`` block."""
    from . import reference_rngs

    return reference_rngs.registered(kind, *_generator(seed))
