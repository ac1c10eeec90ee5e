"""Sequential-consumption replay of the reference SANN: stochastic
trajectory parity (counterpart of ``nlsolver_tpu.solvers.sann_reference``).

Replays ``SANN::solve`` (nlsolver.h:2773-2814) draw for draw on the
bit-parity reference generators, the companion of ``de_reference`` for
simulated annealing (production path: ``sann``).  Consumption order per
outer iteration: ``temperature_iter - 1`` inner proposals, each drawing two
uniforms per dimension through the reference's Box-Muller ``rnorm``
(nlsolver.h:2479-2485; g++ evaluates the left multiplicand first, so the
sqrt/log draw precedes the cos draw), then ONE extra uniform for the
Metropolis test, consumed only when the proposal is worse (the ``||`` of
nlsolver.h:2804 short-circuits; the test is read on the host).

Reference quirks reproduced: the Metropolis difference is measured against
the BEST value seen, not the current chain value; pi is truncated to
3.141593 in rnorm; e - 1 is truncated to 1.7182818 in the cooling schedule
(nlsolver.h:2775).  Termination is max_iter only (nlsolver.h:2787).  Each
transcendental function is the C library's (``core.utils.c_math``), as
the reference binary's: the replay reads each value to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core import (Objective, SolverResult, c_math, drive, exact_product, make_result,
                    signed, start_points)
from ..random import reference_rngs
from ..random.sampling import box_muller_parity
from ._lane import scalar
from .de_reference import no_replay_bounds

_E_MINUS_1 = 1.7182818  # truncated e-1 (nlsolver.h:2775)


@dataclass(frozen=True)
class SANNReferenceConfig:
    """Reference defaults (nlsolver.h:2754-2756)."""

    max_iter: int = 5000
    temperature_iter: int = 10
    temperature_max: float = 10.0
    rng: str = "xorshift"


class SANNRefState(NamedTuple):
    x: torch.Tensor          # best point seen (the reference's in-place x)
    best_val: torch.Tensor
    p: torch.Tensor          # current Markov-chain state
    rng: tuple
    iteration: torch.Tensor
    nfev: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


def normals(rng, nxt, n: int):
    """``n`` reference normals: two uniforms each, the sqrt/log one
    first.  ``([n] tensor, state)``."""
    us, rng = reference_rngs.sample(rng, nxt, 2 * n)
    u1, u2 = us.reshape(n, 2).unbind(1)
    return box_muller_parity(u1, u2), rng


def init(fn: Objective, x0: torch.Tensor, config: SANNReferenceConfig) -> SANNRefState:
    rng0, _ = reference_rngs.make(config.rng, dtype=x0.dtype, device=x0.device)
    false = scalar(False, x0, torch.bool)
    return SANNRefState(x=x0, best_val=fn(x0), p=x0, rng=rng0, iteration=scalar(0, x0),
                        nfev=scalar(1, x0), done=false, converged=false)


def step(fn: Objective, state: SANNRefState, config: SANNReferenceConfig) -> SANNRefState:
    dtype, dev = state.p.dtype, state.p.device
    _, nxt = reference_rngs.make(config.rng, dtype=dtype, device=dev)
    if bool(state.iteration >= config.max_iter):
        return state._replace(done=torch.ones_like(state.done))

    n = state.p.shape[-1]
    tmax = torch.tensor(config.temperature_max, dtype=dtype, device=dev)
    scale = 1.0 / tmax                                      # nlsolver.h:2777
    t = tmax / c_math("log", state.iteration.to(dtype) + _E_MINUS_1)
    cs = t * scale
    x, best_val, p, rng, nfev = state.x, state.best_val, state.p, state.rng, state.nfev
    for _ in range(config.temperature_iter - 1):            # j = 1..titer-1
        z, rng = normals(rng, nxt, n)
        ptry = p + exact_product(cs * z)
        val = fn(ptry)
        nfev = nfev + 1
        diff = val - best_val                               # vs BEST, nlsolver.h:2803
        if bool(diff <= 0.0):
            met = True
        else:
            u, rng = nxt(rng)
            met = bool(u < c_math("exp", -diff / t))
        if met:
            p = ptry
        improved = val <= best_val                          # implies met
        x = torch.where(improved, ptry, x)
        best_val = torch.where(improved, val, best_val)
    return SANNRefState(x=x, best_val=best_val, p=p, rng=rng, iteration=state.iteration + 1,
                        nfev=nfev, done=torch.zeros_like(state.done),
                        converged=torch.zeros_like(state.converged))


def minimize(fn: Objective, x0, config: SANNReferenceConfig = SANNReferenceConfig(), bounds=None,
             *, _minimize: bool = True) -> SolverResult:
    """Replay the reference SANN from ``x0 [n]``; a start point that is no
    tensor goes to the card."""
    no_replay_bounds(bounds)
    sfn = signed(fn, _minimize)
    state = init(sfn, start_points(x0), config)
    state = drive(lambda s: step(sfn, s, config), state, check_every=1)
    return make_result(x=state.x, f_value=state.best_val if _minimize else -state.best_val,
                       iterations=state.iteration, function_calls=state.nfev,
                       converged=state.converged)


def maximize(fn, x0, config: SANNReferenceConfig = SANNReferenceConfig(), bounds=None):
    return minimize(fn, x0, config, bounds, _minimize=False)
