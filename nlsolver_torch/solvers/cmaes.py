"""CMA-ES (covariance matrix adaptation evolution strategy) on lane
tensors (counterpart of ``nlsolver_tpu.solvers.cmaes``).

The standard algorithm (Hansen, "The CMA Evolution Strategy: A Tutorial",
arXiv:1604.00772); default hyperparameters follow the tutorial (lambda =
4 + 3 ln n, mu = lambda/2 with log-weights, standard cc/cs/c1/cmu/damps).
The JAX solver runs one instance, ``[lambda, n]`` a generation, and is
batched with ``jax.vmap``; here every lane runs at once: the means
``[B, n]``, the covariances ``[B, n, n]``, the population ``[B, lambda, n]``,
every scalar a ``[B]`` vector, the lanes done when a step begins frozen by
``core.drive``.  One instance (``x0 [n]``, a state without the lane axis)
is the case B = 1.  The eigendecomposition C = B diag(D^2) B^T is
``torch.linalg.eigh`` (``eigh_method="xla"``, the JAX package's name for
the library call) or the parallel-order Jacobi, on the batch.  For many
strategies on one problem at once see ``solvers.cmaes_fleet``, which
shares ``_params`` with this module.

Termination: max_iter, stagnation of the best value, condition-number
explosion, or step-size collapse (nlsolver.h:4566-4574).  Bounds are
honored by projection repair: sampled candidates are clamped into the box
before evaluation and the *repaired* step feeds the mean / path /
covariance updates.  Restart variance kick (nlsolver.h:4566-4568): when the
top-mu costs collapse within ``kick_tol`` after ``kick_patience``
stagnant generations, sigma is multiplied by ``exp(0.2 + cs/damps)``.

Randomness is an input: ``step`` takes the generation's normal draws
``z [B, lambda, n]`` or makes them from a ``torch.Generator``, and
``minimize_batched`` a run's draws (``_lane.Draws``); the state has no
key.  After the first generation C has an eigenvalue of multiplicity
n - mu when n > mu, whose eigenvectors follow the last bit of C: runs
that must agree step by step take ``pop_size`` with mu >= n.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import Bounds, Objective, SolverResult, drive, resolve_bounds, where_lanes
from ..core.lanes import Lanes, as_lanes, matvec
from ._lane import (Draws, _each, draws_on, gather_lanes, gather_rows, lane_full, lane_result,
                    one_lane, run_batched, run_single, step_rows)


@dataclass(frozen=True)
class CMAESConfig:
    pop_size: int = 0          # 0 => 4 + floor(3 ln n)
    sigma0: float = 0.5
    max_iter: int = 500
    f_tol: float = 1e-12       # stagnation tolerance on best value
    best_value_no_change: int = 50
    cond_max: float = 1e14
    # restart variance kick (nlsolver.h:4566-4568): if the top-mu costs
    # span less than kick_tol, sigma *= exp(0.2 + cs/damps).  <= 0 disables.
    kick_tol: float = 1e-6
    # generations of best-value stagnation required before the kick may
    # fire (late healthy generations also have tiny spread)
    kick_patience: int = 10
    # "xla" (the library call, torch.linalg.eigh) or "jacobi" (the
    # parallel-order Jacobi, linalg/jacobi.py)
    eigh_method: str = "xla"


class CMAESState(NamedTuple):
    mean: torch.Tensor          # [B, n] ([n] for one instance)
    sigma: torch.Tensor         # [B]
    C: torch.Tensor             # [B, n, n] covariance
    p_sigma: torch.Tensor       # [B, n] step-size path
    p_c: torch.Tensor           # [B, n] covariance path
    best_x: torch.Tensor        # [B, n]
    best_value: torch.Tensor    # [B]
    prev_best: torch.Tensor     # [B]
    iteration: torch.Tensor     # [B] int32
    nfev: torch.Tensor          # [B] int32
    no_change: torch.Tensor     # [B] int32
    done: torch.Tensor          # [B] bool
    converged: torch.Tensor     # [B] bool


@lru_cache(maxsize=None)
def _params(n: int, pop_size: int):
    """Strategy constants for (n, pop_size), computed once per
    configuration with numpy: plain host values."""
    lam = pop_size if pop_size > 0 else 4 + int(3 * math.log(n))
    mu = lam // 2
    w_raw = np.log((lam + 1) / 2.0) - np.log(np.arange(1, mu + 1))
    weights = w_raw / np.sum(w_raw)
    mu_eff = float(1.0 / np.sum(weights**2))
    cc = (4 + mu_eff / n) / (n + 4 + 2 * mu_eff / n)
    cs = (mu_eff + 2) / (n + mu_eff + 5)
    c1 = 2 / ((n + 1.3) ** 2 + mu_eff)
    cmu = min(1 - c1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((n + 2) ** 2 + mu_eff))
    damps = 1 + 2 * max(0.0, math.sqrt((mu_eff - 1) / (n + 1)) - 1) + cs
    chi_n = math.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
    return lam, mu, weights, mu_eff, cc, cs, c1, cmu, damps, chi_n


def _lift(state: CMAESState) -> CMAESState:
    """One instance's state as a batch of one lane."""
    return CMAESState(*(f[None] for f in state))


def _drop(state: CMAESState) -> CMAESState:
    return CMAESState(*(f[0] for f in state))


def init(fn: Objective, x0: torch.Tensor, config: CMAESConfig, *, data=None) -> CMAESState:
    """The state of every lane of ``x0 [B, n]``, or of one instance from
    ``x0 [n]`` (every field without the lane axis)."""
    if x0.ndim == 1:
        return _drop(init(fn, x0[None], config,
                          data=_each(data, lambda d: torch.as_tensor(d)[None])))
    B, n = x0.shape
    kw = {"dtype": x0.dtype, "device": x0.device}
    i32 = torch.int32
    return CMAESState(
        mean=x0,
        sigma=torch.full((B,), config.sigma0, **kw),
        C=torch.eye(n, **kw).expand(B, n, n).clone(),
        p_sigma=torch.zeros_like(x0),
        p_c=torch.zeros_like(x0),
        best_x=x0,
        best_value=as_lanes(fn, data).values(x0),
        prev_best=torch.full((B,), float("inf"), **kw),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, 1, i32),
        no_change=lane_full(x0, 0, i32),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def eigh_lanes(C: torch.Tensor, method: str):
    """``C [B, n, n] = V diag(w) V^T`` of every lane: ``(w [B, n] ascending,
    V [B, n, n])``.  ``"jacobi"`` is the parallel-order Jacobi on the batch
    (the JAX package's ``vmap`` of it: the same operations lane by lane);
    anything else the library's ``torch.linalg.eigh``, in pieces of
    ``eigh_qr.LIBRARY_EIGH_MAX_BATCH`` matrices."""
    if method == "jacobi":
        from ..linalg.jacobi import eigh_jacobi

        w, V = eigh_jacobi(C.permute(1, 2, 0))
        return w.T, V.permute(2, 0, 1)
    from ..linalg.eigh_qr import eigh_library_batched

    return tuple(eigh_library_batched(C))


def step(
    fn: Objective,
    state: CMAESState,
    config: CMAESConfig,
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
    data=None,
) -> CMAESState:
    """One generation of every lane.  ``z [B, lambda, n]`` are its
    standard normal draws (``[lambda, n]`` for one instance's state);
    left out, they come from ``generator`` on the state's device.  The
    lanes that are or become done keep their state."""
    if state.mean.ndim == 1:
        return _drop(step(fn, _lift(state), config, bounds, generator=generator,
                          z=None if z is None else z[None],
                          data=_each(data, lambda d: torch.as_tensor(d)[None])))
    lanes = as_lanes(fn, data)
    B, n = state.mean.shape
    dtype, dev = state.mean.dtype, state.mean.device
    lam, mu, weights, mu_eff, cc, cs, c1, cmu, damps, chi_n = _params(n, config.pop_size)
    weights = torch.as_tensor(weights, dtype=dtype, device=dev)

    # eigendecomposition C = B D^2 B^T
    eigvals, Bm = eigh_lanes(state.C, config.eigh_method)
    eigvals = eigvals.clamp_min(1e-20)
    D = torch.sqrt(eigvals)
    cond = eigvals[:, -1] / eigvals[:, 0]

    improved = state.best_value < state.prev_best - config.f_tol
    no_change = torch.where(improved, torch.zeros_like(state.no_change), state.no_change + 1)
    hit_tol = no_change >= config.best_value_no_change
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | (cond > config.cond_max)
        | (state.sigma < 1e-18)
    )
    halted = state._replace(
        no_change=no_change, done=torch.ones_like(state.done), converged=hit_tol
    )

    if z is None:
        z = torch.randn((B, lam, n), generator=generator, dtype=dtype, device=dev)
    BmT = Bm.transpose(-1, -2)
    sigma = state.sigma[:, None, None]
    y = (z * D[:, None, :]) @ BmT                            # ~ N(0, C)
    xs = state.mean[:, None, :] + sigma * y
    if bounds is not None:
        # projection repair: clamp into the box and let the repaired steps
        # drive every update (the mean stays feasible: it is a convex
        # combination of repaired candidates)
        lower, upper, _ = resolve_bounds(bounds, state.mean)
        xs = torch.minimum(torch.maximum(xs, lower[:, None]), upper[:, None])
        y = (xs - state.mean[:, None, :]) / sigma
    values = lanes.points(xs)                                # [B, lam]

    order = torch.argsort(values, dim=1, stable=True)
    y_top = gather_rows(y, order[:, :mu])                    # [B, mu, n]
    y_w = weights @ y_top                                    # [B, n] weighted step
    new_mean = state.mean + state.sigma[:, None] * y_w

    # step-size path: C^{-1/2} y_w = B D^-1 B^T y_w
    c_inv_sqrt_yw = matvec(Bm, matvec(BmT, y_w) / D)
    p_sigma = (1 - cs) * state.p_sigma + math.sqrt(cs * (2 - cs) * mu_eff) * c_inv_sqrt_yw
    ps_norm = torch.linalg.norm(p_sigma, dim=-1)
    new_sigma = state.sigma * torch.exp((cs / damps) * (ps_norm / chi_n - 1))
    if config.kick_tol > 0:
        ranked = gather_lanes(values, order[:, 0]), gather_lanes(values, order[:, mu - 1])
        collapsed = ((ranked[0] - ranked[1]).abs() < config.kick_tol) & (
            no_change >= config.kick_patience)
        new_sigma = torch.where(collapsed, new_sigma * math.exp(0.2 + cs / damps), new_sigma)

    # covariance path + rank-1 / rank-mu update
    hsig = (
        ps_norm / torch.sqrt(1 - (1 - cs) ** (2 * (state.iteration.to(dtype) + 1))) / chi_n
    ) < (1.4 + 2 / (n + 1))
    hsig = hsig.to(dtype)   # a bool times a Python float would drop to float32
    p_c = (1 - cc) * state.p_c + (hsig * math.sqrt(cc * (2 - cc) * mu_eff))[:, None] * y_w
    rank1 = p_c[:, :, None] * p_c[:, None, :]
    rank_mu = (y_top * weights[:, None]).transpose(-1, -2) @ y_top
    delta_hsig = ((1 - hsig) * cc * (2 - cc))[:, None, None]
    C = (1 - c1 - cmu) * state.C + c1 * (rank1 + delta_hsig * state.C) + cmu * rank_mu
    C = (C + C.transpose(-1, -2)) / 2

    gen_best = gather_lanes(values, order[:, 0])
    better = gen_best < state.best_value
    best_x = torch.where(better[:, None], gather_lanes(xs, order[:, 0]), state.best_x)
    best_value = torch.where(better, gen_best, state.best_value)

    worked = CMAESState(
        mean=new_mean,
        sigma=new_sigma,
        C=C,
        p_sigma=p_sigma,
        p_c=p_c,
        best_x=best_x,
        best_value=best_value,
        prev_best=state.best_value,
        iteration=state.iteration + 1,
        nfev=state.nfev + lam,
        no_change=no_change,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    return where_lanes(done_now, halted, worked)


# generations between two reads of done.all()
CHECK_EVERY = 16


def _run(lanes: Lanes, x0: torch.Tensor, config: CMAESConfig, _minimize: bool, bounds, draws,
         generator) -> SolverResult:
    if draws is None and generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    draws = draws_on(draws, x0.device)
    if bounds is not None:
        lower, upper, _ = resolve_bounds(bounds, x0)
        x0 = torch.minimum(torch.maximum(x0, lower), upper)
    state = init(lanes, x0, config)

    def advance(s):
        z = None if draws is None else step_rows(draws.steps, s.iteration)
        return step(lanes, s, config, bounds, generator=generator, z=z)

    state = drive(advance, state, check_every=CHECK_EVERY)
    return lane_result(state.best_x, state.best_value, state, not _minimize)


def minimize_batched(fn: Objective, x0: torch.Tensor, config: CMAESConfig = CMAESConfig(),
                     bounds: Optional[Bounds] = None, *, draws: Optional[Draws] = None,
                     generator: Optional[torch.Generator] = None, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]`` (``jax.vmap`` of the JAX ``minimize``):
    ``core.drive`` with the lanes frozen when done; ``bounds`` broadcast
    against ``x0``.  The draws come from ``draws`` (``Draws(None, z of
    [T, B, lambda, n])``, lane b reading row ``iteration[b]``) or from
    ``generator`` (on ``x0``'s device, seed 0 by default)."""
    return run_batched(_run, fn, x0, config, data, _minimize, bounds, draws, generator)


def minimize(
    fn: Objective,
    x0: torch.Tensor,
    config: CMAESConfig = CMAESConfig(),
    bounds: Optional[Bounds] = None,
    *,
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
    data=None,
    _minimize: bool = True,
) -> SolverResult:
    """Minimize one instance from ``x0 [n]``: the lane engine at B = 1,
    squeezed; ``generator`` (on ``x0``'s device) takes the place of the
    JAX package's ``key`` and defaults to seed 0, ``draws`` is a run's
    ``z`` without the lane axis."""
    return run_single(_run, fn, x0, config, data, _minimize, bounds, one_lane(draws), generator)


def maximize(fn, x0, config: CMAESConfig = CMAESConfig(), bounds=None, *, draws=None,
             generator=None, data=None):
    return minimize(fn, x0, config, bounds, draws=draws, generator=generator, data=data,
                    _minimize=False)


def minimize_ipop(
    fn: Objective,
    x0: torch.Tensor,
    config: CMAESConfig = CMAESConfig(),
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    max_restarts: int = 4,
    pop_mult: float = 2.0,
) -> SolverResult:
    """IPOP-CMA-ES: restart with an INCREASING population (Auger & Hansen
    2005).  Each restart multiplies lambda by ``pop_mult`` and starts anew
    from a fresh draw: inside the box, or a perturbation of ``x0``.  The
    returned result carries the best stage's solution with counters SUMMED
    across every stage (``solver_status.add`` semantics,
    nlsolver.h:2084-2091).  ``max_restarts=0`` is plain CMA-ES.
    """
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    n = x0.shape[-1]
    lam0 = config.pop_size if config.pop_size > 0 else 4 + int(3 * math.log(n))
    kw = {"generator": generator, "dtype": x0.dtype, "device": x0.device}

    best: Optional[SolverResult] = None
    for stage in range(max_restarts + 1):
        lam = max(int(round(lam0 * pop_mult**stage)), lam0 + stage)
        cfg = dataclasses.replace(config, pop_size=lam)
        if stage == 0:
            start = x0
        elif bounds is not None:
            lo = torch.as_tensor(bounds.lower, dtype=x0.dtype, device=x0.device).expand_as(x0)
            hi = torch.as_tensor(bounds.upper, dtype=x0.dtype, device=x0.device).expand_as(x0)
            start = lo + (hi - lo) * torch.rand(x0.shape, **kw)
        else:
            start = x0 + 2.0 * config.sigma0 * torch.randn(x0.shape, **kw)
        res = minimize(fn, start, cfg, bounds, generator=generator)
        if best is None:
            best = res
            continue
        # a NaN stage must never stick: any finite result beats NaN
        keep_new = (res.f_value < best.f_value) | (
            torch.isnan(best.f_value) & ~torch.isnan(res.f_value)
        )
        merged = SolverResult(*(torch.where(keep_new, new, old) for new, old in zip(res, best)))
        # counters accumulate across stages regardless of the winner
        best = merged._replace(
            iterations=best.iterations + res.iterations,
            function_calls=best.function_calls + res.function_calls,
            gradient_calls=best.gradient_calls + res.gradient_calls,
            hessian_calls=best.hessian_calls + res.hessian_calls,
        )
    return best
