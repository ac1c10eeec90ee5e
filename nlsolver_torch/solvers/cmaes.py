"""CMA-ES (covariance matrix adaptation evolution strategy), one instance
(counterpart of ``nlsolver_tpu.solvers.cmaes``).

The standard algorithm (Hansen, "The CMA Evolution Strategy: A Tutorial",
arXiv:1604.00772): the population is one ``[lambda, n]`` matrix; default
hyperparameters follow the tutorial (lambda = 4 + 3 ln n, mu = lambda/2
with log-weights, standard cc/cs/c1/cmu/damps).  The eigendecomposition
C = B diag(D^2) B^T is ``torch.linalg.eigh`` (``eigh_method="xla"``, the
JAX package's name for the library call) or the parallel-order Jacobi.
For many instances at once use ``solvers.cmaes_fleet``, which shares
``_params`` with this module.

Termination: max_iter, stagnation of the best value, condition-number
explosion, or step-size collapse (nlsolver.h:4566-4574).  Bounds are
honored by projection repair: sampled candidates are clamped into the box
before evaluation and the *repaired* step feeds the mean / path /
covariance updates.  Restart variance kick (nlsolver.h:4566-4568): when the
top-mu costs collapse within ``kick_tol`` after ``kick_patience``
stagnant generations, sigma is multiplied by ``exp(0.2 + cs/damps)``.

Randomness is an input: ``step`` takes the generation's normal draws
``z [lambda, n]`` or makes them from a ``torch.Generator``; the state has
no key.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import (Bounds, Objective, SolverResult, batch_eval, clamp, drive, make_result,
                    signed, where_lanes)


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
    mean: torch.Tensor          # [n]
    sigma: torch.Tensor
    C: torch.Tensor             # [n, n] covariance
    p_sigma: torch.Tensor       # [n] step-size path
    p_c: torch.Tensor           # [n] covariance path
    best_x: torch.Tensor
    best_value: torch.Tensor
    prev_best: torch.Tensor
    iteration: torch.Tensor
    nfev: torch.Tensor
    no_change: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


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


def init(fn: Objective, x0: torch.Tensor, config: CMAESConfig) -> CMAESState:
    n = x0.shape[-1]
    kw = {"dtype": x0.dtype, "device": x0.device}
    ikw = {"dtype": torch.int32, "device": x0.device}
    return CMAESState(
        mean=x0,
        sigma=torch.tensor(config.sigma0, **kw),
        C=torch.eye(n, **kw),
        p_sigma=torch.zeros(n, **kw),
        p_c=torch.zeros(n, **kw),
        best_x=x0,
        best_value=fn(x0),
        prev_best=torch.tensor(float("inf"), **kw),
        iteration=torch.tensor(0, **ikw),
        nfev=torch.tensor(1, **ikw),
        no_change=torch.tensor(0, **ikw),
        done=torch.tensor(False, device=x0.device),
        converged=torch.tensor(False, device=x0.device),
    )


def step(
    fn: Objective,
    state: CMAESState,
    config: CMAESConfig,
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
) -> CMAESState:
    """One generation.  ``z [lambda, n]`` are its standard normal draws;
    left out, they come from ``generator`` on the state's device."""
    n = state.mean.shape[-1]
    dtype, dev = state.mean.dtype, state.mean.device
    lam, mu, weights, mu_eff, cc, cs, c1, cmu, damps, chi_n = _params(n, config.pop_size)
    weights = torch.as_tensor(weights, dtype=dtype, device=dev)

    # eigendecomposition C = B D^2 B^T
    if config.eigh_method == "jacobi":
        from ..linalg.jacobi import eigh_jacobi

        eigvals, Bm = eigh_jacobi(state.C)
    else:
        eigvals, Bm = torch.linalg.eigh(state.C)
    eigvals = eigvals.clamp_min(1e-20)
    D = torch.sqrt(eigvals)
    cond = eigvals[-1] / eigvals[0]

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
        z = torch.randn((lam, n), generator=generator, dtype=dtype, device=dev)
    y = (z * D[None, :]) @ Bm.T                            # ~ N(0, C)
    xs = state.mean[None, :] + state.sigma * y
    if bounds is not None:
        # projection repair: clamp into the box and let the repaired steps
        # drive every update (the mean stays feasible: it is a convex
        # combination of repaired candidates)
        xs = clamp(xs, bounds.lower, bounds.upper)
        y = (xs - state.mean[None, :]) / state.sigma
    values = batch_eval(fn, xs)

    order = torch.argsort(values, stable=True)
    top = order[:mu]
    y_w = weights @ y[top]                                 # [n] weighted step
    new_mean = state.mean + state.sigma * y_w

    # step-size path: C^{-1/2} y_w = B D^-1 B^T y_w
    c_inv_sqrt_yw = Bm @ ((Bm.T @ y_w) / D)
    p_sigma = (1 - cs) * state.p_sigma + math.sqrt(cs * (2 - cs) * mu_eff) * c_inv_sqrt_yw
    ps_norm = torch.linalg.norm(p_sigma)
    sigma = state.sigma * torch.exp((cs / damps) * (ps_norm / chi_n - 1))
    if config.kick_tol > 0:
        collapsed = (
            (values[order[0]] - values[order[mu - 1]]).abs() < config.kick_tol
        ) & (no_change >= config.kick_patience)
        sigma = torch.where(collapsed, sigma * math.exp(0.2 + cs / damps), sigma)

    # covariance path + rank-1 / rank-mu update
    hsig = (
        ps_norm / torch.sqrt(1 - (1 - cs) ** (2 * (state.iteration.to(dtype) + 1))) / chi_n
    ) < (1.4 + 2 / (n + 1))
    hsig = hsig.to(dtype)   # a bool times a Python float would drop to float32
    p_c = (1 - cc) * state.p_c + hsig * math.sqrt(cc * (2 - cc) * mu_eff) * y_w
    rank1 = torch.outer(p_c, p_c)
    rank_mu = (y[top] * weights[:, None]).T @ y[top]
    delta_hsig = (1 - hsig) * cc * (2 - cc)
    C = (1 - c1 - cmu) * state.C + c1 * (rank1 + delta_hsig * state.C) + cmu * rank_mu
    C = (C + C.T) / 2

    gen_best = values[order[0]]
    better = gen_best < state.best_value
    best_x = torch.where(better, xs[order[0]], state.best_x)
    best_value = torch.where(better, gen_best, state.best_value)

    worked = CMAESState(
        mean=new_mean,
        sigma=sigma,
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


def _finalize(state: CMAESState, flip_sign: bool) -> SolverResult:
    f_val = state.best_value
    return make_result(
        x=state.best_x,
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )


def minimize(
    fn: Objective,
    x0: torch.Tensor,
    config: CMAESConfig = CMAESConfig(),
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    _minimize: bool = True,
) -> SolverResult:
    """Minimize one instance from ``x0 [n]``; ``generator`` (on ``x0``'s
    device) takes the place of the JAX package's ``key`` and defaults to
    seed 0."""
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    sfn = signed(fn, _minimize)
    if bounds is not None:
        x0 = clamp(x0, bounds.lower, bounds.upper)
    state = init(sfn, x0, config)
    state = drive(lambda s: step(sfn, s, config, bounds, generator=generator), state)
    return _finalize(state, flip_sign=not _minimize)


def maximize(fn, x0, config: CMAESConfig = CMAESConfig(), bounds=None, *, generator=None):
    return minimize(fn, x0, config, bounds, generator=generator, _minimize=False)


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
