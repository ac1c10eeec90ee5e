"""Brent's 1-D minimizer (golden section and successive parabolic
interpolation) on lane tensors (counterpart of
``nlsolver_tpu.solvers.brent``; the reference's ``Brent``,
nlsolver.h:3287-3427, itself R's ``Brent_fmin``).  Same defaults: bracket
[-5, 5], tol = eps = 1e-12, max_iter = 200.

The JAX minimizer is a scalar ``lax.while_loop`` that users ``vmap`` over
a batch of 1-D functions.  Here it runs on lane tensors as the root
finders do (``solvers.rootfind``): ``fn`` maps a lane tensor to a lane
tensor elementwise, the bracket is the config's Python floats for every
lane, and a host loop runs the trips with the lanes that are done frozen.
``like`` gives the lanes' shape, dtype and device: a 0-d tensor is one
function, ``[B]`` a batch of B; without it one 0-d lane on the card, in
the default dtype (JAX: ``result_type(lower, upper, float)``).

The reference swaps its outputs (it stores the function value in the
caller's x, nlsolver.h:3424-3425); here, as in the JAX package, ``x`` is
the minimizer and ``f_value`` the objective there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core import SolverResult, drive, make_result, start_points


@dataclass(frozen=True)
class BrentConfig:
    tol: float = 1e-12
    eps: float = 1e-12
    max_iter: int = 200
    lower: float = -5.0
    upper: float = 5.0


GOLDEN_C = (3.0 - math.sqrt(5.0)) * 0.5  # squared inverse golden ratio

# trips between two reads of done.all()
CHECK_EVERY = 4


class _S(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    x: torch.Tensor
    fv: torch.Tensor
    fw: torch.Tensor
    fx: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


def _lane_like(like) -> torch.Tensor:
    if like is None:
        return start_points(0.0, "like").to(torch.get_default_dtype())
    like = start_points(like, "like")
    return like if like.is_floating_point() else like.to(torch.get_default_dtype())


def minimize_scalar(fn, config: BrentConfig = BrentConfig(), *, like=None,
                    _minimize: bool = True) -> SolverResult:
    """Minimize ``fn`` on [lower, upper] in every lane of ``like``."""
    sfn = fn if _minimize else (lambda t: -fn(t))
    like = _lane_like(like)
    dtype, dev, shape = like.dtype, like.device, like.shape
    tol, eps = config.tol, config.eps
    tol3 = tol / 3.0

    def full(value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=dev)

    a, b = full(config.lower), full(config.upper)
    v = a + GOLDEN_C * (b - a)
    fx0 = sfn(v)
    if fx0.shape != v.shape:
        raise ValueError(f"fn must map a lane tensor elementwise: {tuple(v.shape)} gave "
                         f"{tuple(fx0.shape)}")
    zero, one = full(0.0), full(1.0)
    i32 = torch.int32
    init = _S(a, b, zero, zero, v, v, v, fx0, fx0, fx0, full(0, i32), full(1, i32),
              full(False, torch.bool), full(False, torch.bool))
    where = torch.where

    def body(s: _S) -> _S:
        xm = (s.a + s.b) * 0.5
        tol1 = eps * s.x.abs() + tol3
        t2 = tol1 * 2.0
        stop = (s.x - xm).abs() <= t2 - (s.b - s.a) * 0.5
        exhausted = s.it >= config.max_iter

        # parabola fit (nlsolver.h:3354-3366)
        fit = s.e.abs() > tol1
        r = where(fit, (s.x - s.w) * (s.fx - s.fv), zero)
        q = where(fit, (s.x - s.v) * (s.fx - s.fw), zero)
        p = where(fit, (s.x - s.v) * q - (s.x - s.w) * r, zero)
        q = (q - r) * 2.0
        p = where(q > 0.0, -p, p)
        q = where(q > 0.0, q, -q)
        r_new = s.e
        e_after_fit = where(fit, s.d, s.e)

        golden = ((p.abs() >= (q * 0.5 * r_new).abs())
                  | (p <= q * (s.a - s.x))
                  | (p >= q * (s.b - s.x)))
        e_gold = where(s.x < xm, s.b - s.x, s.a - s.x)
        d_gold = GOLDEN_C * e_gold

        q_safe = where(q == 0.0, one, q)
        d_par = p / q_safe
        u_par = s.x + d_par
        too_close_ends = ((u_par - s.a) < t2) | ((s.b - u_par) < t2)
        d_par = where(too_close_ends, where(s.x >= xm, -tol1, tol1), d_par)

        d = where(golden, d_gold, d_par)
        e = where(golden, e_gold, e_after_fit)

        u = where(d.abs() >= tol1, s.x + d, where(d > 0.0, s.x + tol1, s.x - tol1))
        fu = sfn(u)
        nfev = s.nfev + 1

        better = fu <= s.fx
        # update a, b, v, w, x (nlsolver.h:3396-3422)
        a2 = where(better, where(u < s.x, s.a, s.x), where(u < s.x, u, s.a))
        b2 = where(better, where(u < s.x, s.x, s.b), where(u < s.x, s.b, u))
        near_w = (fu <= s.fw) | (s.w == s.x)
        near_v = (fu <= s.fv) | (s.v == s.x) | (s.v == s.w)
        v2 = where(better, s.w, where(near_w, s.w, where(near_v, u, s.v)))
        fv2 = where(better, s.fw, where(near_w, s.fw, where(near_v, fu, s.fv)))
        w2 = where(better, s.x, where(near_w, u, s.w))
        fw2 = where(better, s.fx, where(near_w, fu, s.fw))
        x2 = where(better, u, s.x)
        fx2 = where(better, fu, s.fx)

        halt = stop | exhausted

        def keep(old, new):
            return where(halt, old, new)

        return _S(keep(s.a, a2), keep(s.b, b2), keep(s.d, d), keep(s.e, e),
                  keep(s.v, v2), keep(s.w, w2), keep(s.x, x2),
                  keep(s.fv, fv2), keep(s.fw, fw2), keep(s.fx, fx2),
                  where(halt, s.it, s.it + 1), where(halt, s.nfev, nfev), halt, stop)

    final = drive(body, init, check_every=CHECK_EVERY)
    f_val = final.fx
    none = torch.zeros_like(final.it)
    return make_result(
        x=final.x,
        f_value=-f_val if not _minimize else f_val,
        iterations=final.it,
        function_calls=final.nfev,
        gradient_calls=none,
        hessian_calls=none,
        converged=final.converged,
    )


def _config(config: BrentConfig, bounds) -> BrentConfig:
    if bounds is None:
        return config
    return BrentConfig(tol=config.tol, eps=config.eps, max_iter=config.max_iter,
                       lower=float(bounds.lower), upper=float(bounds.upper))


def _lanes_of(x0):
    """A start point ``[n]`` is one function (0-d lanes); ``[B, n]`` is a
    batch of B."""
    if x0 is None:
        return None
    x0 = start_points(x0)
    return x0[..., 0] if x0.ndim >= 1 else x0


def minimize(fn, x0=None, config: BrentConfig = BrentConfig(), bounds=None, *,
             _minimize: bool = True) -> SolverResult:
    """Solver-module interface, the reference's (x, lower, upper) call
    shape: the bracket comes from ``config`` (or ``bounds``, as Python
    floats) and ``x0`` gives only the lanes (its leading axes), the dtype
    and the device."""
    return minimize_scalar(fn, _config(config, bounds), like=_lanes_of(x0), _minimize=_minimize)


def maximize(fn, x0=None, config: BrentConfig = BrentConfig(), bounds=None) -> SolverResult:
    return minimize(fn, x0, config, bounds, _minimize=False)


def minimize_batched(fn, x0, config: BrentConfig = BrentConfig(), bounds=None, *,
                     _minimize: bool = True) -> SolverResult:
    """A batch of 1-D functions: ``fn`` maps ``[B]`` to ``[B]`` and
    ``x0 [B, n]`` gives the lanes."""
    x0 = start_points(x0)
    if x0.ndim != 2:
        raise ValueError(f"a batch of start points is [B, n], got {tuple(x0.shape)}")
    return minimize(fn, x0, config, bounds, _minimize=_minimize)
