"""More-Thuente strong-Wolfe line search (counterpart of
``nlsolver_tpu.linesearch.more_thuente``).

The reference's MINPACK-style ``cvsrch``/``cstep`` (nlsolver.h:1527-1793)
with the same constants (xtol=1e-15, ftol=1e-4, gtol=1e-2, stpmin=1e-15,
stpmax=1e15, xtrapf=4, maxfev=20; nlsolver.h:1682-1688).  ``cstep``
computes all four trial steps and selects by case: elementwise selects
only, so one call serves a scalar search and a fleet of ``[B]`` searches
alike.  Each trial evaluates both f and the gradient (nlsolver.h:1740-1741),
so ``nfev`` counts one of each per trial.

The JAX package runs the recurrence in a ``lax.while_loop``; here it is a
host loop of at most ``MAXFEV`` trips.  ``more_thuente_fleet`` reads
``any(info == 0)`` from the device after every trip and so runs exactly the
reference's trips: a trip is some 200 eager ops plus two evaluations, far
more than a read costs (on an H100 the 65536-bowl fleet ran level with a
read every second trip and 7-9 times slower with none; PERF.md).  Lanes
that carry an info code are frozen and ``nfev`` counts active lanes only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

XTOL = 1e-15
FTOL = 1e-4
GTOL = 1e-2
STPMIN = 1e-15
STPMAX = 1e15
XTRAPF = 4.0
MAXFEV = 20


def _max_abs3(x, y, z):
    return torch.maximum(x.abs(), torch.maximum(y.abs(), z.abs()))


def _clip(x, lo, hi):
    """``min(max(x, lo), hi)``, also where ``lo > hi`` (``jnp.clip``)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def cstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax):
    """One MINPACK cstep trial-step update (nlsolver.h:1528-1671).

    Returns (stx, fx, dx, sty, fy, dy, stp, brackt, ok).
    """
    where = torch.where
    err = (
        (brackt & ((stp <= torch.minimum(stx, sty)) | (stp >= torch.maximum(stx, sty))))
        | (dx * (stp - stx) >= 0.0)
        | (stpmax < stpmin)
    )

    sgnd = dp * torch.sign(dx)

    case1 = fp > fx
    case2 = (~case1) & (sgnd < 0.0)
    case3 = (~case1) & (~case2) & (dp.abs() < dx.abs())
    # case4 = otherwise

    d_stp_stx = where(stp == stx, 1.0, stp - stx)  # guard inactive divides

    theta = 3.0 * (fx - fp) / d_stp_stx + dx + dp
    s = _max_abs3(theta, dx, dp)
    s = where(s == 0.0, 1.0, s)
    gamma_base = s * torch.sqrt(
        torch.clamp((theta / s) ** 2 - (dx / s) * (dp / s), min=0.0)
    )

    # --- case 1: higher function value (bracketing, bound) ---
    g1 = where(stp < stx, -gamma_base, gamma_base)
    p1 = (g1 - dx) + theta
    q1 = ((g1 - dx) + g1) + dp
    q1 = where(q1 == 0.0, 1.0, q1)
    stpc1 = stx + (p1 / q1) * (stp - stx)
    den1 = (fx - fp) / d_stp_stx + dx
    den1 = where(den1 == 0.0, 1.0, den1)
    stpq1 = stx + ((dx / den1) / 2.0) * (stp - stx)
    stpf1 = where(
        (stpc1 - stx).abs() < (stpq1 - stx).abs(),
        stpc1,
        stpc1 + (stpq1 - stpc1) / 2.0,
    )

    # --- case 2: lower value, derivative sign change (bracketing) ---
    g2 = where(stp > stx, -gamma_base, gamma_base)
    p2 = (g2 - dp) + theta
    q2 = ((g2 - dp) + g2) + dx
    q2 = where(q2 == 0.0, 1.0, q2)
    stpc2 = stp + (p2 / q2) * (stx - stp)
    dpdx = where(dp == dx, 1.0, dp - dx)
    stpq2 = stp + (dp / dpdx) * (stx - stp)
    stpf2 = where((stpc2 - stp).abs() > (stpq2 - stp).abs(), stpc2, stpq2)

    # --- case 3: derivative decreases in magnitude (bound) ---
    g3 = where(stp > stx, -gamma_base, gamma_base)
    p3 = (g3 - dp) + theta
    q3 = (g3 + (dx - dp)) + g3
    q3 = where(q3 == 0.0, 1.0, q3)
    r3 = p3 / q3
    stpc3 = where(
        (r3 < 0.0) & (g3 != 0.0),
        stp + r3 * (stx - stp),
        where(stp > stx, stpmax, stpmin),
    )
    stpq3 = stp + (dp / dpdx) * (stx - stp)
    stpf3 = where(
        brackt,
        where((stp - stpc3).abs() < (stp - stpq3).abs(), stpc3, stpq3),
        where((stp - stpc3).abs() > (stp - stpq3).abs(), stpc3, stpq3),
    )

    # --- case 4: derivative does not decrease ---
    d_sty_stp = where(sty == stp, 1.0, sty - stp)
    theta4 = 3.0 * (fp - fy) / d_sty_stp + dy + dp
    s4 = _max_abs3(theta4, dy, dp)
    s4 = where(s4 == 0.0, 1.0, s4)
    g4 = s4 * torch.sqrt(
        torch.clamp((theta4 / s4) ** 2 - (dy / s4) * (dp / s4), min=0.0)
    )
    g4 = where(stp > sty, -g4, g4)
    p4 = (g4 - dp) + theta4
    q4 = ((g4 - dp) + g4) + dy
    q4 = where(q4 == 0.0, 1.0, q4)
    stpc4 = stp + (p4 / q4) * (sty - stp)
    stpf4 = where(brackt, stpc4, where(stp > stx, stpmax, stpmin))

    stpf = where(case1, stpf1, where(case2, stpf2, where(case3, stpf3, stpf4)))
    bound = case1 | case3
    new_brackt = brackt | case1 | case2

    # interval endpoint update (nlsolver.h:1642-1656)
    take_y_from_p = fp > fx
    swap_x_to_y = (~take_y_from_p) & (sgnd < 0.0)
    n_sty = where(take_y_from_p, stp, where(swap_x_to_y, stx, sty))
    n_fy = where(take_y_from_p, fp, where(swap_x_to_y, fx, fy))
    n_dy = where(take_y_from_p, dp, where(swap_x_to_y, dx, dy))
    n_stx = where(take_y_from_p, stx, stp)
    n_fx = where(take_y_from_p, fx, fp)
    n_dx = where(take_y_from_p, dx, dp)

    stpf = _clip(stpf, stpmin, stpmax)
    n_stp = stpf
    # safeguard toward the bracket interior (nlsolver.h:1661-1669)
    guard = new_brackt & bound
    interior = n_stx + 0.66 * (n_sty - n_stx)
    n_stp = where(
        guard,
        where(n_sty > n_stx, torch.minimum(interior, n_stp), torch.maximum(interior, n_stp)),
        n_stp,
    )

    # on input error the reference leaves everything untouched (returns -1)
    def keep(old, new):
        return where(err, old, new)

    return (
        keep(stx, n_stx),
        keep(fx, n_fx),
        keep(dx, n_dx),
        keep(sty, n_sty),
        keep(fy, n_fy),
        keep(dy, n_dy),
        keep(stp, n_stp),
        keep(brackt, new_brackt),
        ~err,
    )


class MTResult(NamedTuple):
    alpha: torch.Tensor
    nfev: torch.Tensor   # trials; each trial costs 1 f-eval and 1 grad-eval
    info: torch.Tensor   # MINPACK info code (1 = strong Wolfe satisfied)


class _State(NamedTuple):
    stp: torch.Tensor
    stx: torch.Tensor
    fx: torch.Tensor
    dgx: torch.Tensor
    sty: torch.Tensor
    fy: torch.Tensor
    dgy: torch.Tensor
    brackt: torch.Tensor
    stage1: torch.Tensor
    nfev: torch.Tensor
    width: torch.Tensor
    width1: torch.Tensor
    ok: torch.Tensor
    info: torch.Tensor


def _initial(alpha0, finit, dginit, w):
    """The recurrence's start; every argument has the search's shape
    (0-d for one instance, [B] for a fleet)."""
    zero = torch.zeros_like(finit)
    return _State(
        stp=alpha0,
        stx=zero,
        fx=finit,
        dgx=dginit,
        sty=zero,
        fy=finit,
        dgy=dginit,
        brackt=torch.zeros_like(finit, dtype=torch.bool),
        stage1=torch.ones_like(finit, dtype=torch.bool),
        nfev=torch.zeros_like(finit, dtype=torch.int32),
        width=w,
        width1=2 * w,
        ok=torch.ones_like(finit, dtype=torch.bool),
        info=torch.zeros_like(finit, dtype=torch.int32),
    )


def _trial_step(s: _State, stpmax):
    """The step this trip evaluates, with the interval it must lie in;
    ``stpmax`` is a tensor."""
    stmin = torch.where(s.brackt, torch.minimum(s.stx, s.sty), s.stx)
    stmax = torch.where(
        s.brackt, torch.maximum(s.stx, s.sty), s.stp + XTRAPF * (s.stp - s.stx)
    )
    stp = torch.minimum(torch.clamp(s.stp, min=STPMIN), stpmax)
    fallback = (
        (s.brackt & ((stp <= stmin) | (stp >= stmax)))
        | (s.nfev >= MAXFEV - 1)
        | (~s.ok)
        | (s.brackt & ((stmax - stmin) <= XTOL * stmax))
    )
    return torch.where(fallback, s.stx, stp), stmin, stmax


def _after_trial(s: _State, stp, stmin, stmax, fv, dg, nfev, finit, dginit, dgtest, stpmax):
    """The recurrence's state after the trial at ``stp`` gave ``fv`` and the
    directional derivative ``dg`` (nlsolver.h:1743-1790)."""
    where = torch.where
    ftest1 = finit + stp * dgtest

    info = torch.zeros_like(s.info)
    info = where((s.brackt & ((stp <= stmin) | (stp >= stmax))) | (~s.ok), 6, info)
    info = where((stp == stpmax) & (fv <= ftest1) & (dg <= dgtest), 5, info)
    info = where((stp == STPMIN) & ((fv > ftest1) | (dg >= dgtest)), 4, info)
    info = where(nfev >= MAXFEV, 3, info)
    info = where(s.brackt & ((stmax - stmin) <= XTOL * stmax), 2, info)
    info = where((fv <= ftest1) & (dg.abs() <= GTOL * (-dginit)), 1, info)

    stage1 = s.stage1 & ~((fv <= ftest1) & (dg >= min(FTOL, GTOL) * dginit))
    use_mod = stage1 & (fv <= s.fx) & (fv > ftest1)

    # modified function values (nlsolver.h:1763-1777)
    fm = where(use_mod, fv - stp * dgtest, fv)
    fxm = where(use_mod, s.fx - s.stx * dgtest, s.fx)
    fym = where(use_mod, s.fy - s.sty * dgtest, s.fy)
    dgm = where(use_mod, dg - dgtest, dg)
    dgxm = where(use_mod, s.dgx - dgtest, s.dgx)
    dgym = where(use_mod, s.dgy - dgtest, s.dgy)

    stx2, fx2, dgx2, sty2, fy2, dgy2, stp2, brackt2, ok2 = cstep(
        s.stx, fxm, dgxm, s.sty, fym, dgym, stp, fm, dgm, s.brackt, stmin, stmax
    )

    fx3 = where(use_mod, fx2 + stx2 * dgtest, fx2)
    fy3 = where(use_mod, fy2 + sty2 * dgtest, fy2)
    dgx3 = where(use_mod, dgx2 + dgtest, dgx2)
    dgy3 = where(use_mod, dgy2 + dgtest, dgy2)

    # forced bisection when the bracket shrinks too slowly (:1784-1790)
    slow = brackt2 & ((sty2 - stx2).abs() >= 0.66 * s.width1)
    stp3 = where(slow, stx2 + 0.5 * (sty2 - stx2), stp2)
    width1 = where(brackt2, s.width, s.width1)
    width = where(brackt2, (sty2 - stx2).abs(), s.width)

    # when terminating, the caller's step is the stp just evaluated at
    return _State(
        stp=where(info != 0, stp, stp3),
        stx=stx2,
        fx=fx3,
        dgx=dgx3,
        sty=sty2,
        fy=fy3,
        dgy=dgy3,
        brackt=brackt2,
        stage1=stage1,
        nfev=nfev,
        width=width,
        width1=width1,
        ok=ok2,
        info=info,
    )


def _result(alpha0, dginit, final: _State) -> MTResult:
    # non-descent direction: the reference bails before any trial (:1693-1695)
    bad = dginit >= 0.0
    return MTResult(
        alpha=torch.where(bad, alpha0, final.stp),
        nfev=torch.where(bad, 0, final.nfev),
        info=torch.where(bad, -1, final.info),
    )


def more_thuente(fn, grad_fn, x, f0, g0, direction, alpha0, alpha_max=STPMAX) -> MTResult:
    """Strong-Wolfe search along ``direction`` from ``x``.

    fn/grad_fn: objective and gradient callables on [n] points.
    f0/g0: objective value and gradient at x.
    alpha_max: optional upper bound on the step, the MINPACK ``stpmax``
    argument the reference hard-codes to 1e15 (nlsolver.h:1686).
    Returns the accepted step alpha (the reference's cvsrch result
    semantics: the initial alpha when the initial slope is non-negative).
    """
    dtype, dev = x.dtype, x.device
    stpmax = torch.as_tensor(alpha_max, dtype=dtype, device=dev)
    alpha0 = torch.minimum(torch.as_tensor(alpha0, dtype=dtype, device=dev), stpmax)
    dginit = torch.dot(g0, direction)
    dgtest = FTOL * dginit
    s = _initial(alpha0, f0, dginit, stpmax - STPMIN)
    while int(s.info) == 0:
        stp, stmin, stmax = _trial_step(s, stpmax)
        xt = x + stp * direction
        fv, dg = fn(xt), torch.dot(grad_fn(xt), direction)
        s = _after_trial(s, stp, stmin, stmax, fv, dg, s.nfev + 1, f0, dginit, dgtest, stpmax)
    return _result(alpha0, dginit, s)


def more_thuente_fleet(fn_cols, grad_cols, X, f0, G0, D, alpha0, alpha_max=STPMAX) -> MTResult:
    """Batch-minor fleet variant of :func:`more_thuente`: one line search
    per LANE, the fleet on the trailing axis, so every scalar of the
    recurrence is a ``[B]`` vector and every point a column of ``X``.

    fn_cols:  ``[n, B] -> [B]`` objective on columns.
    grad_cols: ``[n, B] -> [n, B]`` gradients of each column.
    X ``[n, B]``, f0 ``[B]``, G0/D ``[n, B]``; alpha0 scalar or ``[B]``.
    alpha_max: the bound on each lane's step, scalar or ``[B]`` (the
    ``alpha_max`` of :func:`more_thuente`, with which L-BFGS-B stops each
    lane's search at its box).  Lane by lane this is :func:`more_thuente`
    under ``vmap``, the single-instance solvers' search on lane tensors.

    Lanes that carry an info code are frozen; the loop runs until every
    lane has one, which takes at most ``MAXFEV`` trips.
    """
    dtype, dev = X.dtype, X.device
    B = X.shape[-1]
    stpmax = torch.as_tensor(alpha_max, dtype=dtype, device=dev).expand(B)
    alpha0 = torch.minimum(torch.as_tensor(alpha0, dtype=dtype, device=dev).expand(B), stpmax)
    dginit = (G0 * D).sum(dim=0)                 # [B]
    dgtest = FTOL * dginit
    s = _initial(alpha0, f0, dginit, stpmax - STPMIN)
    for _ in range(MAXFEV):
        active = s.info == 0                     # [B]
        stp, stmin, stmax = _trial_step(s, stpmax)
        Xt = X + stp * D                         # [n, B] (stp broadcasts on lanes)
        fv, dg = fn_cols(Xt), (grad_cols(Xt) * D).sum(dim=0)
        new = _after_trial(s, stp, stmin, stmax, fv, dg, s.nfev + active.to(torch.int32),
                           f0, dginit, dgtest, stpmax)
        # freeze lanes that already carried an info code into this trip
        s = _State(*(torch.where(active, nw, old) for old, nw in zip(s, new)))
        if not bool((s.info == 0).any()):
            break
    return _result(alpha0, dginit, s)
