"""1-D root finders on lane tensors: bisection, false position, Brent,
Ridders, Tiruneh, ITP, Chandrupatla (counterpart of
``nlsolver_tpu.solvers.rootfind``, the reference's ``nlsolver::rootfinder``,
nlsolver.h:3923-4319).

The JAX finders are scalar ``lax.while_loop``s that users ``vmap`` over
batches of brackets.  ``torch.func.vmap`` cannot batch a loop whose trip
count depends on the data, so each finder here runs on lane tensors:

  * ``fn`` maps a lane tensor to a lane tensor elementwise;
  * ``lower`` and ``upper`` (tiruneh's ``x_k``) broadcast to the lane
    shape, and a 0-d bracket is one lane;
  * a host loop runs the trips: each trip computes the body for every lane,
    then selects the whole state back for every lane whose ``done`` was
    set when the trip began.  That is what a batched ``while_loop`` does,
    so ``iterations``, ``function_calls``, ``x`` and ``f_value`` equal the
    scalar run's lane by lane.  ``done.all()`` is read once every
    ``CHECK_EVERY`` trips; frozen lanes make the extra trips no-ops.

The dtype follows ``jnp.result_type(lower, upper, float)`` with x64 off: the
floating dtype of a tensor bracket, else the default dtype.  A bracket that
is no tensor goes to the CUDA card, and raises without one.  The finders
keep the JAX package's deliberate differences from the reference
(sign-aware updates, ``bracketed=False`` with NaN x for a bad bracket) and
its constants, which round in the bracket's dtype exactly as in JAX: in
float32 ridders' and chandrupatla's ``1e-300`` guards are 0.  A division by
a constant that is not a power of two divides by a 0-d tensor on the
lanes' device, as JAX divides: the card would multiply by the reciprocal.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core import drive, start_points, where_lanes

# host loop: trips between two reads of done.all(), as core.driver.drive
CHECK_EVERY = 4


class RootResult(NamedTuple):
    x: torch.Tensor
    f_value: torch.Tensor
    iterations: torch.Tensor      # int32
    function_calls: torch.Tensor  # int32
    converged: torch.Tensor
    bracketed: torch.Tensor       # the initial interval bracketed a root


def _lanes(*values, name="lower"):
    """``values`` as lane tensors of one floating dtype on one device,
    broadcast to one shape."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    floats = [t.dtype for t in tensors if t.is_floating_point()]
    dtype = functools.reduce(torch.promote_types, floats) if floats else torch.get_default_dtype()
    device = tensors[0].device if tensors else start_points(values[0], name).device
    out = [torch.as_tensor(v, dtype=dtype, device=device) for v in values]
    shape = torch.broadcast_shapes(*(t.shape for t in out))
    return [t.expand(shape) for t in out]


def _eval(fn, x):
    out = fn(x)
    if out.shape != x.shape:
        raise ValueError(
            f"fn must map a lane tensor elementwise: {tuple(x.shape)} gave {tuple(out.shape)}"
        )
    return out


def _counter(like, value):
    return torch.full(like.shape, value, dtype=torch.int32, device=like.device)


def _flag(like, value):
    return torch.full(like.shape, value, dtype=torch.bool, device=like.device)


def _not_bracketed(like) -> RootResult:
    nan = torch.full_like(like, float("nan"))
    return RootResult(nan, nan, _counter(like, 0), _counter(like, 2), _flag(like, False),
                      _flag(like, False))


def _merge(ok, res: RootResult) -> RootResult:
    return where_lanes(ok, res, _not_bracketed(res.x))


def _run(body, state):
    return drive(body, state, check_every=CHECK_EVERY)


class _Bisect(NamedTuple):
    a: torch.Tensor
    fa: torch.Tensor
    b: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    x: torch.Tensor
    val: torch.Tensor
    done: torch.Tensor


def bisection(fn, lower, upper, eps=1e-6, max_iter=200) -> RootResult:
    """nlsolver.h:3924-3962 (defaults lower=-100, upper=100 there)."""
    lower, upper = _lanes(lower, upper)
    a = torch.minimum(lower, upper)
    b = torch.maximum(lower, upper)
    fa = _eval(fn, a)
    fb = _eval(fn, b)
    ok = fa * fb < 0

    def body(s: _Bisect) -> _Bisect:
        mid = (s.a + s.b) / 2
        v = fn(mid)
        stop = (v.abs() < eps) | (s.it > max_iter)
        same_side = v * s.fa > 0
        new_a = torch.where(same_side, mid, s.a)
        new_fa = torch.where(same_side, v, s.fa)
        new_b = torch.where(same_side, s.b, mid)
        return _Bisect(
            torch.where(stop, s.a, new_a),
            torch.where(stop, s.fa, new_fa),
            torch.where(stop, s.b, new_b),
            torch.where(stop, s.it, s.it + 1),
            s.nfev + 1,
            mid,
            v,
            stop,
        )

    final = _run(body, _Bisect(a, fa, b, _counter(a, 0), _counter(a, 2), a, fa, ~ok))
    res = RootResult(final.x, final.val, final.it, final.nfev, final.val.abs() < eps,
                     _flag(a, True))
    return _merge(ok, res)


class _FalsePosition(NamedTuple):
    a: torch.Tensor
    fa: torch.Tensor
    b: torch.Tensor
    fb: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    x: torch.Tensor
    val: torch.Tensor
    done: torch.Tensor


def false_position(fn, lower, upper, eps=1e-6, max_iter=200, variant="fixed") -> RootResult:
    """Regula falsi (nlsolver.h:3963-4000).

    The default fixes two reference quirks; ``variant="reference"``
    reproduces them for trajectory parity: the upper bracket's value slot
    takes the midpoint COORDINATE (``val_b = mid``, nlsolver.h:3996), and
    the side test is ``val < 0`` (f assumed increasing through the root)."""
    a, b = _lanes(lower, upper)
    fa = _eval(fn, a)
    fb = _eval(fn, b)
    ok = fa * fb < 0
    reference = variant == "reference"

    def body(s: _FalsePosition) -> _FalsePosition:
        mid = s.a + ((s.b - s.a) * s.fa) / (s.fa - s.fb)
        v = fn(mid)
        stop = (v.abs() < eps) | (s.it > max_iter)
        same_side = v < 0 if reference else v * s.fa > 0
        new_a = torch.where(same_side, mid, s.a)
        new_fa = torch.where(same_side, v, s.fa)
        new_b = torch.where(same_side, s.b, mid)
        new_fb = torch.where(same_side, s.fb, mid if reference else v)
        return _FalsePosition(
            torch.where(stop, s.a, new_a),
            torch.where(stop, s.fa, new_fa),
            torch.where(stop, s.b, new_b),
            torch.where(stop, s.fb, new_fb),
            torch.where(stop, s.it, s.it + 1),
            s.nfev + 1,
            mid,
            v,
            stop,
        )

    final = _run(body, _FalsePosition(a, fa, b, fb, _counter(a, 0), _counter(a, 2), a, fa, ~ok))
    res = RootResult(final.x, final.val, final.it, final.nfev, final.val.abs() < eps,
                     _flag(a, True))
    return _merge(ok, res)


class _Brent(NamedTuple):
    a: torch.Tensor
    fa: torch.Tensor
    b: torch.Tensor
    fb: torch.Tensor
    c: torch.Tensor
    fc: torch.Tensor
    d: torch.Tensor
    flag: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    fs: torch.Tensor
    done: torch.Tensor


def _nonzero(cond, x):
    """``x`` with 1 where ``cond``: a denominator guarded from zero."""
    return torch.where(cond, 1.0, x)


def brent(fn, lower, upper, tol=1e-12, max_iter=200) -> RootResult:
    """Brent's method: IQI + secant + bisection safeguards
    (nlsolver.h:4002-4067).  The bracket is kept as given; the reference
    swaps a and b during the iteration only."""
    a, b = _lanes(lower, upper)
    fa = _eval(fn, a)
    fb = _eval(fn, b)
    ok = fa * fb < 0

    def body(s: _Brent) -> _Brent:
        use_iqi = (s.fa != s.fc) & (s.fb != s.fc)
        denom_ab = _nonzero(s.fa == s.fb, s.fa - s.fb)
        iqi = (
            (s.a * s.fb * s.fc) / (denom_ab * _nonzero(s.fa == s.fc, s.fa - s.fc))
            + (s.b * s.fa * s.fc) / (-denom_ab * _nonzero(s.fb == s.fc, s.fb - s.fc))
            + (s.c * s.fa * s.fb)
            / (_nonzero(s.fc == s.fa, s.fc - s.fa) * _nonzero(s.fc == s.fb, s.fc - s.fb))
        )
        # the reference divides by (val_b - val_a) (nlsolver.h:4033);
        # -denom_ab is bit-identical to fb - fa (IEEE negation is exact)
        secant = s.b - s.fb * ((s.b - s.a) / -denom_ab)
        cand = torch.where(use_iqi, iqi, secant)
        # fa == fb makes the reference's secant and IQI divide by zero, and
        # its inf / NaN candidate always fails the window test below; the
        # guarded denominators give a finite bogus candidate instead, so the
        # bisection branch is forced explicitly to match
        degenerate = s.fa == s.fb
        cond_bisect = (
            degenerate
            | ~((cand > (3 * s.a + s.b) / 4) & (cand < s.b))
            | (s.flag & ((cand - s.b).abs() >= (s.b - s.c).abs() / 2))
            | (~s.flag & ((cand - s.b).abs() >= (s.c - s.d).abs() / 2))
            | (s.flag & ((s.b - s.c).abs() < tol))
            | (~s.flag & ((s.c - s.d).abs() < tol))
        )
        cand = torch.where(cond_bisect, (s.a + s.b) / 2, cand)

        fs = fn(cand)
        move_b = s.fa * fs < 0
        b2 = torch.where(move_b, cand, s.b)
        fb2 = torch.where(move_b, fs, s.fb)
        a2 = torch.where(move_b, s.a, cand)
        fa2 = torch.where(move_b, s.fa, fs)
        swap = fa2.abs() < fb2.abs()
        a3 = torch.where(swap, b2, a2)
        b3 = torch.where(swap, a2, b2)
        fa3 = torch.where(swap, fb2, fa2)
        fb3 = torch.where(swap, fa2, fb2)
        done = (
            (fb3.abs() < tol)
            | (fs.abs() < tol)
            | ((b3 - a3).abs() < tol)
            | (s.it >= max_iter)
        )
        return _Brent(a3, fa3, b3, fb3, s.b, s.fb, s.c, cond_bisect, s.it + 1, s.nfev + 1, fs,
                      done)

    init = _Brent(a, fa, b, fb, a, fa, torch.zeros_like(a), _flag(a, True), _counter(a, 0),
                  _counter(a, 2), fb, ~ok)
    final = _run(body, init)
    # the reference returns on the check BEFORE the increment of iter shows
    res = RootResult(final.b, final.fb, final.it - 1, final.nfev, final.fb.abs() < tol,
                     _flag(a, True))
    return _merge(ok, res)


class _Ridders(NamedTuple):
    a: torch.Tensor
    fa: torch.Tensor
    b: torch.Tensor
    fb: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    x: torch.Tensor
    fx: torch.Tensor
    done: torch.Tensor


def ridders(fn, lower, upper, tol=1e-12, eps=1e-12, max_iter=5) -> RootResult:
    """Ridders' exponential-fit method (nlsolver.h:4069-4124; the
    reference's default max_iter really is 5)."""
    a, b = _lanes(lower, upper)
    fa = _eval(fn, a)
    fb = _eval(fn, b)
    ok = fa * fb < 0

    def body(s: _Ridders) -> _Ridders:
        mid = (s.a + s.b) / 2
        fmid = fn(mid)
        denom = torch.sqrt(torch.clamp(fmid * fmid - s.fa * s.fb, min=1e-300))
        new_mid = mid + (mid - s.a) * (torch.sign(s.fa - s.fb) * fmid / denom)
        fnew = fn(new_mid)
        stop = (
            (torch.minimum((new_mid - s.a).abs(), (new_mid - s.b).abs()) < tol)
            | (fnew.abs() < eps)
            | (s.it >= max_iter)
        )
        # bracket update (nlsolver.h:4109-4121)
        case1 = fmid * fnew < 0
        case2 = ~case1 & (s.fa * fnew < 0)
        a2 = torch.where(case1, mid, s.a)
        fa2 = torch.where(case1, fmid, s.fa)
        a3 = torch.where(case2, new_mid, a2)
        fa3 = torch.where(case2, fnew, fa2)
        b2 = torch.where(case1, new_mid, torch.where(case2, s.b, new_mid))
        fb2 = torch.where(case1, fnew, torch.where(case2, s.fb, fnew))
        return _Ridders(
            torch.where(stop, s.a, a3),
            torch.where(stop, s.fa, fa3),
            torch.where(stop, s.b, b2),
            torch.where(stop, s.fb, fb2),
            torch.where(stop, s.it, s.it + 1),
            s.nfev + 2,
            new_mid,
            fnew,
            stop,
        )

    final = _run(body, _Ridders(a, fa, b, fb, _counter(a, 0), _counter(a, 2), a, fa, ~ok))
    res = RootResult(final.x, final.fx, final.it, final.nfev, final.fx.abs() < eps,
                     _flag(a, True))
    return _merge(ok, res)


class _Tiruneh(NamedTuple):
    k0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    f0: torch.Tensor
    f1: torch.Tensor
    f2: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    done: torch.Tensor


def tiruneh(fn, x_k=(-100.0, 0.0, 100.0), eps=1e-6, tol=1e-12, max_iter=10) -> RootResult:
    """Tiruneh's 3-point memory method (arXiv:1902.09058; reference
    nlsolver.h:4144-4183).  Keeps a rolling (oldest, middle, newest) window;
    as in the reference, the termination tests and the returned iterate use
    the OLDEST element of the window."""
    k0, k1, k2 = _lanes(*x_k, name="x_k")
    f0, f1, f2 = _eval(fn, k0), _eval(fn, k1), _eval(fn, k2)

    def body(s: _Tiruneh) -> _Tiruneh:
        stop = (s.f0.abs() < tol) | (s.it > max_iter) | ((s.f0 - s.f1).abs() < eps)
        slope02 = (s.f0 - s.f2) / (s.k0 - s.k2)
        slope12 = (s.f1 - s.f2) / (s.k1 - s.k2)
        denom = slope02 * (s.f0 - s.f1) - s.f0 * (slope02 - slope12)
        new = s.k2 - (s.f2 * (s.f0 - s.f1)) / denom
        fnew = fn(new)
        return _Tiruneh(
            torch.where(stop, s.k0, s.k1),
            torch.where(stop, s.k1, s.k2),
            torch.where(stop, s.k2, new),
            torch.where(stop, s.f0, s.f1),
            torch.where(stop, s.f1, s.f2),
            torch.where(stop, s.f2, fnew),
            torch.where(stop, s.it, s.it + 1),
            torch.where(stop, s.nfev, s.nfev + 1),
            stop,
        )

    final = _run(body, _Tiruneh(k0, k1, k2, f0, f1, f2, _counter(k0, 0), _counter(k0, 3),
                                _flag(k0, False)))
    # not a bracketing method: every lane counts as bracketed
    return RootResult(final.k0, final.f0, final.it, final.nfev, final.f0.abs() < tol,
                      _flag(k0, True))


class _ITP(NamedTuple):
    a: torch.Tensor
    fa: torch.Tensor
    b: torch.Tensor
    fb: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    x: torch.Tensor
    fx: torch.Tensor
    done: torch.Tensor
    converged: torch.Tensor


def itp(fn, lower, upper, kappa1=0.3, kappa2=2.1, n0=1.0, tol=1e-12, eps=1e-12,
        max_iter=200) -> RootResult:
    """ITP method (nlsolver.h:4184-4249).  Follows the reference's variant,
    where sigma is the 0/1 indicator (mid > interp) rather than the paper's
    +-1 sign.  ``tol`` is unused, as in the reference."""
    a, b = _lanes(lower, upper)
    fa = _eval(fn, a)
    fb = _eval(fn, b)
    ok = fa * fb < 0
    two_eps = 2 * eps
    n_max = torch.log2((b - a) / a.new_full((), two_eps)) + n0

    def body(s: _ITP) -> _ITP:
        b_min_a = s.b - s.a
        exhausted = (b_min_a < two_eps) | (s.it >= max_iter)

        mid = (s.a + s.b) / 2
        r = eps * torch.pow(2.0, n_max - 1) - b_min_a / 2
        delta = kappa1 * torch.pow(b_min_a, kappa2)
        interp = (s.fb * s.a - s.fa * s.b) / _nonzero(s.fb == s.fa, s.fb - s.fa)
        temp = mid - interp
        sigma = (temp > 0).to(s.a.dtype)  # the reference's 0/1 indicator
        project = temp <= r
        interp = torch.where(delta <= temp.abs(), interp + sigma * delta, mid)
        xt = torch.where(project, interp, mid - sigma * r)

        ft = fn(xt)
        exact = ft == 0
        same_side = ft * s.fa > 0
        a2 = torch.where(same_side, xt, s.a)
        fa2 = torch.where(same_side, ft, s.fa)
        b2 = torch.where(same_side, s.b, xt)
        fb2 = torch.where(same_side, s.fb, ft)

        stop = exhausted | exact
        x_out = torch.where(exhausted, mid, xt)
        return _ITP(
            torch.where(exhausted, s.a, a2),
            torch.where(exhausted, s.fa, fa2),
            torch.where(exhausted, s.b, b2),
            torch.where(exhausted, s.fb, fb2),
            torch.where(stop, s.it, s.it + 1),
            torch.where(exhausted, s.nfev, s.nfev + 1),
            torch.where(stop, x_out, s.x),
            torch.where(exhausted, s.fx, ft),
            stop,
            exact | (exhausted & (b_min_a < two_eps)),
        )

    init = _ITP(a, fa, b, fb, _counter(a, 0), _counter(a, 2), (a + b) / 2,
                torch.full_like(a, 1e5), ~ok, _flag(a, False))
    final = _run(body, init)
    res = RootResult(final.x, final.fx, final.it, final.nfev, final.converged, _flag(a, True))
    return _merge(ok, res)


class _Chandrupatla(NamedTuple):
    a: torch.Tensor
    fa: torch.Tensor
    b: torch.Tensor
    fb: torch.Tensor
    c: torch.Tensor
    fc: torch.Tensor
    t: torch.Tensor
    it: torch.Tensor
    nfev: torch.Tensor
    xm: torch.Tensor
    fm: torch.Tensor
    done: torch.Tensor


def chandrupatla(fn, lower, upper, eps_m=1e-10, eps_a=2e-10, max_iter=200) -> RootResult:
    """Chandrupatla's method: IQI or bisection by the xi / phi test
    (nlsolver.h:4251-4318)."""
    a, b = _lanes(lower, upper)
    fa = _eval(fn, a)
    fb = _eval(fn, b)
    ok = fa * fb < 0

    def body(s: _Chandrupatla) -> _Chandrupatla:
        xt = s.b + s.t * (s.a - s.b)
        ft = fn(xt)
        sign_change = ft * s.fb < 0
        c2 = torch.where(sign_change, s.a, s.b)
        fc2 = torch.where(sign_change, s.fa, s.fb)
        a2 = torch.where(sign_change, s.b, s.a)
        fa2 = torch.where(sign_change, s.fb, s.fa)
        b2, fb2 = xt, ft

        b_smaller = fb2.abs() < fa2.abs()
        xm = torch.where(b_smaller, b2, a2)
        fm = torch.where(b_smaller, fb2, fa2)
        stop1 = (fm.abs() < eps_a) | (s.it > max_iter)

        tol = 2 * eps_m * xm.abs() + eps_a
        # 1e-300 is 0 in float32, as in JAX: t_lim is then inf and stop2 holds
        t_lim = tol / torch.where(a2 == c2, 1e-300, (a2 - c2).abs())
        stop = stop1 | (t_lim > 0.5)

        xi = (a2 - b2) / _nonzero(c2 == b2, c2 - b2)
        phi = (fa2 - fb2) / _nonzero(fc2 == fb2, fc2 - fb2)
        use_iqi = (phi * phi < xi) & ((1 - phi) * (1 - phi) < (1 - xi))
        t_iqi = fa2 / _nonzero(fb2 == fa2, fb2 - fa2) * fc2 / _nonzero(
            fb2 == fc2, fb2 - fc2
        ) + (c2 - a2) / _nonzero(b2 == a2, b2 - a2) * fa2 / _nonzero(
            fc2 == fa2, fc2 - fa2
        ) * fb2 / _nonzero(fc2 == fb2, fc2 - fb2)
        t_new = torch.where(use_iqi, t_iqi, 0.5)
        # jnp.clip: the upper limit wins where t_lim > 0.5 puts it below the lower
        t_new = torch.minimum(torch.maximum(t_new, t_lim), 1.0 - t_lim)
        return _Chandrupatla(a2, fa2, b2, fb2, c2, fc2, t_new,
                             torch.where(stop, s.it, s.it + 1), s.nfev + 1, xm, fm, stop)

    init = _Chandrupatla(a, fa, b, fb, b, torch.zeros_like(a), torch.full_like(a, 0.5),
                         _counter(a, 0), _counter(a, 2), a, fa, ~ok)
    final = _run(body, init)
    res = RootResult(final.xm, final.fm, final.it, final.nfev, final.fm.abs() < eps_a,
                     _flag(a, True))
    return _merge(ok, res)


ALL_FINDERS = {
    "bisection": bisection,
    "false_position": false_position,
    "brent": brent,
    "ridders": ridders,
    "tiruneh": tiruneh,
    "itp": itp,
    "chandrupatla": chandrupatla,
}
