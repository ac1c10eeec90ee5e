"""Top-level user API (counterpart of ``nlsolver_tpu.api``).

    result = nlsolver_torch.minimize(fn, x0[B, n], method="de", layout="batched")

    result = nlsolver_torch.minimize(fn, x0[n, B], method="bfgs", layout="fleet")

    result = nlsolver_torch.minimize(fn, x0[n, B], method="cmaes", layout="fleet")

    result = nlsolver_torch.minimize(fn, x0[B, n], method="pso", layout="batched")

    result = nlsolver_torch.minimize(fn, x0[B, n], method="sann", layout="batched")

    result = nlsolver_torch.minimize(fn, x0[n], method="bfgs")

    result = nlsolver_torch.minimize(fn, x0[B, n], method="bfgs", layout="batched")

    result = nlsolver_torch.root(fn, lower[B], upper[B], method="brent")

``minimize`` routes the engines listed in ``PORTED_ROUTES`` so far (the
batched Differential Evolution fleet ``solvers.de_batched``, the
batch-minor BFGS fleet ``solvers.bfgs_fleet``, the batch-minor CMA-ES
fleet ``solvers.cmaes_fleet``, the lane fleets of PSO and SANN,
``solvers.pso_batched`` and ``solvers.sann_batched``, and the
single-instance solvers with derivatives and their Brent-based kin,
``bfgs``, ``lbfgs``, ``lbfgsb``, ``gd``, ``cgd``, ``lm``, ``brent`` and
``coordinate``, under ``layout="single"`` (one point ``x0 [n]``) and
``layout="batched"`` (``x0 [B, n]``, every lane at once, as the JAX
package's ``vmap`` of the single solver)); every other method or layout
raises ``NotImplementedError`` naming the ported routes and the ROADMAP.md
queue item that ports the one asked for.  The single-point objective of
these routes may take per-lane data: ``data=`` (a tensor or tuple of
tensors with the lane axis leading) makes it ``fn(x, data_b)``.  ``root``
runs the seven 1-D root finders of ``solvers.rootfind`` on lane tensors.
Start points that are a ``torch.Tensor`` keep their device (a CPU tensor
asks for the CPU); anything else goes to the CUDA card, and raises when
there is none.
Nonlinear least squares is ``fit`` / ``fit_batched`` / ``curve_fit``
(re-exported from ``solvers.nlls``) plus ``fit_fleet``, the batch-minor
lane fleet with its ``solve`` backends (solvers/nlls_fleet.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from .core import Bounds, SolverResult, signed, start_points
from .solvers import (bfgs, bfgs_fleet, brent, cgd, cmaes_fleet, coordinate, de_batched, gd, lbfgs,
                      lbfgsb, lm, pso_batched, rootfind, sann_batched)
from .solvers.bfgs_fleet import BFGSFleetConfig
from .solvers.cmaes_fleet import CMAESFleetConfig
from .solvers.de import DEConfig
from .solvers.nlls import NLLSConfig, curve_fit, fit, fit_batched  # noqa: F401
from .solvers.nlls_fleet import NLLSFleetConfig, fit_fleet  # noqa: F401
from .solvers.pso import PSOConfig
from .solvers.sann import SANNConfig

_LAYOUTS = ("single", "batched", "fleet", "sharded", "islands")

# the single-instance solvers on lane tensors, by method: each takes
# layout="single" (minimize, x0 [n]) and layout="batched"
# (minimize_batched, x0 [B, n])
_LANE_SOLVERS = {"bfgs": bfgs, "lbfgs": lbfgs, "lbfgsb": lbfgsb, "gd": gd, "cgd": cgd, "lm": lm,
                 "brent": brent, "coordinate": coordinate}
# the (method, layout) routes that minimize and maximize take; the module
# docstring and the NotImplementedError text name them from here
PORTED_ROUTES = ((("de", "batched"), ("bfgs", "fleet"), ("cmaes", "fleet"), ("pso", "batched"),
                  ("sann", "batched"))
                 + tuple((m, lay) for m in _LANE_SOLVERS for lay in ("single", "batched")))


def _bfgs_fleet(fn, x0, config, bounds, _minimize, kwargs):
    if bounds is not None:
        raise ValueError(
            "the BFGS fleet is unconstrained; use method='lbfgsb' for box constraints"
        )
    x0 = start_points(x0)
    if x0.ndim != 2:
        raise ValueError(f"layout='fleet' expects a 2-D x0, got {tuple(x0.shape)}")
    fn_cols = kwargs.pop("fn_cols", None)
    if fn_cols is None:
        # lift a single-point objective to the [n, B] -> [B] column form
        fn_cols = bfgs_fleet.colwise(signed(fn, _minimize))
    elif not _minimize:
        # an explicit fn_cols bypasses the signed() wrapper: negate it here
        user_cols = fn_cols
        fn_cols = lambda X: -user_cols(X)  # noqa: E731
    cfg = config if config is not None else BFGSFleetConfig()
    res = bfgs_fleet.minimize_fleet(fn_cols, x0, cfg, **kwargs)
    return res if _minimize else res._replace(f_value=-res.f_value)


def _cmaes_fleet(fn, x0, config, bounds, generator, _minimize, kwargs):
    x0 = start_points(x0)
    if x0.ndim != 2:
        raise ValueError(f"layout='fleet' expects a 2-D x0, got {tuple(x0.shape)}")
    cfg = config if config is not None else CMAESFleetConfig()
    res = cmaes_fleet.minimize_fleet(
        signed(fn, _minimize), x0, cfg, bounds, generator=generator, **kwargs
    )
    return res if _minimize else res._replace(f_value=-res.f_value)


# layout="batched": the lane-axis engine and its default config, by method
_BATCHED = {
    "de": (de_batched, DEConfig),
    "de_batched": (de_batched, DEConfig),
    "pso": (pso_batched, PSOConfig),
    "pso_batched": (pso_batched, PSOConfig),
    "sann": (sann_batched, SANNConfig),
    "sann_batched": (sann_batched, SANNConfig),
}


def _lane_solver(fn, x0, method, config, bounds, generator, layout, _minimize, restarts, kwargs):
    if restarts > 1:
        raise NotImplementedError(
            "restarts= (the single-instance multistart) is not ported to nlsolver_torch yet; "
            "ROADMAP.md Queue 1 item 6 (single-instance solvers and the API) ports it")
    mod = _LANE_SOLVERS[method]
    if method == "gd":
        kwargs = dict(kwargs, generator=generator)
    if config is not None:
        kwargs = dict(kwargs, config=config)
    run = mod.minimize if layout == "single" else mod.minimize_batched
    return run(fn, x0, bounds=bounds, _minimize=_minimize, **kwargs)


def _dispatch(fn, x0, method, config, bounds, generator, layout, _minimize, kwargs):
    # the single-instance multistart options, which only layout="single" runs
    restarts = kwargs.pop("restarts", 1)
    kwargs.pop("restart_spread", None)
    kwargs.pop("restart_sampler", None)
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {_LAYOUTS}")
    if restarts > 1 and layout != "single":
        raise ValueError(
            "restarts= is the single-instance multistart meta-driver; "
            f"layout={layout!r} is already multi-instance — run it with "
            "more lanes instead"
        )
    if layout == "fleet" and method not in ("cmaes", "cmaes_fleet", "bfgs", "bfgs_fleet"):
        raise ValueError(
            f"layout='fleet' supports method='bfgs' (batch-minor lane "
            f"fleet) and method='cmaes' (lane-parallel CMA-ES "
            f"strategies), got {method!r}; other methods batch via "
            f"layout='batched'"
        )
    if layout == "fleet" and method in ("cmaes", "cmaes_fleet"):
        return _cmaes_fleet(fn, x0, config, bounds, generator, _minimize, kwargs)
    if layout == "fleet" and method in ("bfgs", "bfgs_fleet"):
        return _bfgs_fleet(fn, x0, config, bounds, _minimize, kwargs)
    if layout in ("single", "batched") and method in _LANE_SOLVERS:
        return _lane_solver(fn, x0, method, config, bounds, generator, layout, _minimize,
                            restarts, kwargs)
    if layout == "batched" and method in _BATCHED:
        x0 = start_points(x0)
        if x0.ndim != 2:
            raise ValueError(f"layout='batched' expects a 2-D x0, got {tuple(x0.shape)}")
        engine, default = _BATCHED[method]
        cfg = config if config is not None else default()
        return engine.minimize_batched(
            fn, x0, cfg, bounds, generator=generator, _minimize=_minimize, **kwargs
        )
    if layout in ("sharded", "islands"):
        where = "Queue 1 item 9 (mesh engines)"
    else:
        where = "Queue 1 item 6 (single-instance solvers and the API)"
    raise NotImplementedError(
        f"method={method!r} with layout={layout!r} is not ported to "
        f"nlsolver_torch yet; ROADMAP.md {where} ports it. Ported: "
        + ", ".join(f"method={m!r} with layout={lay!r}" for m, lay in PORTED_ROUTES)
    )


def minimize(
    fn,
    x0,
    method: str = "nelder_mead",
    config=None,
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    layout: str = "single",
    **kwargs,
) -> SolverResult:
    """Minimize ``fn``; ``generator`` takes the place of the JAX package's
    ``key`` and lives on ``x0``'s device."""
    return _dispatch(fn, x0, method, config, bounds, generator, layout, True, kwargs)


def maximize(
    fn,
    x0,
    method: str = "nelder_mead",
    config=None,
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    layout: str = "single",
    **kwargs,
) -> SolverResult:
    """Maximize ``fn`` by minimizing ``-fn``; ``f_value`` is ``fn``'s own value."""
    return _dispatch(fn, x0, method, config, bounds, generator, layout, False, kwargs)


_ROOT_METHODS = (
    "bisection",
    "false_position",
    "brent",
    "ridders",
    "tiruneh",
    "itp",
    "chandrupatla",
)


def root(fn, lower=None, upper=None, method: str = "brent", **kwargs) -> rootfind.RootResult:
    """Find a root of ``fn`` in every lane (nlsolver::rootfinder,
    nlsolver.h:3923-4319).

    ``fn`` maps a lane tensor to a lane tensor elementwise; bracketing
    methods take ``lower`` / ``upper``, which broadcast to the lane shape;
    ``tiruneh`` takes its 3-point history as ``x_k=`` instead.  Returns a
    ``RootResult`` of lane tensors."""
    if method not in _ROOT_METHODS:
        raise ValueError(
            f"unknown root method {method!r}; available: {', '.join(_ROOT_METHODS)}"
        )
    finder = getattr(rootfind, method)
    if method == "tiruneh":
        if lower is not None or upper is not None:
            raise ValueError("tiruneh takes x_k=(a, b, c), not lower/upper")
        return finder(fn, **kwargs)
    return finder(fn, lower, upper, **kwargs)


def root_methods():
    return list(_ROOT_METHODS)


def _mesh_route(name: str):
    raise NotImplementedError(
        f"{name} is not ported to nlsolver_torch yet; ROADMAP.md Queue 1 item 9 "
        "(mesh engines) ports it. Ported: fit_fleet on one device"
    )


def fit_fleet_sharded(residual_fn, X0, config=None, mesh=None, data=None):
    """``fit_fleet`` with the lane axis sharded over a device mesh: not
    ported yet (ROADMAP.md Queue 1 item 9)."""
    _mesh_route("fit_fleet_sharded")


def fit_sharded(residual_fn, x0s, config=None, mesh=None, data=None):
    """``fit_batched`` with the fit batch sharded over a mesh: not ported
    yet (ROADMAP.md Queue 1 item 9)."""
    _mesh_route("fit_sharded")
