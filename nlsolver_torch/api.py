"""Top-level user API (counterpart of ``nlsolver_tpu.api``).

    result = nlsolver_torch.minimize(fn, x0[n])            # Nelder-Mead, the default

    result = nlsolver_torch.minimize(fn, x0[n], method="bfgs", restarts=8,
                                     restart_sampler="halton")

    result = nlsolver_torch.minimize(fn, x0[B, n], method="nelder_mead", layout="batched")

    result = nlsolver_torch.minimize(fn, x0[B, n], method="de", layout="batched")

    result = nlsolver_torch.minimize(fn, x0[n, B], method="bfgs", layout="fleet")

    result = nlsolver_torch.minimize(fn, x0[B, n], method="cmaes", layout="batched")

    result = nlsolver_torch.minimize(fn, x0[n, B], method="cmaes", layout="fleet")

    result = nlsolver_torch.root(fn, lower[B], upper[B], method="brent")

``methods()`` lists the solver modules, as the JAX package's does, and an
unknown method raises its ``ValueError``.  ``layout="single"`` (one point
``x0 [n]``) runs every method with a single-instance ``minimize``:
``nelder_mead``, ``de``, ``pso``, ``sann``, ``nmpso``, ``cmaes`` and the
solvers with derivatives and their Brent-based kin (``bfgs``, ``lbfgs``,
``lbfgsb``, ``gd``, ``cgd``, ``lm``, ``brent``, ``coordinate``), each on
lane tensors at B = 1.  ``restarts=k`` there is the multistart: x0 and
k - 1 more starts (uniform in ``bounds``, else ``x0 +- restart_spread``,
or on the Halton sequence with ``restart_sampler="halton"``) run as the
lanes of one ``minimize_batched`` call, the best final value picked, the
counters summed.  ``layout="batched"`` (``x0 [B, n]``) takes ``de``,
``pso`` and ``sann`` to their lane fleets (``solvers.de_batched``,
``pso_batched``, ``sann_batched``) and every other single-instance solver,
``cmaes`` too, to its ``minimize_batched``, every lane at once as the JAX
package's ``vmap`` of the single solver; ``layout="fleet"`` (``x0 [n, B]``)
takes ``bfgs`` and ``cmaes`` to the batch-minor fleets.  ``layout="sharded"``
with ``mesh=`` (a ``parallel.make_mesh`` mesh; every rank of the world
calls with the same global inputs and gets the global result) takes
``bfgs`` and ``cmaes`` (``x0 [n, B]``), ``pso_batched`` and ``sann``
(``x0 [B, n]``) to the lane fleets sharded over every device
(``parallel.fleet_sharded``, ``parallel.cmaes_sharded``), ``de`` to the
population-sharded DE (``parallel.de_sharded``), ``pso`` to the
population-sharded PSO (``parallel.pso_sharded``) and ``lbfgs`` with a
single ``x0 [n]`` and ``grad_local=`` to the dimension-sharded L-BFGS
(``parallel.lbfgs_sharded``, whose objective is shard-local);
``layout="islands"`` takes ``de`` to the island DE
(``parallel.de_island``, ``fused=`` for its collective-free intervals).
The single-point objective of the lane solvers may take per-lane data: ``data=`` (a tensor
or tuple of tensors with the lane axis leading) makes it
``fn(x, data_b)``.  ``generator`` (a ``torch.Generator``
on ``x0``'s device) takes the place of the JAX package's ``key``.  Start
points that are a ``torch.Tensor`` keep their device (a CPU tensor asks for
the CPU); anything else goes to the CUDA card, and raises when there is
none.  ``root`` runs the seven 1-D root finders of ``solvers.rootfind`` on
lane tensors.  Nonlinear least squares is ``fit`` / ``fit_batched`` /
``curve_fit`` (re-exported from ``solvers.nlls``) plus ``fit_fleet``, the
batch-minor lane fleet with its ``solve`` backends (solvers/nlls_fleet.py),
and their mesh routes ``fit_fleet_sharded`` and ``fit_sharded``.
"""
from __future__ import annotations

import importlib
from typing import Optional

import torch

from .core import Bounds, SolverResult, resolve_bounds, signed, start_points
from .solvers import bfgs_fleet, cmaes_fleet, de_batched, pso_batched, rootfind, sann_batched
from .solvers._lane import _each
from .solvers.bfgs_fleet import BFGSFleetConfig
from .solvers.cmaes_fleet import CMAESFleetConfig
from .solvers.de import DEConfig
from .solvers.nlls import NLLSConfig, curve_fit, fit, fit_batched  # noqa: F401
from .solvers.nlls_fleet import NLLSFleetConfig, fit_fleet  # noqa: F401
from .solvers.pso import PSOConfig
from .solvers.sann import SANNConfig

_LAYOUTS = ("single", "batched", "fleet", "sharded", "islands")
# the solver modules by method name, the JAX package's list
_METHODS = {name: importlib.import_module(f".solvers.{name}", __package__) for name in (
    "nelder_mead", "de", "de_batched", "pso", "pso_batched", "sann", "sann_batched", "nmpso", "gd",
    "cgd", "bfgs", "bfgs_fleet", "lm", "nlls", "brent", "cmaes", "cmaes_fleet", "lbfgs", "lbfgsb",
    "coordinate")}


def methods():
    return sorted(_METHODS)


def _resolve(method: str):
    try:
        return _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; available methods: "
            f"{', '.join(sorted(_METHODS))}"
        ) from None


# the single-instance solvers on lane tensors: minimize (x0 [n]) and
# minimize_batched (x0 [B, n]); those that draw take generator=
_LANE_SOLVERS = ("nelder_mead", "de", "pso", "sann", "nmpso", "cmaes", "bfgs", "lbfgs", "lbfgsb",
                 "gd", "cgd", "lm", "brent", "coordinate")
_DRAWING = ("de", "pso", "sann", "nmpso", "gd", "cmaes")
# layout="batched": the lane-axis fleet and its default config, by method
_BATCHED = {
    "de": (de_batched, DEConfig),
    "de_batched": (de_batched, DEConfig),
    "pso": (pso_batched, PSOConfig),
    "pso_batched": (pso_batched, PSOConfig),
    "sann": (sann_batched, SANNConfig),
    "sann_batched": (sann_batched, SANNConfig),
}
# the (method, layout) routes that minimize and maximize take: every route
# of nlsolver_tpu.minimize
PORTED_ROUTES = ((("de", "batched"), ("bfgs", "fleet"), ("cmaes", "fleet"), ("pso", "batched"),
                  ("sann", "batched"), ("bfgs", "sharded"), ("cmaes", "sharded"),
                  ("pso_batched", "sharded"), ("sann", "sharded"), ("de", "sharded"),
                  ("pso", "sharded"), ("lbfgs", "sharded"), ("de", "islands"))
                 + tuple((m, "single") for m in _LANE_SOLVERS)
                 + tuple((m, "batched") for m in _LANE_SOLVERS if m not in _BATCHED))


def _halton_unit(k: int, n: int):
    """Static [k, n] Halton points in (0, 1)^n: the reference's own
    low-discrepancy generator (nlsolver::rng::halton, prime-base radical
    inverse), used to place restart starts; stratified, deterministic, so
    the starts do not depend on the generator."""
    import numpy as np

    primes = []
    c = 2
    while len(primes) < n:
        if all(c % p for p in primes):
            primes.append(c)
        c += 1

    def radical_inverse(i, base):
        f, r = 1.0, 0.0
        while i > 0:
            f /= base
            r += f * (i % base)
            i //= base
        return r

    return np.asarray(
        [[radical_inverse(i + 1, p) for p in primes] for i in range(k)],
        dtype=np.float64,
    )


def _single_hint(method: str) -> str:
    return {
        "de_batched": "use method='de' with layout='batched'",
        "pso_batched": "use method='pso' with layout='batched'",
        "sann_batched": "use method='sann' with layout='batched'",
        "bfgs_fleet": "use method='bfgs' with layout='fleet'",
        "nlls": "use nlsolver_torch.fit / fit_batched / curve_fit",
    }.get(method, "see nlsolver_torch.methods()")


def _lane_call(method, mod, fn, x0, config, bounds, generator, layout, _minimize, kwargs):
    if method in _DRAWING:
        kwargs = dict(kwargs, generator=generator)
    if config is not None:
        kwargs = dict(kwargs, config=config)
    if layout == "single":
        return mod.minimize(fn, x0, bounds=bounds, _minimize=_minimize, **kwargs)
    return mod.minimize_batched(fn, x0, bounds=bounds, _minimize=_minimize, **kwargs)


def _multistart(method, mod, fn, x0, config, bounds, generator, restarts, spread, sampler,
                _minimize, kwargs) -> SolverResult:
    """Best-of-``restarts``: the user's x0 plus ``restarts - 1`` starts, as
    the lanes of one ``minimize_batched`` call where the method has a lane
    form (every method with a single-instance ``minimize``), reduced by
    the best final value.  Starts are uniform inside ``bounds`` when
    given, else ``x0 + U(-spread, spread)^n``, or placed on the Halton
    sequence (``sampler="halton"``).  The counters are summed over every
    start (``solver_status.add``, nlsolver.h:2084-2091); ``x``,
    ``f_value`` and ``converged`` are the winning start's, a NaN value
    never winning."""
    if restarts < 2:
        raise ValueError(f"restarts must be >= 2, got {restarts}")
    if sampler not in ("uniform", "halton"):
        raise ValueError(
            f"restart_sampler must be 'uniform' or 'halton', got {sampler!r}"
        )
    x0 = start_points(x0)
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    n = x0.shape[-1] if x0.ndim else 1
    shape = (restarts,) + tuple(x0.shape)
    if sampler == "halton":
        unit = torch.as_tensor(_halton_unit(restarts, n).reshape(shape), dtype=x0.dtype,
                               device=x0.device)
    else:
        unit = torch.rand(shape, generator=generator, dtype=x0.dtype, device=x0.device)
    if bounds is not None:
        lo, hi, _ = resolve_bounds(bounds, x0)
        starts = lo + (hi - lo) * unit
    else:
        starts = x0 + spread * (2.0 * unit - 1.0)
    starts[0] = x0
    if "data" in kwargs:
        kwargs = dict(kwargs, data=_each(kwargs["data"], lambda d: torch.as_tensor(d)[None]
                                         .expand((restarts,) + tuple(torch.as_tensor(d).shape))))
    res = _lane_call(method, mod, fn, starts, config, bounds, generator, "batched", _minimize,
                     kwargs)
    fv = res.f_value
    if _minimize:
        pick = torch.where(torch.isnan(fv), torch.inf, fv).argmin()
    else:
        pick = torch.where(torch.isnan(fv), -torch.inf, fv).argmax()
    total = {f: getattr(res, f).sum().to(torch.int32)
             for f in ("iterations", "function_calls", "gradient_calls", "hessian_calls")}
    return SolverResult(*(f[pick] for f in res))._replace(**total)


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


def _dim_sharded(fn, x0, config, bounds, mesh, _minimize, kwargs):
    """``method="lbfgs", layout="sharded"``: the dimension-sharded L-BFGS
    (nlsolver_tpu/api.py:288-316); ``fn`` is the shard-local objective."""
    from .parallel import lbfgs_sharded

    if mesh is None:
        raise ValueError("layout='sharded' requires a mesh= argument")
    x0 = start_points(x0)
    if x0.ndim != 1:
        raise ValueError(
            f"dimension-sharded L-BFGS takes a single [n] start point, got {tuple(x0.shape)}"
        )
    grad_local = kwargs.pop("grad_local", None)
    if grad_local is None:
        raise ValueError(
            "method='lbfgs' with layout='sharded' shards the DIMENSION "
            "axis: pass fn as the shard-local objective contribution "
            "and grad_local= as d(global objective)/d(x_local) — see "
            "parallel/lbfgs_sharded.py"
        )
    if not _minimize:
        raise ValueError(
            "dimension-sharded L-BFGS only minimizes; negate the "
            "shard-local objective and gradient to maximize"
        )
    if bounds is not None or config is not None:
        raise ValueError(
            "the dimension-sharded L-BFGS takes no bounds and no config; pass its settings "
            "(memory=, max_iter=, grad_eps=, ls_shrink=, ls_max=) as keywords"
        )
    return lbfgs_sharded.minimize_dim_sharded(fn, grad_local, x0, mesh, **kwargs)


def _islands(fn, x0, method, config, bounds, generator, mesh, _minimize, kwargs):
    """``layout="islands"``: the island DE (nlsolver_tpu/api.py:424-430)."""
    from .parallel import de_island

    x0 = start_points(x0)
    if x0.ndim != 2:
        raise ValueError(f"layout='islands' expects a 2-D x0, got {tuple(x0.shape)}")
    if mesh is None:
        raise ValueError("layout='islands' requires a mesh= argument")
    if method != "de":
        raise ValueError(f"layout='islands' supports method='de', got {method!r}")
    if bounds is not None:
        raise ValueError(
            "the island DE is unbounded, as the lane-axis DE engine is (x0 is a "
            "per-dimension width); for a box use method='pso_batched' with bounds="
        )
    cfg = config if config is not None else DEConfig()
    res = de_island.minimize_islands(signed(fn, _minimize), x0, cfg, mesh, generator=generator,
                                     **kwargs)
    return res if _minimize else res._replace(f_value=-res.f_value)


def _sharded(fn, x0, method, config, bounds, generator, mesh, _minimize, kwargs):
    """``layout="sharded"``: the mesh engines (nlsolver_tpu/api.py:420-490)."""
    from .parallel import cmaes_sharded, de_sharded, fleet_sharded, pso_sharded

    x0 = start_points(x0)
    if x0.ndim != 2:
        raise ValueError(f"layout='sharded' expects a 2-D x0, got {tuple(x0.shape)}")
    if mesh is None:
        raise ValueError("layout='sharded' requires a mesh= argument")
    unflip = (lambda r: r) if _minimize else (lambda r: r._replace(f_value=-r.f_value))
    if method in ("bfgs", "bfgs_fleet"):
        if bounds is not None:
            raise ValueError(
                "the BFGS fleet is unconstrained; use method='lbfgsb' for box constraints"
            )
        fn_cols = kwargs.pop("fn_cols", None)
        if fn_cols is None:
            fn_cols = bfgs_fleet.colwise(signed(fn, _minimize))
        elif not _minimize:
            user_cols = fn_cols
            fn_cols = lambda X: -user_cols(X)  # noqa: E731
        if kwargs:
            raise TypeError(
                f"unexpected arguments for the sharded BFGS fleet: {sorted(kwargs)}"
            )
        cfg = config if config is not None else BFGSFleetConfig()
        return unflip(fleet_sharded.minimize_fleet_sharded(fn_cols, x0, cfg, mesh))
    if method in ("cmaes", "cmaes_fleet"):
        cfg = config if config is not None else CMAESFleetConfig()
        return unflip(cmaes_sharded.minimize_fleet_sharded(
            signed(fn, _minimize), x0, cfg, mesh, bounds, generator=generator, **kwargs))
    if method == "pso_batched":
        cfg = config if config is not None else PSOConfig()
        return fleet_sharded.minimize_pso_fleet_sharded(
            fn, x0, cfg, mesh, generator=generator, bounds=bounds, _minimize=_minimize, **kwargs)
    if method in ("sann", "sann_batched"):
        sann_batched.no_bounds(bounds)
        cfg = config if config is not None else SANNConfig()
        return fleet_sharded.minimize_sann_fleet_sharded(
            fn, x0, cfg, mesh, generator=generator, _minimize=_minimize, **kwargs)
    if method == "de":
        if bounds is not None:
            raise ValueError(
                "the population-sharded DE is unbounded, as the lane-axis DE engine is (x0 is a "
                "per-dimension width); for a box use method='pso_batched' with bounds="
            )
        cfg = config if config is not None else DEConfig()
        return unflip(de_sharded.minimize_sharded(signed(fn, _minimize), x0, cfg, mesh,
                                                  generator=generator, **kwargs))
    if method == "pso":
        if bounds is not None:
            raise ValueError(
                "the population-sharded PSO is unbounded (its swarm starts in +-|x0|); for a "
                "box use method='pso_batched' with bounds="
            )
        cfg = config if config is not None else PSOConfig()
        return unflip(pso_sharded.minimize_sharded(signed(fn, _minimize), x0, cfg, mesh,
                                                   generator=generator, **kwargs))
    raise ValueError(
        f"layout='sharded' supports method='de', 'pso' (population "
        f"sharding), 'pso_batched'/'sann' (lane-sharded instance "
        f"fleets, x0=[B, n]), 'cmaes'/'bfgs' (lane-sharded fleets, "
        f"x0=[n, B]) or 'lbfgs' (dimension-sharded, x0=[n] + "
        f"grad_local=), got {method!r}"
    )


def _dispatch(fn, x0, method, config, bounds, generator, layout, mesh, _minimize, kwargs):
    mod = _resolve(method)
    verb = "minimize" if _minimize else "maximize"
    restarts = kwargs.pop("restarts", 1)
    spread = kwargs.pop("restart_spread", 10.0)
    sampler = kwargs.pop("restart_sampler", "uniform")
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {_LAYOUTS}")
    if restarts > 1 and layout != "single":
        raise ValueError(
            "restarts= is the single-instance multistart meta-driver; "
            f"layout={layout!r} is already multi-instance — run it with "
            "more lanes instead"
        )
    if layout == "single":
        if getattr(mod, verb, None) is None:
            raise ValueError(
                f"method {method!r} has no single-instance {verb}; {_single_hint(method)}"
            )
        if restarts > 1:
            return _multistart(method, mod, fn, x0, config, bounds, generator, restarts, spread,
                               sampler, _minimize, kwargs)
        return _lane_call(method, mod, fn, x0, config, bounds, generator, layout, _minimize,
                          kwargs)
    if layout == "fleet" and method not in ("cmaes", "cmaes_fleet", "bfgs", "bfgs_fleet"):
        raise ValueError(
            f"layout='fleet' supports method='bfgs' (batch-minor lane "
            f"fleet) and method='cmaes' (lane-parallel CMA-ES "
            f"strategies), got {method!r}; other methods batch via "
            f"layout='batched'"
        )
    if layout == "fleet" and method in ("cmaes", "cmaes_fleet"):
        return _cmaes_fleet(fn, x0, config, bounds, generator, _minimize, kwargs)
    if layout == "fleet":
        return _bfgs_fleet(fn, x0, config, bounds, _minimize, kwargs)
    if layout == "sharded" and method in ("lbfgs", "lbfgs_sharded"):
        return _dim_sharded(fn, x0, config, bounds, mesh, _minimize, kwargs)
    if layout == "islands":
        return _islands(fn, x0, method, config, bounds, generator, mesh, _minimize, kwargs)
    if layout == "sharded":
        return _sharded(fn, x0, method, config, bounds, generator, mesh, _minimize, kwargs)
    # layout="batched"
    if method in _BATCHED:
        x0 = start_points(x0)
        if x0.ndim != 2:
            raise ValueError(f"layout='batched' expects a 2-D x0, got {tuple(x0.shape)}")
        engine, default = _BATCHED[method]
        cfg = config if config is not None else default()
        return engine.minimize_batched(
            fn, x0, cfg, bounds, generator=generator, _minimize=_minimize, **kwargs
        )
    if method in _LANE_SOLVERS:
        return _lane_call(method, mod, fn, x0, config, bounds, generator, layout, _minimize,
                          kwargs)
    raise ValueError(f"method {method!r} has no batched {verb}; {_single_hint(method)}")


def minimize(
    fn,
    x0,
    method: str = "nelder_mead",
    config=None,
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    layout: str = "single",
    mesh=None,
    **kwargs,
) -> SolverResult:
    """Minimize ``fn``; ``generator`` takes the place of the JAX package's
    ``key`` and lives on ``x0``'s device; ``mesh`` is the device mesh of
    ``layout="sharded"``."""
    return _dispatch(fn, x0, method, config, bounds, generator, layout, mesh, True, kwargs)


def maximize(
    fn,
    x0,
    method: str = "nelder_mead",
    config=None,
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    layout: str = "single",
    mesh=None,
    **kwargs,
) -> SolverResult:
    """Maximize ``fn`` by minimizing ``-fn``; ``f_value`` is ``fn``'s own value."""
    return _dispatch(fn, x0, method, config, bounds, generator, layout, mesh, False, kwargs)


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


def fit_fleet_sharded(residual_fn, X0, config=None, mesh=None, data=None):
    """``fit_fleet`` with the lane axis sharded over every device of
    ``mesh`` (parallel/fleet_sharded.py): the mesh route of the batch-minor
    NLLS fleet, no collective inside its loop."""
    from .parallel import fleet_sharded

    return fleet_sharded.fit_fleet_sharded(residual_fn, X0, config, mesh, data=data)


def fit_sharded(residual_fn, x0s, config=None, mesh=None, data=None):
    """``fit_batched`` with the fit batch sharded over the mesh's dp axis
    (parallel/nlls_sharded.py)."""
    if mesh is None:
        raise ValueError("fit_sharded requires a mesh= argument")
    from .parallel import nlls_sharded

    cfg = config if config is not None else NLLSConfig()
    return nlls_sharded.fit_sharded(residual_fn, x0s, cfg, mesh, data=data)
