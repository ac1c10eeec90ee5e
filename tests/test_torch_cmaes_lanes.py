"""nlsolver_torch.solvers.cmaes on lane tensors against ``jax.vmap`` of
nlsolver_tpu.solvers.cmaes (float64, on the CPU).

Eight lanes of tests/torch_free_common.py at n = 4 (bowls, Rosenbrock,
Rastrigin and a flat lane that stagnates and halts early), ``pop_size=8``
so that mu = 4 >= n (with mu < n the covariance has a repeated eigenvalue
after the first generation, whose eigenvectors follow its last bit), the
Jacobi eigensolver (the same operations in both packages; the library
``eigh`` of the two orders and signs eigenvectors its own way, so
``"xla"`` is held by outcome), each lane's JAX key chain replayed with
``jax.random`` and handed to the port as ``draws=``.  Counters, ``done``
and ``converged`` must be equal lane by lane, the floats within rtol 1e-10
(scaled by each field's largest entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_free_common import B, chain, j_objective, keys_for, lanes, t_objective, torch_data

import nlsolver_torch as nt
import nlsolver_tpu as nj
from nlsolver_torch.core import Bounds, where_lanes
from nlsolver_torch.solvers import cmaes as tc
from nlsolver_torch.solvers._lane import step_rows
from nlsolver_tpu.core import Bounds as JBounds
from nlsolver_tpu.core.utils import tree_where
from nlsolver_tpu.solvers import cmaes as jc

torch.set_num_threads(1)
N, POP, GENS = 4, 8, 10
RTOL = 1e-10
FLOAT_FIELDS = ("mean", "sigma", "C", "p_sigma", "p_c", "best_x", "best_value", "prev_best")
EXACT_FIELDS = ("iteration", "nfev", "no_change", "done", "converged")
BOX = (-0.5, 1.0)


def _configs(**kw):
    kw = dict(pop_size=POP, eigh_method="jacobi", max_iter=GENS, best_value_no_change=5, **kw)
    return tc.CMAESConfig(**kw), jc.CMAESConfig(**kw)


def _z_chain(seed, T):
    """Each lane's draws: its key split once a generation it takes."""
    def body(key):
        key, k_z = jax.random.split(key)
        return key, jax.random.normal(k_z, (POP, N), jnp.float64)

    return chain(keys_for(seed), T, lambda key: (key, ()), body)


def _close(got, want, name):
    want = np.asarray(want)
    got = got.numpy()
    scale = float(np.abs(want[np.isfinite(want)]).max()) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale, err_msg=name)


def _equal(got, want, name):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), name


@pytest.mark.parametrize("bounded", [False, True])
def test_generations_match_jax_vmap(bounded):
    """Every generation of the eight lanes, frozen when done as
    ``core.drive`` freezes them, against the vmapped JAX step: the flat
    lane halts at its sixth generation, the others at theirs."""
    tcfg, jcfg = _configs()
    x0, k, c, w = lanes(N)
    keys = keys_for(3)
    draws = _z_chain(3, GENS + 1)
    tb = Bounds(torch.full((N,), BOX[0], dtype=torch.float64),
                torch.full((N,), BOX[1], dtype=torch.float64)) if bounded else None
    jb = JBounds(jnp.full(N, BOX[0]), jnp.full(N, BOX[1])) if bounded else None
    if bounded:
        x0 = np.clip(x0, *BOX)

    def j_init(x, kk, cc, ww, key):
        return jc.init(lambda p: j_objective(p, kk, cc, ww), x, jcfg, key)

    def j_step(s, kk, cc, ww):
        return tree_where(s.done, s, jc.step(lambda p: j_objective(p, kk, cc, ww), s, jcfg, jb))

    j_state = jax.vmap(j_init)(jnp.asarray(x0), jnp.asarray(k), jnp.asarray(c),
                               jnp.asarray(w), keys)
    j_step = jax.jit(jax.vmap(j_step))
    data = torch_data(k, c, w)
    state = tc.init(t_objective, torch.from_numpy(x0), tcfg, data=data)
    halted_at = {}
    for gen in range(GENS + 1):
        j_state = j_step(j_state, jnp.asarray(k), jnp.asarray(c), jnp.asarray(w))
        z = step_rows(draws.steps, state.iteration)
        state = where_lanes(state.done, state, tc.step(t_objective, state, tcfg, tb, z=z,
                                                       data=data))
        for f in EXACT_FIELDS:
            _equal(getattr(state, f), getattr(j_state, f), f"{f} at generation {gen}")
        for f in FLOAT_FIELDS:
            _close(getattr(state, f), getattr(j_state, f), f"{f} at generation {gen}")
        for b in np.flatnonzero(np.asarray(j_state.done)):
            halted_at.setdefault(int(b), gen)
    # the flat lane stagnates first; the lanes halt at three or more
    # different generations, each frozen from then on
    assert halted_at[5] == 5 and bool(state.converged[5])
    assert len(halted_at) == B and len(set(halted_at.values())) >= 3
    if bounded:
        assert float(state.best_x.min()) >= BOX[0] and float(state.best_x.max()) <= BOX[1]


@pytest.mark.parametrize("verb", ["minimize", "maximize"])
def test_minimize_batched_matches_jax_vmap(verb):
    """``minimize_batched`` on the lanes' draws against ``jax.vmap`` of the
    JAX ``minimize`` on their keys: the result lane by lane."""
    sign = 1.0 if verb == "minimize" else -1.0
    tcfg, jcfg = _configs()
    x0, k, c, w = lanes(N)
    keys = keys_for(5)

    def one(x, kk, cc, ww, key):
        return getattr(jc, verb)(lambda p: sign * j_objective(p, kk, cc, ww), x, jcfg, key=key)

    want = jax.jit(jax.vmap(one))(jnp.asarray(x0), jnp.asarray(k), jnp.asarray(c),
                                  jnp.asarray(w), keys)
    got = tc.minimize_batched(lambda x, d: sign * t_objective(x, d), torch.from_numpy(x0), tcfg,
                              draws=_z_chain(5, GENS + 1), data=torch_data(k, c, w),
                              _minimize=verb == "minimize")
    for f in ("iterations", "function_calls", "gradient_calls", "hessian_calls", "converged"):
        _equal(getattr(got, f), getattr(want, f), f)
    _close(got.x, want.x, "x")
    _close(got.f_value, want.f_value, "f_value")


def _bowls(n_lanes, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2.0, 2.0, (n_lanes, N)), rng.standard_normal((n_lanes, N))


def test_xla_eigh_by_outcome_on_64_bowls():
    """``eigh_method="xla"``: the library ``eigh`` of each package signs
    its eigenvectors its own way, so the runs are held by where they end:
    every lane converged, f below 1e-8, the fields' shapes and dtypes
    equal."""
    x0, c = _bowls(64)
    cfg_t, cfg_j = (mod.CMAESConfig(eigh_method="xla", max_iter=400) for mod in (tc, jc))
    got = tc.minimize_batched(lambda x, ci: ((x - ci) ** 2).sum(), torch.from_numpy(x0), cfg_t,
                              data=torch.from_numpy(c), generator=torch.Generator().manual_seed(0))
    want = jax.jit(jax.vmap(lambda x, ci, key: jc.minimize(
        lambda p: jnp.sum((p - ci) ** 2), x, cfg_j, key=key)))(
        jnp.asarray(x0), jnp.asarray(c), keys_for(0, 64))
    for res in (got, want):
        assert bool(np.asarray(res.converged).all()) and float(np.asarray(res.f_value).max()) < 1e-8
        np.testing.assert_allclose(np.asarray(res.x), c, atol=1e-3)
    for f in got._fields:
        assert tuple(getattr(got, f).shape) == np.asarray(getattr(want, f)).shape, f
        assert getattr(got, f).numpy().dtype == np.asarray(getattr(want, f)).dtype, f


def _sphere_j(x):
    return jnp.sum((x - 0.25) ** 2)


def _sphere_t(x):
    return ((x - 0.25) ** 2).sum()


def _as_numpy(res):
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


@pytest.mark.parametrize("route", ["batched", "restarts"])
def test_the_api_routes_beside_the_jax_package(route):
    """``minimize(method="cmaes", layout="batched")`` and ``restarts=`` on
    the CMA-ES beside ``nlsolver_tpu.minimize`` on the same starts: the two
    draw from different generators, so they are held by outcome (every lane
    converged, f below 1e-6, the result's fields, shapes and dtypes
    equal).  ``restarts=8`` runs as one batch of eight lanes."""
    x0 = np.linspace(-1.0, 1.5, 2 * N).reshape(2, N)
    cfg_t, cfg_j = nt.CMAESConfig(max_iter=300), jc.CMAESConfig(max_iter=300)
    if route == "batched":
        got = nt.minimize(_sphere_t, torch.from_numpy(x0), method="cmaes", layout="batched",
                          config=cfg_t)
        want = nj.minimize(_sphere_j, jnp.asarray(x0), method="cmaes", layout="batched",
                           config=cfg_j)
    else:
        seen = []
        real = tc.minimize_batched

        def spy(fn, x0, *a, **kw):
            seen.append(tuple(x0.shape))
            return real(fn, x0, *a, **kw)

        tc.minimize_batched = spy
        try:
            got = nt.minimize(_sphere_t, torch.from_numpy(x0[0]), method="cmaes", config=cfg_t,
                              restarts=8, restart_sampler="halton")
        finally:
            tc.minimize_batched = real
        assert seen == [(8, N)]
        want = nj.minimize(_sphere_j, jnp.asarray(x0[0]), method="cmaes", config=cfg_j,
                           restarts=8, restart_sampler="halton")
    g, j = _as_numpy(got), _as_numpy(want)
    assert list(g) == list(j)
    # the multistart's summed counters: int64 in the JAX package (a sum
    # under x64), int32 in the port, as every other counter of both
    summed = ("iterations", "function_calls", "gradient_calls", "hessian_calls")
    for f in g:
        assert g[f].shape == j[f].shape, f
        assert g[f].dtype == (np.int32 if route == "restarts" and f in summed else j[f].dtype), f
    for res in (g, j):
        assert bool(res["converged"].all()) and float(res["f_value"].max()) < 1e-6
    if route == "restarts":
        # the counters are summed over the eight starts, each a run of
        # some generations of lambda = 8 evaluations
        assert int(g["iterations"]) > 8 and int(g["function_calls"]) == 8 + 8 * int(
            g["iterations"])


@pytest.mark.parametrize("call", ["one_d_batched", "restarts_batched", "bad_sampler"])
def test_refusals_match_the_jax_package(call):
    """What the JAX package refuses on the CMA-ES routes, the port refuses
    with the same exception type."""
    x1 = np.array([0.5, -0.5])
    calls = {
        "one_d_batched": lambda m, x: m.minimize(_fn_of(m), x, method="cmaes", layout="batched"),
        "restarts_batched": lambda m, x: m.minimize(_fn_of(m), x[None].repeat(2, 0)
                                                    if m is nj else x[None].repeat(2, 1),
                                                    method="cmaes", layout="batched",
                                                    restarts=3),
        "bad_sampler": lambda m, x: m.minimize(_fn_of(m), x, method="cmaes", restarts=3,
                                               restart_sampler="sobol"),
    }
    kinds = []
    for mod, x in ((nj, jnp.asarray(x1)), (nt, torch.from_numpy(x1))):
        with pytest.raises(Exception) as err:
            calls[call](mod, x)
        kinds.append(type(err.value))
    assert kinds[0] is kinds[1] and kinds[0] is ValueError


def _fn_of(mod):
    return _sphere_j if mod is nj else _sphere_t
