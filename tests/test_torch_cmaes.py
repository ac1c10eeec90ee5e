"""nlsolver_torch.solvers.cmaes against nlsolver_tpu.solvers.cmaes (f64 on
the CPU): the config and the strategy constants field for field, single
generations from a carried-over JAX state on injected draws, and whole runs
by what they reach.

Draws: the JAX step splits its key and draws ``z [lam, n]``; the tests make
the same ``z`` and hand it to the port's step, whose state has no key.
Single steps agree to rtol 1e-10 with ``eigh_method="jacobi"`` (the same
operations in the same order; the library ``eigh`` of the two packages
orders and signs eigenvectors differently, so ``"xla"`` is compared by its
results only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlsolver_torch as nt
from nlsolver_torch.core import Bounds
from nlsolver_torch.solvers import cmaes as tc
from nlsolver_tpu.core import Bounds as JBounds
from nlsolver_tpu.solvers import cmaes as jc

torch.set_num_threads(1)
FLOAT_FIELDS = ("mean", "sigma", "C", "p_sigma", "p_c", "best_x", "best_value", "prev_best")
EXACT_FIELDS = ("iteration", "nfev", "no_change", "done", "converged")


def t_rosen(x):
    return 100.0 * (x[..., 0] ** 2 - x[..., 1]) ** 2 + (x[..., 0] - 1.0) ** 2


def j_rosen(x):
    return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2


def test_config_and_state_fields_equal_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(tc.CMAESConfig) == spec(jc.CMAESConfig)
    assert nt.CMAESConfig is tc.CMAESConfig
    # the port's state is JAX's without the key: the draws are an input
    assert tc.CMAESState._fields == tuple(f for f in jc.CMAESState._fields if f != "key")


@pytest.mark.parametrize("n,pop", [(2, 0), (3, 0), (8, 0), (16, 0), (16, 12), (5, 32), (56, 0)])
def test_params_equal_jax(n, pop):
    ours, theirs = tc._params(n, pop), jc._params(n, pop)
    assert len(ours) == len(theirs) == 10
    for a, b in zip(ours, theirs):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert type(a) is type(b) and a == b
    assert ours[0] == (pop or 4 + int(3 * np.log(n))) and ours[1] == ours[0] // 2


def _carry(j_state):
    """The JAX state's fields as the port's state (no key)."""
    return tc.CMAESState(**{
        f: torch.from_numpy(np.array(getattr(j_state, f))) for f in tc.CMAESState._fields})


def _assert_states_match(t_state, j_state, rtol):
    for f in EXACT_FIELDS:
        want = np.asarray(getattr(j_state, f))
        got = getattr(t_state, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    for f in FLOAT_FIELDS:
        want = np.asarray(getattr(j_state, f))
        scale = float(np.abs(want[np.isfinite(want)]).max()) if np.isfinite(want).any() else 0.0
        np.testing.assert_allclose(getattr(t_state, f).numpy(), want, rtol=rtol,
                                   atol=rtol * scale, err_msg=f)


@pytest.mark.parametrize("bounded", [False, True])
def test_steps_from_a_carried_state_match_jax(bounded):
    """Each step starts from JAX's own state, so no difference builds up."""
    n = 4
    fn_t = lambda x: ((x + 1.0) ** 2).sum(-1) if bounded else t_rosen(x)  # noqa: E731
    fn_j = (lambda x: jnp.sum((x + 1.0) ** 2)) if bounded else j_rosen
    tb = Bounds(torch.zeros(n, dtype=torch.float64), torch.full((n,), 4.0, dtype=torch.float64))
    jb = JBounds(jnp.zeros(n), jnp.full(n, 4.0))
    tcfg, jcfg = tc.CMAESConfig(eigh_method="jacobi"), jc.CMAESConfig(eigh_method="jacobi")
    lam = tc._params(n, 0)[0]
    x0 = np.full(n, 0.5)
    j_state = jc.init(fn_j, jnp.asarray(x0), jcfg, jax.random.key(3))
    _assert_states_match(tc.init(fn_t, torch.from_numpy(x0), tcfg), j_state, rtol=1e-15)
    j_step = jax.jit(lambda s: jc.step(fn_j, s, jcfg, jb if bounded else None))
    for _ in range(6):
        _, k_z = jax.random.split(j_state.key)
        z = torch.from_numpy(np.array(jax.random.normal(k_z, (lam, n), jnp.float64)))
        t_next = tc.step(fn_t, _carry(j_state), tcfg, tb if bounded else None, z=z)
        j_state = j_step(j_state)
        _assert_states_match(t_next, j_state, rtol=1e-10)
    assert int(j_state.iteration) == 6 and not bool(j_state.done)


def test_a_halted_instance_is_frozen_and_a_stagnant_one_converges():
    cfg = tc.CMAESConfig(max_iter=3)
    g = torch.Generator().manual_seed(0)
    state = tc.init(t_rosen, torch.zeros(2, dtype=torch.float64), cfg)
    for _ in range(4):
        state = tc.step(t_rosen, state, cfg, generator=g)
    assert bool(state.done) and not bool(state.converged) and int(state.iteration) == 3
    flat = tc.minimize(lambda x: x.sum(-1) * 0.0, torch.zeros(2, dtype=torch.float64),
                       tc.CMAESConfig(best_value_no_change=5))
    # a constant objective improves once (on the infinite prev_best), then
    # never: the stagnation rule halts it five generations later
    assert bool(flat.converged) and int(flat.iterations) == 5
    assert int(flat.function_calls) == 1 + 6 * 5


@pytest.mark.parametrize("method", ["xla", "jacobi"])
def test_minimize_reaches_the_rosenbrock_minimum_as_jax_does(method):
    x0 = np.array([-0.5, -0.5])
    got = tc.minimize(t_rosen, torch.from_numpy(x0), tc.CMAESConfig(eigh_method=method))
    want = jax.jit(lambda x: jc.minimize(j_rosen, x, jc.CMAESConfig(eigh_method=method)))(
        jnp.asarray(x0))
    # other draws, the same algorithm: both converge to (1, 1) by stagnation
    for res in (got, want):
        assert bool(np.asarray(res.converged)) and float(np.asarray(res.f_value)) < 1e-10
        np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-4)
        assert int(np.asarray(res.function_calls)) == 1 + 6 * int(np.asarray(res.iterations))
    assert abs(int(got.iterations) - int(np.asarray(want.iterations))) < 100
    assert got.iterations.dtype == torch.int32 and got.converged.dtype == torch.bool


def test_maximize_bounds_and_ipop():
    up = tc.maximize(lambda x: -t_rosen(x), torch.tensor([-0.5, -0.5], dtype=torch.float64))
    assert abs(float(up.f_value)) < 1e-10 and float((up.x - 1.0).abs().max()) < 1e-4
    # the corner optimum of the bounded problem of tests/test_cmaes_fleet.py
    box = Bounds(torch.zeros(2, dtype=torch.float64), torch.full((2,), 4.0, dtype=torch.float64))
    res = tc.minimize(lambda x: ((x + 1.0) ** 2).sum(-1), torch.full((2,), 2.0, dtype=torch.float64),
                      tc.CMAESConfig(max_iter=200), box)
    assert float(res.x.min()) >= 0.0 and float(res.x.abs().max()) <= 1e-2
    assert abs(float(res.f_value) - 2.0) < 1e-2
    # restarts sum the counters and keep the best stage
    rastrigin = nt.PROBLEMS["rastrigin"].fn
    one = tc.minimize_ipop(rastrigin, torch.full((2,), 2.2, dtype=torch.float64),
                           tc.CMAESConfig(max_iter=60), max_restarts=0)
    three = tc.minimize_ipop(rastrigin, torch.full((2,), 2.2, dtype=torch.float64),
                             tc.CMAESConfig(max_iter=60), max_restarts=2, bounds=Bounds(
                                 torch.full((2,), -5.12, dtype=torch.float64),
                                 torch.full((2,), 5.12, dtype=torch.float64)))
    assert int(three.iterations) > int(one.iterations)
    assert float(three.f_value) <= float(one.f_value) + 1e-12
    assert int(three.function_calls) > int(one.function_calls)
