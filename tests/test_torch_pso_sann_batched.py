"""nlsolver_torch.solvers.pso_batched and sann_batched against the JAX
package's lane fleets (f64 on the CPU).

Both packages start from the same inputs and step on the same draws: the
ones the JAX engines' key schedules give (pso_batched.py:71-82,132-142;
sann_batched.py:82-99), read from the JAX state as it steps and fed to the
port as ``draws``.  Floating fields agree to rtol 1e-12; the absolute
slack of 1e-14 covers values near zero, where XLA's CPU compiler contracts
``lower + span * u`` and the velocity update into fused multiply-adds and
the port rounds each operation.  Counters and flags are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlsolver_torch as nt
from nlsolver_torch.core import Bounds as TBounds
from nlsolver_torch.core import signed
from nlsolver_torch.interop import (pso_batch_state_from_numpy, pso_batch_state_to_numpy,
                                    sann_batch_state_from_numpy, sann_batch_state_to_numpy)
from nlsolver_torch.solvers import pso_batched as tpsb
from nlsolver_torch.solvers import sann_batched as tsnb
from nlsolver_torch.solvers.pso import PSOConfig as TPSOConfig
from nlsolver_torch.solvers.sann import E_MINUS_1 as T_E_MINUS_1
from nlsolver_torch.solvers.sann import SANNConfig as TSANNConfig
from nlsolver_tpu.core import Bounds as JBounds
from nlsolver_tpu.problems import PROBLEMS as JP
from nlsolver_tpu.solvers import pso_batched as jpsb
from nlsolver_tpu.solvers import sann_batched as jsnb
from nlsolver_tpu.solvers.pso import PSOConfig as JPSOConfig
from nlsolver_tpu.solvers.sann import E_MINUS_1 as J_E_MINUS_1
from nlsolver_tpu.solvers.sann import SANNConfig as JSANNConfig

torch.set_num_threads(1)
RTOL, ATOL = 1e-12, 1e-14
B, N, P = 12, 3, 8


def fields_of(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_match_jax():
    assert fields_of(TPSOConfig) == fields_of(JPSOConfig)
    assert fields_of(TSANNConfig) == fields_of(JSANNConfig)
    assert T_E_MINUS_1 == J_E_MINUS_1


def as_numpy(state):
    return {k: np.asarray(v) for k, v in state._asdict().items() if k != "keys"}


def assert_match(t_fields: dict, j_state, what=""):
    for name, want in as_numpy(j_state).items():
        got = t_fields[name]
        assert got.shape == want.shape, (what, name)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {name}")


# ---- PSO ------------------------------------------------------------------

def pso_init_draws(keys, n, P):
    """The uniforms of JAX's init (pso_batched.py:71-82), [n, P, B] each."""
    def one(key):
        _, k_pos, k_vel = jax.random.split(key, 3)
        return (jax.random.uniform(k_pos, (n, P), dtype=jnp.float64),
                jax.random.uniform(k_vel, (n, P), dtype=jnp.float64))

    u, uv = jax.vmap(one, out_axes=(-1, -1))(keys)
    return tpsb.PSOInitDraws(torch.tensor(np.asarray(u)), torch.tensor(np.asarray(uv)))


def pso_step_draws(keys, n, P, accelerated):
    """The draws JAX's step makes from ``keys`` (pso_batched.py:132-142)."""
    def one(key):
        k1, k2, _ = jax.random.split(key, 3)
        if accelerated:
            return jax.random.normal(k1, (n, P), jnp.float64), jnp.zeros((n, P))
        return (jax.random.uniform(k1, (n, P), dtype=jnp.float64),
                jax.random.uniform(k2, (n, P), dtype=jnp.float64))

    ra, rb = jax.vmap(one, out_axes=(-1, -1))(keys)
    ra = torch.tensor(np.asarray(ra))
    return tpsb.PSODraws(ra) if accelerated else tpsb.PSODraws(ra, torch.tensor(np.asarray(rb)))


def pso_case(mode, seed=0, **kw):
    """Inputs of both packages: x0, the configs, keys, the bounds and
    whether the step clamps."""
    x0 = np.random.default_rng(seed).uniform(0.5, 2.0, (B, N))
    kw = dict(n_particles=P, accelerated=mode == "accelerated", **kw)
    jcfg, tcfg = JPSOConfig(**kw), TPSOConfig(**kw)
    keys = jax.random.split(jax.random.key(seed + 5), B)
    if mode == "clamped":
        lo, hi = np.full((N, B), -1.0), np.full((N, B), 1.5)
        clamp = True
    else:
        lo, hi = -np.abs(x0.T), np.abs(x0.T)
        clamp = False
    return x0, jcfg, tcfg, keys, lo, hi, clamp


PSO_MODES = ["vanilla", "accelerated", "clamped"]


@pytest.mark.parametrize("mode", PSO_MODES)
@pytest.mark.parametrize("problem", ["rastrigin", "sphere"])
def test_pso_init_and_steps_match_jax(mode, problem):
    """init, then steps with a third of the lanes frozen from the start and
    the rest halting on best_value_no_change, eps or max_iter at different
    steps."""
    x0, jcfg, tcfg, keys, lo, hi, clamp = pso_case(
        mode, max_iter=7, best_value_no_change=3, eps=0.05)
    jfn, tfn = JP[problem].fn, nt.PROBLEMS[problem].fn
    js = jpsb.init(jfn, jnp.asarray(x0), jcfg, keys, jnp.asarray(lo), jnp.asarray(hi))
    ts = tpsb.init(tfn, torch.from_numpy(x0), tcfg, torch.from_numpy(lo), torch.from_numpy(hi),
                   draws=pso_init_draws(keys, N, P))
    assert_match(pso_batch_state_to_numpy(ts), js, "init")

    frozen = np.arange(B) % 3 == 0
    js = js._replace(done=jnp.asarray(frozen))
    ts = ts._replace(done=torch.from_numpy(frozen))
    jstep = jax.jit(lambda s: jpsb.step(jfn, s, jcfg, jnp.asarray(lo), jnp.asarray(hi), clamp))
    for k in range(9):
        draws = pso_step_draws(js.keys, N, P, jcfg.accelerated)
        js = jstep(js)
        ts = tpsb.step(tfn, ts, tcfg, torch.from_numpy(lo), torch.from_numpy(hi), clamp,
                       draws=draws)
        assert_match(pso_batch_state_to_numpy(ts), js, f"step {k}")
    done = np.asarray(js.done)
    assert done.all() and np.asarray(js.converged)[~frozen].any()
    assert len(set(np.asarray(js.iteration)[~frozen].tolist())) > 1   # halted at different steps
    assert (np.asarray(js.iteration)[frozen] == 0).all()
    if clamp:
        pos = ts.positions.numpy()
        assert (pos >= -1.0).all() and (pos <= 1.5).all()


def pso_minimize_on_jax_draws(jfn, tfn, x0, tcfg, jcfg, keys, lo, hi, clamp, minimize):
    """The port's minimize_batched with JAX's draws: init, steps until every
    lane is done, _finalize; the JAX state steps alongside for its keys."""
    sj, st = signed(jfn, minimize), signed(tfn, minimize)
    js = jpsb.init(sj, jnp.asarray(x0), jcfg, keys, jnp.asarray(lo), jnp.asarray(hi))
    ts = tpsb.init(st, torch.from_numpy(x0), tcfg, torch.from_numpy(lo), torch.from_numpy(hi),
                   draws=pso_init_draws(keys, N, P))
    jstep = jax.jit(lambda s: jpsb.step(sj, s, jcfg, jnp.asarray(lo), jnp.asarray(hi), clamp))
    while not bool(ts.done.all()):
        draws = pso_step_draws(js.keys, N, P, jcfg.accelerated)
        js = jstep(js)
        ts = tpsb.step(st, ts, tcfg, torch.from_numpy(lo), torch.from_numpy(hi), clamp,
                       draws=draws)
    return tpsb._finalize(ts, flip_sign=not minimize)


def assert_results_match(got, want):
    for name in ("x", "f_value"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for name in ("iterations", "function_calls", "converged"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("mode", PSO_MODES)
@pytest.mark.parametrize("minimize", [True, False], ids=["minimize", "maximize"])
def test_pso_minimize_matches_jax(mode, minimize):
    """minimize(sphere), or maximize(-sphere): ``signed`` flips the objective
    and ``_finalize`` flips f_value back, in both packages."""
    x0, jcfg, tcfg, keys, lo, hi, clamp = pso_case(mode, max_iter=40, best_value_no_change=6)
    bounds = JBounds(-1.0, 1.5) if clamp else None
    sign = 1.0 if minimize else -1.0
    jfn = lambda x: sign * JP["sphere"].fn(x)              # noqa: E731
    tfn = lambda x: sign * nt.PROBLEMS["sphere"].fn(x)     # noqa: E731
    want = jax.jit(lambda x, k: jpsb.minimize_batched(jfn, x, jcfg, bounds, keys=k,
                                                      _minimize=minimize))(jnp.asarray(x0), keys)
    got = pso_minimize_on_jax_draws(jfn, tfn, x0, tcfg, jcfg, keys, lo, hi, clamp, minimize)
    assert_results_match(got, want)
    assert bool(np.asarray(want.converged).any())


def test_pso_swarm_best_takes_the_first_minimum_like_the_one_hot():
    """argmin + gather against JAX's one-hot mask, with ties: both take the
    first minimal particle."""
    rng = np.random.default_rng(3)
    pos = rng.standard_normal((N, P, B))
    vals = rng.integers(0, 3, (P, B)).astype(np.float64)   # many ties
    idx = jnp.argmin(vals, axis=0)
    onehot = jnp.arange(P)[:, None] == idx[None, :]
    want = np.asarray(jnp.sum(jnp.where(onehot[None], pos, 0.0), axis=1))
    v, got = tpsb._swarm_best(torch.from_numpy(vals), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), vals.min(axis=0))


def test_pso_state_round_trip_from_jax():
    x0, jcfg, _, keys, lo, hi, _ = pso_case("accelerated")
    js = jpsb.init(JP["sphere"].fn, jnp.asarray(x0), jcfg, keys, jnp.asarray(lo), jnp.asarray(hi))
    fields = as_numpy(js)
    ts = pso_batch_state_from_numpy({**fields, "keys": jax.random.key_data(js.keys)}, "cpu")
    back = pso_batch_state_to_numpy(ts)
    assert sorted(back) == sorted(fields)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    with pytest.raises(ValueError, match="missing"):
        pso_batch_state_from_numpy({k: v for k, v in fields.items() if k != "velocities"}, "cpu")


def test_pso_route_minimize_maximize_and_bounds():
    fn = nt.PROBLEMS["sphere"].fn
    x0 = torch.full((16, 3), 1.5, dtype=torch.float64)
    cfg = nt.PSOConfig(n_particles=16, max_iter=300)
    res = nt.minimize(fn, x0, method="pso", layout="batched", config=cfg,
                      generator=torch.Generator().manual_seed(1))
    assert res.x.shape == (16, 3) and res.x.dtype == torch.float64
    # a lane halts on a tolerance (converged) or on max_iter
    assert (res.converged | (res.iterations == 300)).all() and bool(res.converged.any())
    assert float(res.f_value.max()) < 1e-2
    neg = nt.maximize(lambda x: -fn(x), x0, method="pso_batched", layout="batched", config=cfg,
                      generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(neg.f_value, -res.f_value, rtol=0, atol=0)
    torch.testing.assert_close(neg.x, res.x, rtol=0, atol=0)
    box = nt.minimize(lambda x: fn(x - 3.0), x0, method="pso", layout="batched", config=cfg,
                      bounds=TBounds(-1.0, 2.0), generator=torch.Generator().manual_seed(2))
    assert float(box.x.min()) >= -1.0 and float(box.x.max()) <= 2.0
    assert float((box.x - 2.0).abs().max()) < 1e-2      # the box's corner nearest 3


def test_pso_default_config_route_runs():
    res = nt.minimize(nt.PROBLEMS["sphere"].fn, torch.full((4, 2), 0.5), method="pso",
                      layout="batched")
    assert res.x.shape == (4, 2) and res.x.dtype == torch.float32
    assert bool(res.converged.all())


def test_step_needs_draws_or_generator():
    x0, _, tcfg, _, lo, hi, _ = pso_case("vanilla")
    fn = nt.PROBLEMS["sphere"].fn
    with pytest.raises(ValueError, match="generator"):
        tpsb.init(fn, torch.from_numpy(x0), tcfg, torch.from_numpy(lo), torch.from_numpy(hi))
    state = tpsb.init(fn, torch.from_numpy(x0), tcfg, torch.from_numpy(lo), torch.from_numpy(hi),
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        tpsb.step(fn, state, tcfg)
    s = tsnb.init(fn, torch.from_numpy(x0), TSANNConfig())
    with pytest.raises(ValueError, match="generator"):
        tsnb.step(fn, s, TSANNConfig())


# ---- SANN -----------------------------------------------------------------

def sann_step_draws(keys, n_inner, n):
    """The draws JAX's step makes from ``keys`` (sann_batched.py:82-99):
    noise [n_inner, n, B], uniforms [n_inner, B]."""
    def one(key):
        _, k_inner = jax.random.split(key)

        def proposal(j):
            k_step, k_accept = jax.random.split(jax.random.fold_in(k_inner, j))
            return (jax.random.normal(k_step, (n,), jnp.float64),
                    jax.random.uniform(k_accept, (), dtype=jnp.float64))

        return jax.vmap(proposal)(jnp.arange(n_inner))

    noise, u = jax.vmap(one, out_axes=(-1, -1))(keys)
    return tsnb.SANNDraws(torch.tensor(np.asarray(noise)), torch.tensor(np.asarray(u)))


@pytest.mark.parametrize("vs_best", [False, True], ids=["vs_current", "vs_best"])
@pytest.mark.parametrize("problem", ["rastrigin", "sphere"])
def test_sann_init_and_steps_match_jax(vs_best, problem):
    x0 = np.random.default_rng(2).uniform(-2.0, 2.0, (B, N))
    kw = dict(max_iter=6, temperature_iter=5, temperature_max=3.0, metropolis_vs_best=vs_best)
    jcfg, tcfg = JSANNConfig(**kw), TSANNConfig(**kw)
    jfn, tfn = JP[problem].fn, nt.PROBLEMS[problem].fn
    keys = jax.random.split(jax.random.key(11), B)
    js = jsnb.init(jfn, jnp.asarray(x0), jcfg, keys)
    ts = tsnb.init(tfn, torch.from_numpy(x0), tcfg)
    assert_match(sann_batch_state_to_numpy(ts), js, "init")
    frozen = np.arange(B) % 3 == 1
    js = js._replace(done=jnp.asarray(frozen))
    ts = ts._replace(done=torch.from_numpy(frozen))
    jstep = jax.jit(lambda s: jsnb.step(jfn, s, jcfg))
    accepted = 0
    for k in range(8):
        draws = sann_step_draws(js.keys, kw["temperature_iter"] - 1, N)
        before = np.asarray(js.f_p)
        js = jstep(js)
        accepted += int((np.asarray(js.f_p) != before).sum())
        ts = tsnb.step(tfn, ts, tcfg, draws=draws)
        assert_match(sann_batch_state_to_numpy(ts), js, f"step {k}")
    assert bool(np.asarray(js.done).all()) and accepted > 0
    assert (np.asarray(js.iteration)[frozen] == 0).all()
    assert (np.asarray(js.iteration)[~frozen] == 6).all()


@pytest.mark.parametrize("minimize", [True, False], ids=["minimize", "maximize"])
def test_sann_minimize_matches_jax(minimize):
    x0 = np.random.default_rng(4).uniform(-2.0, 2.0, (B, N))
    kw = dict(max_iter=10, temperature_iter=4)
    jcfg, tcfg = JSANNConfig(**kw), TSANNConfig(**kw)
    jfn = JP["rastrigin"].fn if minimize else (lambda x: -JP["rastrigin"].fn(x))
    tfn = nt.PROBLEMS["rastrigin"].fn if minimize else (lambda x: -nt.PROBLEMS["rastrigin"].fn(x))
    keys = jax.random.split(jax.random.key(7), B)
    want = jax.jit(lambda x, k: jsnb.minimize_batched(jfn, x, jcfg, keys=k,
                                                      _minimize=minimize))(jnp.asarray(x0), keys)
    sj, st = signed(jfn, minimize), signed(tfn, minimize)
    js, ts = jsnb.init(sj, jnp.asarray(x0), jcfg, keys), tsnb.init(st, torch.from_numpy(x0), tcfg)
    jstep = jax.jit(lambda s: jsnb.step(sj, s, jcfg))
    while not bool(ts.done.all()):
        draws = sann_step_draws(js.keys, kw["temperature_iter"] - 1, N)
        js = jstep(js)
        ts = tsnb.step(st, ts, tcfg, draws=draws)
    assert_results_match(tsnb._finalize(ts, flip_sign=not minimize), want)


def test_sann_refuses_bounds():
    fn = nt.PROBLEMS["sphere"].fn
    x0 = torch.full((4, 2), 0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="unbounded"):
        nt.minimize(fn, x0, method="sann", layout="batched", bounds=TBounds(-1.0, 1.0))
    with pytest.raises(ValueError, match="unbounded"):
        tsnb.minimize_batched(fn, x0, TSANNConfig(max_iter=3), TBounds(-1.0, 1.0))
    # the JAX package takes the same call and ignores the bounds
    res = jsnb.minimize_batched(JP["sphere"].fn, jnp.full((4, 2), 0.5), JSANNConfig(max_iter=3),
                                JBounds(-1.0, 1.0))
    assert res.x.shape == (4, 2)


def test_sann_route_runs_to_max_iter():
    fn = nt.PROBLEMS["sphere"].fn
    x0 = torch.full((8, 3), 1.0, dtype=torch.float64)
    cfg = nt.SANNConfig(max_iter=40)
    res = nt.minimize(fn, x0, method="sann", layout="batched", config=cfg,
                      generator=torch.Generator().manual_seed(0))
    assert res.iterations.tolist() == [40] * 8 and bool(res.converged.all())
    assert res.function_calls.tolist() == [1 + 40 * 9] * 8
    assert float(res.f_value.max()) < 3.0
    neg = nt.maximize(lambda x: -fn(x), x0, method="sann_batched", layout="batched", config=cfg,
                      generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(neg.f_value, -res.f_value, rtol=0, atol=0)


def test_sann_state_round_trip_from_jax():
    keys = jax.random.split(jax.random.key(1), B)
    js = jsnb.init(JP["sphere"].fn, jnp.ones((B, N)), JSANNConfig(), keys)
    fields = as_numpy(js)
    back = sann_batch_state_to_numpy(sann_batch_state_from_numpy(
        {**fields, "keys": jax.random.key_data(js.keys)}, "cpu"))
    assert sorted(back) == sorted(fields)
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k


def _jrosen(x):
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


def _trosen(x):
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


def test_pso_single_point_objective_at_b_equal_n_matches_jax():
    """F2: Rosenbrock written on one point (x[0], x[1]) at B = n = 2.  On
    the whole [P, B, n] batch x[0] would be a slab of particles; scored
    through vmap as in JAX, every state matches the JAX engine's on its own
    draws."""
    b = n = 2
    x0 = np.random.default_rng(6).uniform(0.5, 2.0, (b, n))
    cfg = dict(n_particles=P, max_iter=5, best_value_no_change=1 << 30, eps=0.0)
    jcfg, tcfg = JPSOConfig(**cfg), TPSOConfig(**cfg)
    keys = jax.random.split(jax.random.key(13), b)
    lo, hi = -np.abs(x0.T), np.abs(x0.T)
    js = jpsb.init(_jrosen, jnp.asarray(x0), jcfg, keys, jnp.asarray(lo), jnp.asarray(hi))
    ts = tpsb.init(_trosen, torch.from_numpy(x0), tcfg, torch.from_numpy(lo), torch.from_numpy(hi),
                   draws=pso_init_draws(keys, n, P))
    assert_match(pso_batch_state_to_numpy(ts), js, "init")
    jstep = jax.jit(lambda s: jpsb.step(_jrosen, s, jcfg, jnp.asarray(lo), jnp.asarray(hi), False))
    for k in range(4):
        draws = pso_step_draws(js.keys, n, P, False)
        js = jstep(js)
        ts = tpsb.step(_trosen, ts, tcfg, torch.from_numpy(lo), torch.from_numpy(hi), False,
                       draws=draws)
        assert_match(pso_batch_state_to_numpy(ts), js, f"step {k}")


def test_sann_single_point_objective_at_b_equal_n_matches_jax():
    """F2: the case ROADMAP.md recorded, Rosenbrock on one point at B = n =
    2, where a whole-batch call returned another lane's value.  Scored
    through vmap as in JAX, every state matches the JAX engine's, and each
    chain's value is the objective at its point."""
    b = n = 2
    x0 = np.random.default_rng(8).uniform(-2.0, 2.0, (b, n))
    kw = dict(max_iter=5, temperature_iter=4)
    jcfg, tcfg = JSANNConfig(**kw), TSANNConfig(**kw)
    keys = jax.random.split(jax.random.key(17), b)
    js = jsnb.init(_jrosen, jnp.asarray(x0), jcfg, keys)
    ts = tsnb.init(_trosen, torch.from_numpy(x0), tcfg)
    assert_match(sann_batch_state_to_numpy(ts), js, "init")
    jstep = jax.jit(lambda s: jsnb.step(_jrosen, s, jcfg))
    for k in range(5):
        draws = sann_step_draws(js.keys, kw["temperature_iter"] - 1, n)
        js = jstep(js)
        ts = tsnb.step(_trosen, ts, tcfg, draws=draws)
        assert_match(sann_batch_state_to_numpy(ts), js, f"step {k}")
    for lane in range(b):
        assert float(ts.f_p[lane]) == float(_trosen(ts.p[:, lane]))
