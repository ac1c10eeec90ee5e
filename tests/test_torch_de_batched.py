"""nlsolver_torch.solvers.de_batched against nlsolver_tpu.solvers.de_batched.

Both packages start from the same state (carried across as numpy) and step
on the same draws: the ones the JAX engine's key schedule gives for each
generation (de_batched.py:98,123-124,141-146 and ``distinct_indices``),
read from the JAX state as it steps.  f64 on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlsolver_torch as nt
from nlsolver_torch.interop import de_state_from_numpy, de_state_to_numpy
from nlsolver_torch.solvers import de_batched as tdeb
from nlsolver_torch.solvers.de import DEConfig as TConfig
from nlsolver_tpu.problems import PROBLEMS as JP
from nlsolver_tpu.random.sampling import distinct_indices
from nlsolver_tpu.solvers import de_batched as jdeb
from nlsolver_tpu.solvers.de import DEConfig as JConfig

torch.set_num_threads(1)
RTOL = 1e-12
# the JAX uniform path forms the donor through a one-hot matmul, which sums
# the same three terms in another order: absolute slack near a zero donor
ATOL = 1e-14
B, N, P = 8, 3, 12
INT_FIELDS = ("iteration", "nfev", "val_no_change", "done", "converged")


def jax_init_draws(keys, n, P, dtype):
    def one(key):
        _, k = jax.random.split(key)
        return jax.random.uniform(k, (n, P), dtype=dtype)
    return np.asarray(jax.vmap(one)(keys))


def jax_step_draws(state, cfg):
    """The draws JAX's ``step`` makes from ``state`` (de_batched.py:98-146)."""
    _, n, P = state.agents.shape
    dtype = state.agents.dtype

    def one(key, scores):
        k_idx, k_dim, k_cross, _ = jax.random.split(key, 4)
        if cfg.strategy == "best":
            fixed = jnp.broadcast_to(jnp.argmin(scores).astype(jnp.int32), (P,))
        else:
            fixed = jnp.arange(P, dtype=jnp.int32)
        return (
            jax.random.uniform(k_cross, (n, P), dtype=dtype),
            jax.random.randint(k_dim, (P,), 0, n),
            distinct_indices(k_idx, P, fixed, k=3),
        )

    u, fdim, partners = jax.vmap(one)(state.keys, state.scores)
    third = max(P // 3, 1)
    ko = jax.random.fold_in(state.keys[0], state.iteration[0])
    offs = tuple(int(jax.random.randint(jax.random.fold_in(ko, i), (), lo, hi))
                 for i, (lo, hi) in enumerate(
                     ((1, third + 1), (third + 1, 2 * third + 1), (2 * third + 1, P)), 1))
    return tdeb.DEDraws(
        u=torch.tensor(np.asarray(u)),
        fdim=torch.tensor(np.asarray(fdim)),
        offs=offs if cfg.partner_sampling == "rotation" else None,
        partners=torch.tensor(np.asarray(partners)),
    )


def as_numpy(state):
    fields = state._asdict()
    fields["keys"] = jax.random.key_data(fields["keys"])
    return {k: np.asarray(v) for k, v in fields.items()}


def assert_states_match(t, j):
    got = de_state_to_numpy(t)
    for f in ("agents", "scores", "best_value"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(j, f)), rtol=RTOL, atol=ATOL,
                                   err_msg=f)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j, f)), err_msg=f)


def test_config_fields_and_defaults_match_jax():
    tf = [(f.name, f.type, f.default) for f in dataclasses.fields(TConfig)]
    jf = [(f.name, f.type, f.default) for f in dataclasses.fields(JConfig)]
    assert tf == jf


def test_init_matches_on_injected_uniforms():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0.5, 2.0, (B, N))
    cfg = JConfig(pop_size=P)
    keys = jax.random.split(jax.random.key(3), B)
    j = jdeb.init(JP["rastrigin"].fn, jnp.asarray(x0), cfg, keys)
    u = jax_init_draws(keys, N, P, jnp.float64)
    t = tdeb.init(nt.PROBLEMS["rastrigin"].fn, torch.from_numpy(x0), TConfig(pop_size=P),
                  draws=torch.tensor(u))
    assert_states_match(t, j)


# per problem: init widths and an eps that stops lanes at different
# generations, some by eps and some by max_iter
CASES = {"rastrigin": ((0.05, 0.8), 1.0), "sphere": ((0.2, 3.0), 0.1)}


@pytest.mark.parametrize("sampling,strategy,problem", [
    ("rotation", "random", "rastrigin"),
    ("rotation", "best", "sphere"),
    ("uniform", "random", "rastrigin"),
    ("uniform", "best", "sphere"),
])
def test_steps_match_jax(sampling, strategy, problem):
    (lo, hi), eps = CASES[problem]
    x0 = np.random.default_rng(1).uniform(lo, hi, (B, N))
    kw = dict(pop_size=P, partner_sampling=sampling, strategy=strategy,
              eps=eps, max_iter=8)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jfn, tfn = JP[problem].fn, nt.PROBLEMS[problem].fn
    j = jdeb.init(jfn, jnp.asarray(x0), jcfg, jax.random.split(jax.random.key(7), B))
    jstep = jax.jit(lambda s: jdeb.step(jfn, s, jcfg))
    t = de_state_from_numpy(as_numpy(j), "cpu")
    for _ in range(10):
        draws = jax_step_draws(j, jcfg)
        j = jstep(j)
        t = tdeb.step(tfn, t, tcfg, draws=draws)
        assert_states_match(t, j)
    # eps and max_iter make lanes stop at different generations
    iters = de_state_to_numpy(t)["iteration"]
    assert iters.min() < iters.max()
    assert t.done.all() and t.converged.any()


def test_plain_and_fused_paths_agree_on_cpu():
    # use_fused_kernel on a CPU tensor runs the kernel's twin: on the same
    # draws it is the plain rotation step exactly
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.uniform(0.5, 2.0, (B, N)))
    kw = dict(pop_size=P, partner_sampling="rotation", eps=0.2)
    plain, fused = TConfig(**kw), TConfig(**kw, use_fused_kernel=True)
    fn = nt.PROBLEMS["rastrigin"].fn
    g = torch.Generator().manual_seed(5)
    a = b = tdeb.init(fn, x0, plain, generator=g, seed=11)
    for _ in range(6):
        draws = tdeb._plain_draws(a, plain, g, rotation=True)
        a = tdeb.step(fn, a, plain, draws=draws)
        b = tdeb.step(fn, b, fused, draws=draws)
    for f in tdeb.DEBatchState._fields:
        ga, gb = getattr(a, f), getattr(b, f)
        assert torch.equal(ga, gb) if isinstance(ga, torch.Tensor) else ga == gb, f


def test_ring_offsets_are_distinct_nonzero_and_vary():
    seen = set()
    for gen in range(50):
        o = tdeb.ring_offsets(64, seed=3, generation=gen)
        assert 0 < o[0] < o[1] < o[2] < 64
        seen.add(o)
    assert len(seen) > 40
    assert tdeb.ring_offsets(64, 3, 9) == tdeb.ring_offsets(64, 3, 9)


@pytest.mark.parametrize("sampling", ["uniform", "rotation"])
@pytest.mark.parametrize("strategy", ["random", "best"])
def test_minimize_converges(sampling, strategy):
    # the criterion of tests/test_de_batched.py::test_converges
    p = nt.PROBLEMS["rosenbrock"]
    cfg = TConfig(strategy=strategy, partner_sampling=sampling)
    x0 = torch.full((16, 2), -0.5, dtype=torch.float64)
    res = nt.minimize(p.fn, x0, method="de", config=cfg, layout="batched",
                      generator=torch.Generator().manual_seed(42))
    dists = p.distance_to_nearest_minimum(res.x)
    assert int((dists <= 0.05).sum()) >= 14, dists
    assert res.x.shape == (16, 2) and res.iterations.dtype == torch.int32


def test_minimize_fused_route_and_maximize():
    fn = nt.PROBLEMS["sphere"].fn
    cfg = TConfig(pop_size=16, partner_sampling="rotation", use_fused_kernel=True,
                  max_iter=60, eps=0.0, best_value_no_change=1 << 30)
    res = nt.minimize(fn, torch.full((8, 3), -0.5), method="de", layout="batched", config=cfg)
    assert res.iterations.tolist() == [60] * 8
    assert float(res.f_value.max()) < 1e-4
    neg = nt.maximize(lambda x: -fn(x), torch.full((8, 3), -0.5), method="de",
                      layout="batched", config=dataclasses.replace(cfg, use_fused_kernel=False))
    assert float(neg.f_value.min()) > -1e-4 and float(neg.f_value.max()) <= 0.0


def test_route_rejects_bounds_and_unported_methods():
    """The lane fleet refuses bounds and names routes that take a box;
    Nelder-Mead runs under both layouts."""
    x0 = torch.full((4, 2), -0.5)
    fn = nt.PROBLEMS["sphere"].fn
    with pytest.raises(ValueError, match="unbounded") as refused:
        nt.minimize(fn, x0, method="de", layout="batched", bounds=(-1.0, 1.0))
    assert "method='pso' or 'nmpso' with bounds=" in str(refused.value)
    many = nt.minimize(fn, x0, method="nelder_mead", layout="batched")
    one = nt.minimize(fn, x0[0], method="nelder_mead")
    assert many.x.shape == (4, 2) and one.x.shape == (2,)
    assert float(many.f_value.max()) < 1e-8 and float(one.f_value) < 1e-8
    with pytest.raises(ValueError, match="layout"):
        nt.minimize(fn, x0, method="de", layout="diagonal")


def test_fused_kernel_requires_rotation():
    cfg = TConfig(max_iter=5, use_fused_kernel=True)  # partner_sampling="uniform"
    fn = nt.PROBLEMS["sphere"].fn
    g = torch.Generator().manual_seed(0)
    state = tdeb.init(fn, torch.full((4, 2), -0.5), cfg, generator=g)
    with pytest.raises(ValueError, match="rotation"):
        tdeb.step(fn, state, cfg, generator=g)


def test_step_needs_draws_or_generator():
    cfg = TConfig(pop_size=8)
    fn = nt.PROBLEMS["sphere"].fn
    with pytest.raises(ValueError, match="generator"):
        tdeb.init(fn, torch.full((4, 2), -0.5), cfg)
    state = tdeb.init(fn, torch.full((4, 2), -0.5), cfg, generator=torch.Generator())
    with pytest.raises(ValueError, match="generator"):
        tdeb.step(fn, state, cfg)


def test_interop_round_trip_drops_keys():
    cfg = JConfig(pop_size=P)
    j = jdeb.init(JP["sphere"].fn, jnp.ones((B, N)), cfg, jax.random.split(jax.random.key(0), B))
    fields = as_numpy(j)
    t = de_state_from_numpy(fields, "cpu", generation=4, seed=9)
    assert (t.generation, t.seed) == (4, 9)
    back = de_state_to_numpy(t)
    assert "keys" not in back
    for k, v in back.items():
        np.testing.assert_array_equal(v, fields[k])
        assert v.dtype == fields[k].dtype
    with pytest.raises(ValueError, match="missing"):
        de_state_from_numpy({"agents": fields["agents"]}, "cpu")


def test_single_point_objective_at_b_equal_n_matches_jax():
    """F2: an objective written on one point, Rosenbrock through x[0] and
    x[1], at B = n = 2 through the plain step.  Called on a whole batch,
    x[0] would be a row of agents with the [B] shape of a lane result and
    the wrong values; scored through vmap as in JAX, every state matches
    the JAX engine's on its own draws."""
    def jrosen(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    def trosen(x):
        return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2

    b = n = 2
    x0 = np.random.default_rng(5).uniform(-1.5, 1.5, (b, n))
    kw = dict(pop_size=P, max_iter=6)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    keys = jax.random.split(jax.random.key(9), b)
    j = jdeb.init(jrosen, jnp.asarray(x0), jcfg, keys)
    t = tdeb.init(trosen, torch.from_numpy(x0), tcfg,
                  draws=torch.tensor(jax_init_draws(keys, n, P, jnp.float64)))
    assert_states_match(t, j)
    jstep = jax.jit(lambda s: jdeb.step(jrosen, s, jcfg))
    for _ in range(4):
        draws = jax_step_draws(j, jcfg)
        j = jstep(j)
        t = tdeb.step(trosen, t, tcfg, draws=draws)
        assert_states_match(t, j)
    agents = t.agents.numpy()
    np.testing.assert_allclose(t.scores.numpy(), [[float(trosen(torch.from_numpy(a[:, p])))
                                                   for p in range(P)] for a in agents],
                               rtol=1e-15)
