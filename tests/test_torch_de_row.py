"""nlsolver_torch's row-layout DE on lane tensors against ``jax.vmap`` of the
JAX solver, lane by lane, in float64 on the CPU, each lane's JAX key chain
replayed with ``jax.random`` and its draws handed to the port as
``draws=``: both recombination strategies at n = 2, 3 and 5, a max_iter
that cuts lanes short, one point, the partner sampler on injected draws,
the refusal of ``bounds`` and a state carried across the packages.

The lanes (tests/torch_free_common.py): bowls, Rosenbrock, a Rastrigin
start and a flat lane whose spread test fires at once, from starts three
times as wide (x0 is the population's per-dimension width).
``iterations``, ``function_calls`` and ``converged`` are equal lane by
lane, and ``x`` and ``f_value`` agree within ``XTOL`` relative to
max(|value|, 1): the jitted JAX program contracts the donor's
``a + F (b - c)`` into a fused multiply-add (some 1e-11 at most was read
here), which moved no selection on these lanes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_free_common import (B, chain, j_objective, jax_vmapped, keys_for, lanes, t_objective,
                               torch_data)
from torch_lanes_common import COUNTERS, fields, hold

import nlsolver_torch as nt
from nlsolver_torch.random.sampling import distinct_indices
from nlsolver_torch.solvers import de as td
from nlsolver_tpu.solvers import de as jd

torch.set_num_threads(1)

XTOL = 1e-9
CASES = {
    "random_n2": (2, {}),
    "random_n3": (3, {}),
    "random_n5": (5, {}),
    "best_n3": (3, {"strategy": "best"}),
    "best_n5": (5, {"strategy": "best"}),
    "max_iter": (3, {"max_iter": 30}),
}
BASE = {"pop_size": 12, "max_iter": 300}


def de_draws(keys, T, P, n, dtype=jnp.float64, init=True):
    """The draws of ``de.init`` and ``de.step`` (nlsolver_tpu/solvers/de.py:
    93-94, 129-137) down each lane's key chain, the partners as
    ``distinct_indices``' raw ``randint`` draws of ``split(k_idx, 3)``
    (nlsolver_tpu/random/sampling.py:41-47); with ``init=False`` the keys
    are states' keys, and the chain starts at a step."""
    def first(key):
        if not init:
            return key, None
        key, k_init = jax.random.split(key)
        return key, jax.random.uniform(k_init, (P, n), dtype=dtype)

    def body(key):
        key, k_idx, k_dim, k_cross = jax.random.split(key, 4)
        ks = jax.random.split(k_idx, 3)
        raw = jnp.stack([jax.random.randint(ks[j], (P,), 0, P - 1 - j, dtype=jnp.int32)
                         for j in range(3)], axis=-1)
        return key, (raw, jax.random.randint(k_dim, (P,), 0, n),
                     jax.random.uniform(k_cross, (P, n), dtype=dtype))

    return chain(keys, T, first, body, step_cls=td.StepDraws)


@pytest.fixture(scope="module")
def runs():
    out = {}

    def get(case):
        if case not in out:
            n, kw = CASES[case]
            kw = {**BASE, **kw}
            x0, k, c, w = lanes(n, scale=3.0)
            keys = keys_for(11 + n)
            want = fields(jax_vmapped(jd.minimize, jd.DEConfig(**kw))(x0, k, c, w, keys))
            draws = de_draws(keys, kw["max_iter"] + 1, kw["pop_size"], n)
            got = fields(td.minimize_batched(t_objective, torch.from_numpy(x0), td.DEConfig(**kw),
                                             draws=draws, data=torch_data(k, c, w)))
            out[case] = (got, want)
        return out[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_vmap_lane_by_lane(case, runs):
    got, want = runs(case)
    hold(got, want, 0, XTOL)


def test_flat_lane_halts_at_once_and_max_iter_cuts_short(runs):
    got, _ = runs("random_n3")
    assert got["iterations"][5] == 0 and got["converged"][5]
    assert got["function_calls"][5] == BASE["pop_size"]
    cut, want = runs("max_iter")
    hit = cut["iterations"] == 30
    assert hit.any() and not cut["converged"][hit].any()
    np.testing.assert_array_equal(hit, want["iterations"] == 30)


def test_single_point_matches_jax():
    """``minimize(fn, x0[n])`` with one key's draws (no lane axis) against
    the JAX ``minimize`` with that key, and ``maximize`` of -f the same."""
    x0, k, c, w = lanes(3, scale=3.0)
    lane = 2
    key = jax.random.key(7)
    cfg = {**BASE}
    want = fields(jax.jit(lambda x: jd.minimize(
        lambda p: j_objective(p, k[lane], c[lane], w[lane]), x, jd.DEConfig(**cfg), key=key))(
            x0[lane]))
    d = de_draws(key[None], cfg["max_iter"] + 1, cfg["pop_size"], 3)
    one = td.Draws(d.init[0], td.StepDraws(*(a[:, 0] for a in d.steps)))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in (k[lane], c[lane], w[lane]))
    got = fields(td.minimize(t_objective, torch.from_numpy(x0[lane]), td.DEConfig(**cfg),
                             draws=one, data=data))
    up = fields(td.maximize(lambda x, dd: -t_objective(x, dd), torch.from_numpy(x0[lane]),
                            td.DEConfig(**cfg), draws=one, data=data))
    for res in (got, up):
        for f in COUNTERS:
            assert res[f] == want[f], f
        np.testing.assert_allclose(res["x"], want["x"], rtol=0, atol=XTOL)
    np.testing.assert_allclose(up["f_value"], -want["f_value"], rtol=0, atol=XTOL)


@pytest.mark.parametrize("pop", [4, 5, 12])
def test_partners_from_raw_draws_match_jax(pop):
    """``distinct_indices`` on the raw draws of a key against the JAX
    sampler on that key: the same partners, distinct from each other and
    from the fixed index."""
    from nlsolver_tpu.random.sampling import distinct_indices as jdistinct

    for seed, fixed in ((0, np.arange(pop)), (1, np.full(pop, pop - 1)), (2, np.zeros(pop, int))):
        key = jax.random.key(seed)
        want = np.asarray(jdistinct(key, pop, jnp.asarray(fixed, jnp.int32), k=3))
        ks = jax.random.split(key, 3)
        raw = np.stack([np.asarray(jax.random.randint(ks[j], (pop,), 0, pop - 1 - j,
                                                      dtype=jnp.int32)) for j in range(3)], -1)
        got = distinct_indices(None, pop, torch.from_numpy(fixed), k=3,
                               raw=torch.from_numpy(raw)).numpy()
        np.testing.assert_array_equal(got, want)
        every = np.concatenate([fixed[:, None], got], axis=1)
        assert all(len(set(row)) == 4 for row in every)


def test_refuses_bounds():
    """The JAX row-layout DE takes bounds and ignores them; the port
    refuses them, single and batched, and names routes that take a box."""
    x0 = torch.ones(2, 3, dtype=torch.float64)
    for call in (lambda: td.minimize(t_objective, x0[0], bounds=nt.Bounds(-1.0, 1.0)),
                 lambda: td.minimize_batched(t_objective, x0, bounds=nt.Bounds(-1.0, 1.0)),
                 lambda: nt.minimize(lambda x: (x ** 2).sum(), x0[0], method="de",
                                     bounds=nt.Bounds(-1.0, 1.0))):
        with pytest.raises(ValueError, match="takes no bounds=.*'pso' or 'nmpso'"):
            call()


def test_generator_draws_are_reproducible():
    """Without draws, the generator (seed 0 by default) draws them: the
    same seed gives the same run, and the population starts inside the
    width x0 sets."""
    x0, k, c, w = lanes(3, scale=3.0)
    cfg = td.DEConfig(pop_size=12, max_iter=50)
    run = [fields(td.minimize_batched(t_objective, torch.from_numpy(x0), cfg,
                                      data=torch_data(k, c, w), generator=g))
           for g in (None, torch.Generator().manual_seed(0))]
    for f in run[0]:
        np.testing.assert_array_equal(run[0][f], run[1][f])
    state = td.init(t_objective, torch.from_numpy(x0), cfg, data=torch_data(k, c, w),
                    generator=torch.Generator().manual_seed(3))
    assert (state.agents.abs() <= 0.5 * torch.from_numpy(np.abs(x0))[:, None]).all()


@pytest.mark.parametrize("strategy", ["random", "best"])
def test_states_cross_packages(strategy):
    """A JAX state after a vmapped step, carried into the port by
    ``interop`` (its key dropped), stepped once by each package on the
    JAX step's draws: the same state, back as numpy."""
    from nlsolver_torch import interop

    x0, k, c, w = lanes(3, scale=3.0)
    cfg = jd.DEConfig(pop_size=12, strategy=strategy)
    keys = keys_for(21)

    def two(x, kk, cc, ww, key):
        f = lambda p: j_objective(p, kk, cc, ww)  # noqa: E731
        s = jd.step(f, jd.init(f, x, cfg, key), cfg)
        return s, jd.step(f, s, cfg)

    s1, s2 = jax.jit(jax.vmap(two))(x0, k, c, w, keys)
    carried = {f: np.asarray(v) for f, v in s1._asdict().items() if f != "key"}
    ts = interop.de_row_state_from_numpy(carried, "cpu")
    draws = de_draws(s1.key, 1, 12, 3, init=False).steps
    back = interop.de_row_state_to_numpy(td.step(
        t_objective, ts, td.DEConfig(pop_size=12, strategy=strategy),
        draws=td.StepDraws(*(a[0] for a in draws)), data=torch_data(k, c, w)))
    assert set(back) == set(carried)
    for f, v in back.items():
        want = np.asarray(getattr(s2, f))
        assert v.dtype == want.dtype, f
        np.testing.assert_allclose(v, want, rtol=1e-12, atol=1e-12, err_msg=f)


def test_config_fields_unchanged():
    import dataclasses

    def spec(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert spec(jd.DEConfig) == spec(td.DEConfig)
    assert B == 8
