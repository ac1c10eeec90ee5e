"""nlsolver_torch's NM-PSO hybrid on lane tensors against ``jax.vmap`` of
the JAX solver, lane by lane, in float64 on the CPU, each lane's JAX key
chain replayed with ``jax.random`` and its draws handed to the port as
``draws=``: unbounded (the implied bounds +-|2.5 x0| only seed the PSO
particles) and in a box, at n = 2, 3 and 5; one point; the refusal of
n < 2; the stable ranking on tied values; and a state carried across the
packages.

The lanes (tests/torch_free_common.py): bowls, Rosenbrock, a Rastrigin
start and a flat lane whose spread test fires at once.  ``iterations``,
``function_calls`` and ``converged`` are equal lane by lane, and ``x`` and
``f_value`` agree within ``XTOL`` relative to max(|value|, 1): the jitted
JAX program contracts ``a * b + c`` into fused multiply-adds (some 5e-12 at
most was read here), which moved no branch and no stop on these lanes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_free_common import (B, chain, j_objective, jax_vmapped, keys_for, lanes, t_objective,
                               torch_data)
from torch_lanes_common import COUNTERS, fields, hold

import nlsolver_torch as nt
from nlsolver_torch.solvers import nmpso as tm
from nlsolver_tpu.solvers import nmpso as jm

torch.set_num_threads(1)

XTOL = 1e-9
BOX = (-2.0, 1.5)
CASES = {"n2": (2, {}, False), "n3": (3, {}, False), "boxed_n3": (3, {}, True),
         "n5": (5, {}, False), "max_iter": (3, {"max_iter": 40}, False)}
BASE = {"max_iter": 300}


def nmpso_draws(keys, T, n, dtype=jnp.float64, init=True):
    """The draws of ``nmpso.init`` and ``nmpso.step`` (nlsolver_tpu/solvers/
    nmpso.py:97-105, 241-243) down each lane's key chain."""
    m = 2 * n

    def first(key):
        if not init:
            return key, None
        key, k_pos, k_vel = jax.random.split(key, 3)
        return key, (jax.random.uniform(k_pos, (m, n), dtype=dtype),
                     jax.random.uniform(k_vel, (m, n), dtype=dtype))

    def body(key):
        key, k_p, k_g = jax.random.split(key, 3)
        return key, (jax.random.uniform(k_p, (m, n), dtype=dtype),
                     jax.random.uniform(k_g, (m, n), dtype=dtype))

    return chain(keys, T, first, body, tm.InitDraws if init else None, tm.StepDraws)


@pytest.fixture(scope="module")
def runs():
    out = {}

    def get(case):
        if case not in out:
            n, kw, boxed = CASES[case]
            kw = {**BASE, **kw}
            x0, k, c, w = lanes(n)
            keys = keys_for(60 + n)
            lohi = tuple(np.full_like(x0, v) for v in BOX) if boxed else ()
            want = fields(jax_vmapped(jm.minimize, jm.NMPSOConfig(**kw), bounded=boxed)(
                x0, k, c, w, keys, *lohi))
            draws = nmpso_draws(keys, kw["max_iter"] + 1, n)
            tb = nt.Bounds(*(torch.from_numpy(a) for a in lohi)) if boxed else None
            got = fields(tm.minimize_batched(t_objective, torch.from_numpy(x0),
                                             tm.NMPSOConfig(**kw), tb, draws=draws,
                                             data=torch_data(k, c, w)))
            out[case] = (got, want)
        return out[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_vmap_lane_by_lane(case, runs):
    got, want = runs(case)
    hold(got, want, 0, XTOL)


def test_lanes_halt_at_once_at_max_iter_and_in_their_box(runs):
    got, _ = runs("n3")
    assert got["iterations"][5] == 0 and got["converged"][5]
    assert got["function_calls"][5] == 3 * 3 + 1
    cut, want = runs("max_iter")
    hit = cut["iterations"] == 40
    assert hit.any() and not cut["converged"][hit].any()
    np.testing.assert_array_equal(hit, want["iterations"] == 40)
    boxed, _ = runs("boxed_n3")
    assert ((boxed["x"] >= BOX[0]) & (boxed["x"] <= BOX[1])).all()


def test_single_point_matches_jax():
    """``minimize(fn, x0[n])`` with one key's draws (no lane axis) against
    the JAX ``minimize`` with that key, and ``maximize`` of -f the same."""
    x0, k, c, w = lanes(3)
    lane = 2
    key = jax.random.key(13)
    want = fields(jax.jit(lambda x: jm.minimize(
        lambda p: j_objective(p, k[lane], c[lane], w[lane]), x, jm.NMPSOConfig(**BASE),
        key=key))(x0[lane]))
    d = nmpso_draws(key[None], BASE["max_iter"] + 1, 3)
    one = tm.Draws(tm.InitDraws(*(a[0] for a in d.init)),
                   tm.StepDraws(*(a[:, 0] for a in d.steps)))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in (k[lane], c[lane], w[lane]))
    got = fields(tm.minimize(t_objective, torch.from_numpy(x0[lane]), tm.NMPSOConfig(**BASE),
                             draws=one, data=data))
    up = fields(tm.maximize(lambda x, dd: -t_objective(x, dd), torch.from_numpy(x0[lane]),
                            tm.NMPSOConfig(**BASE), draws=one, data=data))
    for res in (got, up):
        for f in COUNTERS:
            assert res[f] == want[f], f
        np.testing.assert_allclose(res["x"], want["x"], rtol=0, atol=XTOL)
    np.testing.assert_allclose(up["f_value"], -want["f_value"], rtol=0, atol=XTOL)


def test_refuses_one_dimension_as_jax_does():
    x0 = np.zeros(1)
    with pytest.raises(ValueError) as want:
        jm.minimize(lambda p: jnp.sum(p ** 2), jnp.asarray(x0))
    with pytest.raises(ValueError) as got:
        tm.minimize(lambda p: (p ** 2).sum(), torch.from_numpy(x0))
    assert str(got.value) == str(want.value)


def test_stable_ranking_on_ties_matches_jax():
    """One step from a population whose values tie (a flat objective off
    the simplex, a bowl on it): the ranking is a stable sort, as
    ``jnp.argsort``, so the same particles form the simplex and pair up."""
    n = 3
    x0 = np.array([[0.3, -0.2, 0.1], [1.0, 1.0, 1.0]])

    def jf(p):
        return jnp.minimum(jnp.sum(p ** 2), 1.0)

    def tf(p):
        return torch.clamp((p ** 2).sum(), max=1.0)

    keys = keys_for(70, 2)
    cfg = jm.NMPSOConfig()

    def two(x, key):
        t = jnp.abs(2.5 * x)
        s = jm.init(jf, x, cfg, key, -t, t)
        return s, jm.step(jf, s, cfg, -t, t, False)

    s1, s2 = jax.jit(jax.vmap(two))(x0, keys)
    assert (np.asarray(s1.values) == 1.0).sum(axis=1).min() >= 2
    from nlsolver_torch import interop

    ts = interop.nmpso_state_from_numpy(
        {f: np.asarray(v) for f, v in s1._asdict().items() if f != "key"}, "cpu")
    d = nmpso_draws(s1.key, 1, n, init=False).steps
    t = (2.5 * torch.from_numpy(x0)).abs()
    back = interop.nmpso_state_to_numpy(tm.step(tf, ts, tm.NMPSOConfig(), -t, t, False,
                                                draws=tm.StepDraws(*(a[0] for a in d))))
    for f, v in back.items():
        np.testing.assert_allclose(v, np.asarray(getattr(s2, f)), rtol=1e-12, atol=1e-12,
                                   err_msg=f)


@pytest.mark.parametrize("boxed", [False, True])
def test_states_cross_packages(boxed):
    """A JAX state after a vmapped step, carried into the port by
    ``interop`` (its key dropped), stepped once by each package on the
    JAX step's draws: the same state, back as numpy."""
    from nlsolver_torch import interop

    x0, k, c, w = lanes(3)
    keys = keys_for(80)
    cfg = jm.NMPSOConfig()
    lo, hi = (np.full_like(x0, v) for v in BOX) if boxed else (-np.abs(2.5 * x0),
                                                              np.abs(2.5 * x0))

    def two(x, kk, cc, ww, key, a, b):
        f = lambda p: j_objective(p, kk, cc, ww)  # noqa: E731
        s = jm.step(f, jm.init(f, x, cfg, key, a, b), cfg, a, b, boxed)
        return s, jm.step(f, s, cfg, a, b, boxed)

    s1, s2 = jax.jit(jax.vmap(two))(x0, k, c, w, keys, lo, hi)
    carried = {f: np.asarray(v) for f, v in s1._asdict().items() if f != "key"}
    ts = interop.nmpso_state_from_numpy(carried, "cpu")
    d = nmpso_draws(s1.key, 1, 3, init=False).steps
    back = interop.nmpso_state_to_numpy(tm.step(
        t_objective, ts, tm.NMPSOConfig(), torch.from_numpy(lo), torch.from_numpy(hi), boxed,
        draws=tm.StepDraws(*(a[0] for a in d)), data=torch_data(k, c, w)))
    assert set(back) == set(carried)
    for f, v in back.items():
        want = np.asarray(getattr(s2, f))
        assert v.dtype == want.dtype, f
        np.testing.assert_allclose(v, want, rtol=1e-12, atol=1e-12, err_msg=f)


def test_config_fields_match_jax():
    def spec(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert spec(jm.NMPSOConfig) == spec(tm.NMPSOConfig)
    assert B == 8
