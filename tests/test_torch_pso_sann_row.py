"""nlsolver_torch's row-layout PSO and SANN on lane tensors against
``jax.vmap`` of the JAX solvers, lane by lane, in float64 on the CPU, each
lane's JAX key chain replayed with ``jax.random`` and its draws handed to
the port as ``draws=``: PSO vanilla and accelerated, unbounded (the
derived bounds +-|x0| only seed the swarm) and in a box, at n = 2, 3 and
5; SANN in both Metropolis modes; one point; SANN's refusal of ``bounds``;
and states carried across the packages.

The lanes (tests/torch_free_common.py): bowls, Rosenbrock, a Rastrigin
start and a flat lane whose spread test fires at once (PSO; SANN stops on
max_iter alone).  ``iterations``, ``function_calls`` and ``converged`` are
equal lane by lane, and ``x`` and ``f_value`` agree within ``XTOL``
relative to max(|value|, 1) (some 1e-14 at most was read here).
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
from nlsolver_torch.solvers import pso as tp
from nlsolver_torch.solvers import sann as ts
from nlsolver_tpu.solvers import pso as jp
from nlsolver_tpu.solvers import sann as js

torch.set_num_threads(1)

XTOL = 1e-9
BOX = (-2.0, 1.5)
PSO_CASES = {
    "vanilla_n2": (2, {}, False),
    "vanilla_n3": (3, {}, False),
    "vanilla_boxed_n3": (3, {}, True),
    "vanilla_n5": (5, {}, False),
    "accelerated_n3": (3, {"accelerated": True}, False),
    "accelerated_boxed_n3": (3, {"accelerated": True}, True),
    "accelerated_n5": (5, {"accelerated": True}, False),
}
PSO_BASE = {"n_particles": 8, "max_iter": 200}
SANN_CASES = {"current_n3": (3, {}), "vs_best_n3": (3, {"metropolis_vs_best": True}),
              "current_n5": (5, {})}
SANN_BASE = {"max_iter": 40}


def pso_draws(keys, T, P, n, accelerated, dtype=jnp.float64, init=True):
    """The draws of ``pso.init`` and ``pso.step`` (nlsolver_tpu/solvers/
    pso.py:93-97, 137-152) down each lane's key chain."""
    def first(key):
        if not init:
            return key, None
        key, k_pos, k_vel = jax.random.split(key, 3)
        return key, (jax.random.uniform(k_pos, (P, n), dtype=dtype),
                     jax.random.uniform(k_vel, (P, n), dtype=dtype))

    def body(key):
        key, k1, k2 = jax.random.split(key, 3)
        if accelerated:
            return key, (jax.random.normal(k1, (P, n), dtype),)
        return key, (jax.random.uniform(k1, (P, n), dtype=dtype),
                     jax.random.uniform(k2, (P, n), dtype=dtype))

    return chain(keys, T, first, body, tp.InitDraws if init else None, tp.StepDraws)


def sann_draws(keys, T, n_inner, n, dtype=jnp.float64):
    """The draws of ``sann.step``'s proposals (nlsolver_tpu/solvers/
    sann.py:97-102, 112-116) down each lane's key chain."""
    def body(key):
        key, k_inner = jax.random.split(key)

        def one(k):
            k_step, k_accept = jax.random.split(k)
            return (jax.random.normal(k_step, (n,), dtype),
                    jax.random.uniform(k_accept, (), dtype=dtype))

        return key, jax.vmap(one)(jax.random.split(k_inner, n_inner))

    return chain(keys, T, lambda key: (key, None), body, step_cls=ts.StepDraws)


def box_of(x0):
    return tuple(np.full_like(x0, v) for v in BOX)


@pytest.fixture(scope="module")
def runs():
    out = {}

    def get(case):
        if case not in out:
            if case in PSO_CASES:
                n, kw, boxed = PSO_CASES[case]
                kw = {**PSO_BASE, **kw}
                x0, k, c, w = lanes(n)
                keys = keys_for(30 + n)
                lohi = box_of(x0) if boxed else ()
                want = fields(jax_vmapped(jp.minimize, jp.PSOConfig(**kw), bounded=boxed)(
                    x0, k, c, w, keys, *lohi))
                draws = pso_draws(keys, kw["max_iter"] + 1, kw["n_particles"], n,
                                  kw.get("accelerated", False))
                tb = nt.Bounds(*(torch.from_numpy(a) for a in lohi)) if boxed else None
                got = fields(tp.minimize_batched(t_objective, torch.from_numpy(x0),
                                                 tp.PSOConfig(**kw), tb, draws=draws,
                                                 data=torch_data(k, c, w)))
            else:
                n, kw = SANN_CASES[case]
                kw = {**SANN_BASE, **kw}
                x0, k, c, w = lanes(n)
                keys = keys_for(40 + n)
                want = fields(jax_vmapped(js.minimize, js.SANNConfig(**kw))(x0, k, c, w, keys))
                draws = sann_draws(keys, kw["max_iter"] + 1, 9, n)
                got = fields(ts.minimize_batched(t_objective, torch.from_numpy(x0),
                                                 ts.SANNConfig(**kw), draws=draws,
                                                 data=torch_data(k, c, w)))
            out[case] = (got, want)
        return out[case]

    return get


@pytest.mark.parametrize("case", list(PSO_CASES) + list(SANN_CASES))
def test_matches_jax_vmap_lane_by_lane(case, runs):
    got, want = runs(case)
    hold(got, want, 0, XTOL)


def test_pso_lanes_halt_at_once_and_at_max_iter(runs):
    """The flat lane stops before its first step; some lanes run to
    max_iter unconverged; the boxed swarms end in their box, and an
    unboxed one leaves +-|x0|, which only seeds it."""
    got, _ = runs("vanilla_n3")
    assert got["iterations"][5] == 0 and got["converged"][5]
    hit = got["iterations"] == PSO_BASE["max_iter"]
    assert hit.any() and not got["converged"][hit].any()
    boxed, _ = runs("vanilla_boxed_n3")
    assert ((boxed["x"] >= BOX[0]) & (boxed["x"] <= BOX[1])).all()
    x0 = lanes(3)[0]
    assert (np.abs(got["x"]) > np.abs(x0) + 1e-9).any()


def test_sann_stops_on_max_iter_alone(runs):
    got, _ = runs("current_n3")
    assert (got["iterations"] == SANN_BASE["max_iter"]).all() and got["converged"].all()
    assert (got["function_calls"] == 1 + 9 * SANN_BASE["max_iter"]).all()


@pytest.mark.parametrize("method", ["pso", "sann"])
def test_single_point_matches_jax(method):
    """``minimize(fn, x0[n])`` with one key's draws (no lane axis) against
    the JAX ``minimize`` with that key, and ``maximize`` of -f the same."""
    x0, k, c, w = lanes(3)
    lane = 3
    key = jax.random.key(9)
    if method == "pso":
        jm, tm, cfg = jp, tp, {**PSO_BASE}
        d = pso_draws(key[None], cfg["max_iter"] + 1, cfg["n_particles"], 3, False)
        one = tm.Draws(tp.InitDraws(*(a[0] for a in d.init)),
                       tp.StepDraws(*(None if a is None else a[:, 0] for a in d.steps)))
        jc, tc = jp.PSOConfig(**cfg), tp.PSOConfig(**cfg)
    else:
        jm, tm, cfg = js, ts, {**SANN_BASE}
        d = sann_draws(key[None], cfg["max_iter"] + 1, 9, 3)
        one = tm.Draws(None, ts.StepDraws(*(a[:, 0] for a in d.steps)))
        jc, tc = js.SANNConfig(**cfg), ts.SANNConfig(**cfg)
    want = fields(jax.jit(lambda x: jm.minimize(
        lambda p: j_objective(p, k[lane], c[lane], w[lane]), x, jc, key=key))(x0[lane]))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in (k[lane], c[lane], w[lane]))
    got = fields(tm.minimize(t_objective, torch.from_numpy(x0[lane]), tc, draws=one, data=data))
    up = fields(tm.maximize(lambda x, dd: -t_objective(x, dd), torch.from_numpy(x0[lane]), tc,
                            draws=one, data=data))
    for res in (got, up):
        for f in COUNTERS:
            assert res[f] == want[f], f
        np.testing.assert_allclose(res["x"], want["x"], rtol=0, atol=XTOL)
    np.testing.assert_allclose(up["f_value"], -want["f_value"], rtol=0, atol=XTOL)


def test_sann_refuses_bounds():
    """The JAX row-layout SANN takes bounds and ignores them; the port
    refuses them, single, batched and through the API."""
    x0 = torch.ones(2, 3, dtype=torch.float64)
    for call in (lambda: ts.minimize(t_objective, x0[0], bounds=nt.Bounds(-1.0, 1.0)),
                 lambda: ts.minimize_batched(t_objective, x0, bounds=nt.Bounds(-1.0, 1.0)),
                 lambda: nt.minimize(lambda x: (x ** 2).sum(), x0[0], method="sann",
                                     bounds=nt.Bounds(-1.0, 1.0))):
        with pytest.raises(ValueError, match="takes no bounds=.*'pso' or 'nmpso'"):
            call()


@pytest.mark.parametrize("method", ["pso_vanilla", "pso_accelerated", "sann"])
def test_states_cross_packages(method):
    """A JAX state after a vmapped step, carried into the port by
    ``interop`` (its key dropped), stepped once by each package on the
    JAX step's draws: the same state, back as numpy."""
    from nlsolver_torch import interop

    x0, k, c, w = lanes(3)
    keys = keys_for(50)
    if method == "sann":
        cfg = js.SANNConfig()

        def two(x, kk, cc, ww, key):
            f = lambda p: j_objective(p, kk, cc, ww)  # noqa: E731
            s = js.step(f, js.init(f, x, cfg, key), cfg)
            return s, js.step(f, s, cfg)
    else:
        cfg = jp.PSOConfig(n_particles=8, accelerated=method == "pso_accelerated")

        def two(x, kk, cc, ww, key):
            f = lambda p: j_objective(p, kk, cc, ww)  # noqa: E731
            lo, hi = jp._derived_bounds(x)
            s = jp.step(f, jp.init(f, x, cfg, key, lo, hi), cfg, lo, hi, False)
            return s, jp.step(f, s, cfg, lo, hi, False)

    s1, s2 = jax.jit(jax.vmap(two))(x0, k, c, w, keys)
    carried = {f: np.asarray(v) for f, v in s1._asdict().items() if f != "key"}
    data = torch_data(k, c, w)
    if method == "sann":
        ts_ = interop.sann_state_from_numpy(carried, "cpu")
        d = sann_draws(s1.key, 1, 9, 3).steps
        stepped = interop.sann_state_to_numpy(ts.step(
            t_objective, ts_, ts.SANNConfig(), draws=ts.StepDraws(*(a[0] for a in d)), data=data))
    else:
        acc = method == "pso_accelerated"
        tp_ = interop.pso_state_from_numpy(carried, "cpu")
        d = pso_draws(s1.key, 1, 8, 3, acc, init=False).steps
        stepped = interop.pso_state_to_numpy(tp.step(
            t_objective, tp_, tp.PSOConfig(n_particles=8, accelerated=acc),
            draws=tp.StepDraws(*(None if a is None else a[0] for a in d)), data=data))
    assert set(stepped) == set(carried)
    for f, v in stepped.items():
        want = np.asarray(getattr(s2, f))
        assert v.dtype == want.dtype, f
        np.testing.assert_allclose(v, want, rtol=1e-12, atol=1e-12, err_msg=f)
    assert B == 8
