"""nlsolver_torch.parallel, the mesh engines over torch.distributed, at worlds
of 1, 2 and 4 gloo ranks on the CPU (tests/torch_mesh_common.py), against
the JAX package's mesh engines on the conftest's 8 virtual devices in f64.

  * the sharded BFGS fleet, ``fit_fleet_sharded`` (``"cholesky"`` and
    ``"qr_pallas"``, the JAX kernel in interpret mode) and ``fit_sharded``
    against ``nlsolver_tpu.parallel`` on ``make_mesh(8, dp=2, pop=4)`` (the
    set-up of tests/test_parallel.py:131-176): counters equal, x within the
    fleet tests' 1e-8;
  * ``de_sharded`` on the JAX package's own draws (its
    ``fold_in(fold_in(key_b, agent), iteration)`` chain, replayed here)
    against ``nlsolver_tpu.parallel.minimize_sharded``, both strategies, at
    dp x pop = 1x1, 2x1, 1x2 and 2x2, lanes halting at different
    generations by max_iter and by the tolerances: the counters equal, x
    and f_value within ``DE_XTOL`` (the jitted JAX program contracts the
    donor's ``a + F (b - c)`` into a fused multiply-add, as
    tests/test_torch_de_row.py reads; 2.2e-15 at most was read here, and
    it moved no selection);
  * the PSO, SANN and CMA-ES sharded fleets bit-equal to the port's
    unsharded fleets on the same generator;
  * every engine bit-equal across worlds 1, 2 and 4 and on every rank;
  * ``de_sharded`` gathers once a generation (and once at the end);
  * the refusals, word for word the JAX package's at each mesh's shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_common import DE_STRATEGIES, MESHES, NLLS_SOLVES, inputs, run_worlds

import nlsolver_tpu
from nlsolver_tpu.parallel import (bfgs_minimize_fleet_sharded, fit_fleet_sharded, make_mesh,
                                   minimize_sharded)
from nlsolver_tpu.problems import PROBLEMS as JP
from nlsolver_tpu.solvers import bfgs_fleet as jbf
from nlsolver_tpu.solvers import nlls as jnlls
from nlsolver_tpu.solvers import nlls_fleet as jnf
from nlsolver_tpu.solvers.de import DEConfig as JDEConfig

WORLDS = (1, 2, 4)
XTOL = 1e-8
DE_XTOL = 1e-13
COUNTERS = ("iterations", "function_calls", "gradient_calls", "converged")


def de_draws(keys, T, P, n):
    """The draws of nlsolver_tpu/parallel/de_sharded.py:41-43,147-160 for
    every (instance, agent, iteration): init uniforms [B, P, n], crossover
    uniforms [T, B, P, n], forced dimensions [T, B, P] and the partners' raw
    randint draws [T, B, P, 3] (random/sampling.py:41-47)."""
    agents, its = jnp.arange(P), jnp.arange(T)

    def init(key, a):
        return jax.random.uniform(jax.random.fold_in(key, a), (n,), dtype=jnp.float64)

    def step(key, a, t):
        k = jax.random.fold_in(jax.random.fold_in(key, a), t)
        k_idx, k_dim, k_cross = jax.random.split(k, 3)
        ks = jax.random.split(k_idx, 3)
        raw = jnp.stack([jax.random.randint(ks[j], (), 0, P - 1 - j, dtype=jnp.int32)
                         for j in range(3)])
        return (jax.random.uniform(k_cross, (n,), dtype=jnp.float64),
                jax.random.randint(k_dim, (), 0, n), raw)

    u0 = jax.vmap(lambda k: jax.vmap(lambda a: init(k, a))(agents))(keys)
    per_t = jax.vmap(lambda t: jax.vmap(lambda k: jax.vmap(lambda a: step(k, a, t))(agents))(keys))
    u, fdim, raw = per_t(its)
    return tuple(np.asarray(a) for a in (u0, u, fdim, raw))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    inp = inputs()
    cfg = inp["de_cfg"]
    keys = jax.random.split(jax.random.key(11), inp["de_x0"].shape[0])
    draws = de_draws(keys, cfg["max_iter"] + 1, cfg["pop_size"], inp["de_x0"].shape[1])
    outs = run_worlds(WORLDS, tmp_path_factory.mktemp("worlds"), inp,
                      {s: draws for s in DE_STRATEGIES})
    return inp, keys, outs


def fields(res):
    return {f: np.asarray(v) for f, v in zip(res._fields, res)}


def hold(got, want, atol=XTOL, counters=COUNTERS):
    for f in counters:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=atol, err_msg="x")
    np.testing.assert_allclose(got["f_value"], want["f_value"], rtol=1e-9, atol=1e-12,
                               err_msg="f_value")


def bit_equal(a, b, label):
    assert a.keys() == b.keys(), label
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{label}: {f}")


def jax_mesh():
    return make_mesh(8, dp=2, pop=4)


def rosen_cols(X):
    return 100.0 * (X[1] - X[0] ** 2) ** 2 + (1.0 - X[0]) ** 2


def jax_residual(t):
    t = jnp.asarray(t)
    return lambda p, y: p[0] * jnp.exp(-p[1] * t) - y


# ------------------------------------------------- against the JAX package


@pytest.mark.parametrize("world", WORLDS)
def test_bfgs_fleet_sharded_matches_jax(case, world):
    inp, _, outs = case
    want = fields(bfgs_minimize_fleet_sharded(rosen_cols, jnp.asarray(inp["bfgs_X0"]),
                                              jbf.BFGSFleetConfig(**inp["bfgs_cfg"]), jax_mesh()))
    hold(outs[world][0]["fleets"]["bfgs"], want)
    np.testing.assert_allclose(outs[world][0]["fleets"]["bfgs"]["x"], 1.0, atol=1e-6)


@pytest.mark.parametrize("solve", NLLS_SOLVES)
@pytest.mark.parametrize("world", WORLDS)
def test_fit_fleet_sharded_matches_jax(case, world, solve):
    inp, _, outs = case
    cfg = jnf.NLLSFleetConfig(solve=solve, pallas_interpret=solve == "qr_pallas",
                              **inp["nlls_cfg"])
    want = fields(fit_fleet_sharded(jax_residual(inp["t"]), jnp.asarray(inp["nlls_X0"]), cfg,
                                    jax_mesh(), data=jnp.asarray(inp["ys"])))
    hold(outs[world][0]["fleets"][f"fit_fleet_{solve}"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_fit_sharded_matches_jax(case, world):
    inp, _, outs = case
    want = fields(nlsolver_tpu.fit_sharded(jax_residual(inp["t"]), jnp.asarray(inp["nlls_X0"]).T,
                                           jnlls.NLLSConfig(**inp["fit_cfg"]), jax_mesh(),
                                           data=jnp.asarray(inp["ys"])))
    for mesh in MESHES[world]:
        hold(outs[world][0][mesh]["fit_sharded"], want)


@pytest.mark.parametrize("strategy", DE_STRATEGIES)
@pytest.mark.parametrize("dp,pop", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_de_sharded_matches_jax_on_its_draws(case, strategy, dp, pop):
    inp, keys, outs = case
    cfg = JDEConfig(strategy=strategy, **inp["de_cfg"])
    want = fields(minimize_sharded(JP["rosenbrock"].fn, jnp.asarray(inp["de_x0"]), cfg,
                                   make_mesh(dp * pop, dp=dp, pop=pop), keys))
    got = outs[dp * pop][0][(dp, pop)][f"de_{strategy}"]
    for f in ("iterations", "function_calls", "gradient_calls", "hessian_calls", "converged"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["x"], want["x"], rtol=DE_XTOL, atol=DE_XTOL)
    np.testing.assert_allclose(got["f_value"], want["f_value"], rtol=DE_XTOL, atol=DE_XTOL)
    # lanes stop at different generations, by max_iter and by a tolerance
    assert want["converged"].any() and not want["converged"].all()
    assert len(set(want["iterations"].tolist())) > 1


# ------------------------------------------------- against the port itself


@pytest.mark.parametrize("engine", ["bfgs", "pso", "sann", "cmaes"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fleets_bit_equal_to_unsharded(case, world, engine):
    _, _, outs = case
    bit_equal(outs[world][0]["fleets"][engine], outs[1][0]["unsharded"][engine],
              f"{engine} at world {world}")


@pytest.mark.parametrize("world", WORLDS)
def test_api_routes_equal_the_engines(case, world):
    fleets = case[2][world][0]["fleets"]
    bit_equal(fleets["bfgs_api"], fleets["bfgs"], "bfgs route")
    bit_equal(fleets["cmaes_api"], fleets["cmaes"], "cmaes route")
    up, down = fleets["pso_api"], fleets["pso"]
    np.testing.assert_array_equal(up["x"], down["x"])
    np.testing.assert_array_equal(up["f_value"], -down["f_value"])


def test_every_engine_is_layout_invariant_and_every_rank_returns_it(case):
    """Bit-equal across worlds 1, 2 and 4, every mesh of a world and every
    rank (tests/test_parallel.py:59,213 ask the same of the JAX engines)."""
    _, _, outs = case
    first = outs[1][0]
    for world in WORLDS:
        for rank, out in enumerate(outs[world]):
            label = f"world {world} rank {rank}"
            for name, got in out["fleets"].items():
                bit_equal(got, first["fleets"][name], f"{name}, {label}")
            for mesh in MESHES[world]:
                for name in ["fit_sharded"] + [f"de_{s}{k}" for s in DE_STRATEGIES
                                               for k in ("", "_philox")]:
                    bit_equal(out[mesh][name], first[(1, 1)][name], f"{name} {mesh}, {label}")


def test_philox_draws_run_the_fleet_down(case):
    """The route's own draws (Philox by instance, agent and iteration)."""
    got = case[2][1][0][(1, 1)]
    for strategy in DE_STRATEGIES:
        res = got[f"de_{strategy}_philox"]
        assert np.isfinite(res["f_value"]).all() and res["converged"].any()
        assert (res["f_value"] < 50.0).all()


@pytest.mark.parametrize("world", WORLDS)
def test_de_sharded_gathers_once_a_generation(case, world):
    for mesh in MESHES[world]:
        for strategy in DE_STRATEGIES:
            for out in case[2][world]:
                calls = out[mesh][f"de_{strategy}_calls"]
                assert calls["generation"] > 0
                assert calls["gather"] == calls["generation"] + 1, calls


def _jax_raised(call):
    try:
        call()
    except Exception as e:
        return type(e).__name__, str(e)
    return None, ""


@pytest.mark.parametrize("world", [2, 4])
def test_refusals_match_jax(case, world):
    inp = case[0]
    for dp, pop in MESHES[world]:
        got = case[2][world][0][(dp, pop)]["errors"]
        mesh = make_mesh(world, dp=dp, pop=pop)
        want = {
            "fleet_width": _jax_raised(lambda: bfgs_minimize_fleet_sharded(
                rosen_cols, jnp.zeros((2, 2 * world + 1)), jbf.BFGSFleetConfig(), mesh)),
            "de_batch": _jax_raised(lambda: minimize_sharded(
                JP["rosenbrock"].fn, jnp.ones((dp + 1 if dp > 1 else 2, 2)),
                JDEConfig(pop_size=pop + 5 if pop > 1 else 6), mesh)),
        }
        if dp > 1:
            want["fit_batch"] = _jax_raised(lambda: nlsolver_tpu.fit_sharded(
                jax_residual(inp["t"]), jnp.ones((dp + 1, 2)), jnlls.NLLSConfig(), mesh))
        assert got == want
        assert all(kind == "ValueError" for kind, _ in got.values())


def test_process_slice(case):
    for world in WORLDS:
        for rank, out in enumerate(case[2][world]):
            per = 8 // world
            assert out["process_slice"] == (rank * per, (rank + 1) * per)


@pytest.mark.parametrize("layout,method", [("sharded", "bfgs"), ("sharded", "cmaes"),
                                           ("sharded", "de"), ("sharded", "pso_batched"),
                                           ("sharded", "sann")])
def test_no_mesh_refused_as_jax_refuses(layout, method):
    x0 = np.zeros((4, 2))
    want = _jax_raised(lambda: nlsolver_tpu.minimize(lambda x: jnp.sum(x ** 2), x0,
                                                     method=method, layout=layout))
    import nlsolver_torch as nt
    got = _jax_raised(lambda: nt.minimize(lambda x: (x ** 2).sum(), torch.from_numpy(x0),
                                          method=method, layout=layout))
    assert got == want and got[0] == "ValueError"


def test_fit_routes_without_a_mesh_refused_as_jax_refuses():
    import nlsolver_torch as nt
    t = np.linspace(0.0, 1.0, 4)
    for name in ("fit_sharded", "fit_fleet_sharded"):
        want = _jax_raised(lambda: getattr(nlsolver_tpu, name)(jax_residual(t), np.ones((2, 4))))
        got = _jax_raised(lambda: getattr(nt, name)(lambda p, y: p, torch.ones(2, 4)))
        assert got == want and got[0] == "ValueError"
