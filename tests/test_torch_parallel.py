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
  * ``pso_minimize_sharded`` and both forms of ``minimize_islands``
    (island DE; both strategies, a migration every 3 generations) on the
    JAX package's own draws at the same four meshes (the same island
    counts), and the dimension-sharded L-BFGS at pop = 1, 2 and 4 on the
    coupled quadratic of tests/test_parallel.py:72-106 and a weighted
    one: the counters equal, x and f_value within ``DE_XTOL`` (the L-BFGS
    within ``LBFGS_XTOL``).  Where a lane's counters part, the JAX engine
    run op by op (tests/torch_spmd_common.py: nothing fused) gives the
    port's counters and x on every lane, and parts from the jitted engine
    on those lanes: the difference is XLA's fused multiply-adds.  Under
    ``"best"`` a migrant copies an island's best agent, and a tie between
    the copies and a proposal is then decided by the last bit;
  * the PSO bit-equal across every (dp, pop) split, the islands and the
    L-BFGS across dp at a fixed island (dimension) count;
  * ``de_sharded`` gathers once a generation (and once at the end), the
    PSO once a generation (and once at the start), the eager islands
    make one stats gather and one ring exchange a generation, and the
    fused islands none in an interval and three after it;
  * the refusals, word for word the JAX package's at each mesh's shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_mesh_common import (DE_STRATEGIES, ISLAND_FORMS, LBFGS_OBJECTIVES, MESHES,
                               NLLS_SOLVES, inputs, lbfgs_problem, run_worlds)
from torch_spmd_common import op_by_op

import nlsolver_tpu
from nlsolver_tpu.parallel import (bfgs_minimize_fleet_sharded, de_island, fit_fleet_sharded,
                                   lbfgs_sharded, make_mesh, minimize_sharded, pso_sharded)
from nlsolver_tpu.problems import PROBLEMS as JP
from nlsolver_tpu.solvers import bfgs_fleet as jbf
from nlsolver_tpu.solvers import nlls as jnlls
from nlsolver_tpu.solvers import nlls_fleet as jnf
from nlsolver_tpu.solvers.de import DEConfig as JDEConfig
from nlsolver_tpu.solvers.pso import PSOConfig as JPSOConfig

WORLDS = (1, 2, 4)
XTOL = 1e-8
DE_XTOL = 1e-13
LBFGS_XTOL = 1e-10
COUNTERS = ("iterations", "function_calls", "gradient_calls", "converged")


def de_draws(keys, T, P, n, pool=None):
    """The draws of nlsolver_tpu/parallel/de_sharded.py:41-43,147-160 for
    every (instance, agent, iteration): init uniforms [B, P, n], crossover
    uniforms [T, B, P, n], forced dimensions [T, B, P] and the partners' raw
    randint draws [T, B, P, 3] (random/sampling.py:41-47), draw j in [0,
    pool - 1 - j): the population's P, or an island's agents
    (de_island.py:44-46,175-179)."""
    agents, its = jnp.arange(P), jnp.arange(T)
    pool = P if pool is None else pool

    def init(key, a):
        return jax.random.uniform(jax.random.fold_in(key, a), (n,), dtype=jnp.float64)

    def step(key, a, t):
        k = jax.random.fold_in(jax.random.fold_in(key, a), t)
        k_idx, k_dim, k_cross = jax.random.split(k, 3)
        ks = jax.random.split(k_idx, 3)
        raw = jnp.stack([jax.random.randint(ks[j], (), 0, pool - 1 - j, dtype=jnp.int32)
                         for j in range(3)])
        return (jax.random.uniform(k_cross, (n,), dtype=jnp.float64),
                jax.random.randint(k_dim, (), 0, n), raw)

    u0 = jax.vmap(lambda k: jax.vmap(lambda a: init(k, a))(agents))(keys)
    per_t = jax.vmap(lambda t: jax.vmap(lambda k: jax.vmap(lambda a: step(k, a, t))(agents))(keys))
    u, fdim, raw = per_t(its)
    return tuple(np.asarray(a) for a in (u0, u, fdim, raw))


def pso_draws(keys, T, P, n):
    """The draws of nlsolver_tpu/parallel/pso_sharded.py:79-82,160-166 for
    every (instance, particle, iteration): the initial positions' and
    velocities' uniforms [B, P, n] and the update's r_p and r_g [T, B, P, n]."""
    pids, its = jnp.arange(P), jnp.arange(T)

    def pair(key):
        kp, kv = jax.random.split(key)
        return (jax.random.uniform(kp, (n,), dtype=jnp.float64),
                jax.random.uniform(kv, (n,), dtype=jnp.float64))

    init = jax.vmap(lambda k: jax.vmap(lambda p: pair(jax.random.fold_in(k, p)))(pids))(keys)
    step = jax.vmap(lambda t: jax.vmap(lambda k: jax.vmap(lambda p: pair(
        jax.random.fold_in(jax.random.fold_in(k, p), t)))(pids))(keys))(its)
    return tuple(np.asarray(a) for a in init + step)


def pso_keys(inp):
    return jax.random.split(jax.random.key(11), inp["free_x0"].shape[0])


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    inp = inputs()
    cfg = inp["de_cfg"]
    keys = jax.random.split(jax.random.key(11), inp["de_x0"].shape[0])
    T, P, n = cfg["max_iter"] + 1, cfg["pop_size"], inp["de_x0"].shape[1]
    draws = {"de": de_draws(keys, T, P, n),
             "pso": pso_draws(pso_keys(inp), inp["pso_cfg"]["max_iter"] + 1,
                              inp["pso_cfg"]["n_particles"], inp["free_x0"].shape[1])}
    for islands in (1, 2):
        draws[f"island{islands}"] = de_draws(keys, T, P, n, pool=P // islands)
    outs = run_worlds(WORLDS, tmp_path_factory.mktemp("worlds"), inp, draws)
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


ALL_COUNTERS = ("iterations", "function_calls", "gradient_calls", "hessian_calls", "converged")


def parts(got, want, xtol):
    """The lanes whose counters differ, or whose x or f_value part by more
    than ``xtol`` (relative and absolute, as ``assert_allclose``)."""
    def far(a, b):
        return np.abs(a - b) > xtol + xtol * np.abs(b)

    bad = np.zeros(np.shape(want["f_value"]), dtype=bool)
    for f in ALL_COUNTERS:
        bad |= got[f] != want[f]
    bad |= far(got["f_value"], want["f_value"])
    x_far = far(got["x"], want["x"])
    return bad | (x_far.any(axis=-1) if bad.ndim else x_far.any())


def hold_or_rounding(got, fused, run_op_by_op, xtol):
    """The port against the jitted JAX engine; where lanes part, the JAX
    engine run op by op gives the port's result on every lane and parts
    from the jitted one on those lanes.  Returns the lanes that part."""
    bad = parts(got, fused, xtol)
    if bad.any():
        ref = run_op_by_op()
        assert not parts(got, ref, xtol).any(), "the port parts from the JAX engine op by op"
        assert np.all(parts(fused, ref, xtol)[bad]), "a lane parts that rounding does not explain"
    return bad


def island_mesh_out(outs, dp, pop):
    return outs[dp * pop][0][(dp, pop)]


@pytest.mark.parametrize("dp,pop", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_pso_sharded_matches_jax_on_its_draws(case, dp, pop):
    inp, _, outs = case
    mesh = make_mesh(dp * pop, dp=dp, pop=pop)

    def run():
        return fields(pso_sharded.minimize_sharded(
            JP["rastrigin"].fn, jnp.asarray(inp["free_x0"]), JPSOConfig(**inp["pso_cfg"]), mesh,
            pso_keys(inp)))

    want = run()
    got = island_mesh_out(outs, dp, pop)["pso"]
    bad = hold_or_rounding(got, want, lambda: _op_by_op(pso_sharded, mesh, run), DE_XTOL)
    assert not bad.all()
    # lanes stop at different generations, by max_iter and by a tolerance
    assert want["converged"].any() and not want["converged"].all()
    assert len(set(want["iterations"].tolist())) > 1


def _op_by_op(module, mesh, run):
    with op_by_op(module, mesh):
        return run()


@pytest.mark.parametrize("strategy", DE_STRATEGIES)
@pytest.mark.parametrize("form", ISLAND_FORMS)
@pytest.mark.parametrize("dp,pop", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_islands_match_jax_on_its_draws(case, form, strategy, dp, pop):
    inp, keys, outs = case
    mesh = make_mesh(dp * pop, dp=dp, pop=pop)
    cfg = JDEConfig(strategy=strategy, **inp["de_cfg"])

    def run():
        return fields(de_island.minimize_islands(
            JP["rosenbrock"].fn, jnp.asarray(inp["de_x0"]), cfg, mesh, keys,
            migration_interval=inp["migration_interval"], fused=form == "fused"))

    want = run()
    got = island_mesh_out(outs, dp, pop)[f"islands_{form}_{strategy}"]
    bad = hold_or_rounding(got, want, lambda: _op_by_op(de_island, mesh, run), DE_XTOL)
    assert bad.sum() <= 1, bad
    assert want["converged"].any() and len(set(want["iterations"].tolist())) > 1


def jax_lbfgs_problem(inp, kind, pop):
    """A (1, pop) mesh and the shard-local objective and gradient of
    ``lbfgs_problem`` for the JAX engine (tests/test_parallel.py:83-101,
    with the weights).  The sums and the block index go through the
    engine module's ``lax``, which ``op_by_op`` replaces."""
    n = inp["lbfgs_n"]
    t, w = (jnp.asarray(a) for a in lbfgs_problem(kind, n))
    per = n // pop

    def block(a):
        return jax.lax.dynamic_slice(a, (lbfgs_sharded.lax.axis_index("pop") * per,), (per,))

    def fn_local(x):
        mean_x = lbfgs_sharded.lax.psum(jnp.sum(x), "pop") / n
        base = jnp.sum(block(w) * (x - block(t)) ** 2)
        return base + jnp.where(lbfgs_sharded.lax.axis_index("pop") == 0, mean_x ** 2, 0.0)

    def grad_local(x):
        mean_x = lbfgs_sharded.lax.psum(jnp.sum(x), "pop") / n
        return 2.0 * block(w) * (x - block(t)) + 2.0 * mean_x / n

    return make_mesh(pop, dp=1, pop=pop), fn_local, grad_local


@pytest.mark.parametrize("kind", LBFGS_OBJECTIVES)
@pytest.mark.parametrize("pop", [1, 2, 4])
def test_dim_sharded_lbfgs_matches_jax(case, kind, pop):
    inp, _, outs = case
    n = inp["lbfgs_n"]
    t = lbfgs_problem(kind, n)[0]
    mesh, fn_local, grad_local = jax_lbfgs_problem(inp, kind, pop)

    def run():
        return fields(lbfgs_sharded.minimize_dim_sharded(fn_local, grad_local, jnp.zeros(n), mesh,
                                                         **inp["lbfgs_cfg"]))

    want = run()
    got = outs[pop][0][(1, pop)][f"lbfgs_{kind}"]
    assert not hold_or_rounding(got, want, lambda: _op_by_op(lbfgs_sharded, mesh, run),
                                LBFGS_XTOL)
    assert bool(got["converged"]) and float(np.max(np.abs(got["x"] - np.asarray(t)))) < 1e-4
    assert got["iterations"] >= (1 if kind == "coupled" else 5)


def test_a_tie_that_the_last_bit_decides_is_rounding():
    """Under ``"best"`` a migrant copies an island's best agent; a proposal
    then ties with a copy, and the jitted JAX engine's fused multiply-adds
    decide the tie otherwise than the port on one lane of these four (from
    the 15th generation).  Run op by op, the JAX engine gives the port's
    result on every lane, bit for bit."""
    import torch.distributed as dist

    import nlsolver_torch as nt
    from nlsolver_torch.parallel import de_sharded as tds
    from nlsolver_torch.parallel import make_mesh as torch_mesh
    from nlsolver_torch.parallel import minimize_islands

    rng = np.random.default_rng(20)
    rng.uniform(-3.0, 3.0, (8, 3))
    x0 = rng.uniform(0.5, 3.0, (4, 3))
    keys = jax.random.split(jax.random.key(11), 4)
    kw = dict(pop_size=8, max_iter=40, eps=5e-2, best_value_no_change=8, strategy="best")
    mesh = make_mesh(1, dp=1, pop=1)

    def run():
        return fields(de_island.minimize_islands(JP["rosenbrock"].fn, jnp.asarray(x0),
                                                 JDEConfig(**kw), mesh, keys,
                                                 migration_interval=3))

    draws = tds.ShardedDraws(*(torch.as_tensor(a) for a in de_draws(keys, 41, 8, 3)))
    try:
        got = fields(minimize_islands(nt.PROBLEMS["rosenbrock"].fn, torch.as_tensor(x0),
                                      nt.DEConfig(**kw), torch_mesh(device_type="cpu"), 3,
                                      draws=draws))
    finally:
        dist.destroy_process_group()
    fused, ref = run(), _op_by_op(de_island, mesh, run)
    assert parts(got, fused, DE_XTOL).tolist() == [False, True, False, False]
    assert parts(ref, fused, DE_XTOL).tolist() == [False, True, False, False]
    bit_equal(got, ref, "op by op")


def test_op_by_op_runs_the_engines_on_every_shard(case):
    """The op-by-op emulation of tests/torch_spmd_common.py on a 2x2 mesh
    (four threads and every collective of the island DE's fused form) and
    on a 1x4 one (the L-BFGS, its objective's own sums among them) gives
    the port's results: the emulation the rounding tests rest on is the
    engine."""
    inp, keys, outs = case
    mesh = make_mesh(4, dp=2, pop=2)
    cfg = JDEConfig(strategy="best", **inp["de_cfg"])
    ref = _op_by_op(de_island, mesh, lambda: fields(de_island.minimize_islands(
        JP["rosenbrock"].fn, jnp.asarray(inp["de_x0"]), cfg, mesh, keys,
        migration_interval=inp["migration_interval"], fused=True)))
    assert not parts(outs[4][0][(2, 2)]["islands_fused_best"], ref, DE_XTOL).any()
    mesh, fn_local, grad_local = jax_lbfgs_problem(inp, "weighted", 4)
    ref = _op_by_op(lbfgs_sharded, mesh, lambda: fields(lbfgs_sharded.minimize_dim_sharded(
        fn_local, grad_local, jnp.zeros(inp["lbfgs_n"]), mesh, **inp["lbfgs_cfg"])))
    assert not parts(outs[4][0][(1, 4)]["lbfgs_weighted"], ref, LBFGS_XTOL)


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
                for name in ["fit_sharded", "pso", "pso_philox", "pso_max"] + [
                        f"de_{s}{k}" for s in DE_STRATEGIES for k in ("", "_philox")]:
                    bit_equal(out[mesh][name], first[(1, 1)][name], f"{name} {mesh}, {label}")


# the meshes of one island (dimension block) count, the first of each the
# one the others are held to
SAME_ISLANDS = {1: [(1, (1, 1)), (2, (2, 1))], 2: [(2, (1, 2)), (4, (2, 2))]}
ISLAND_RUNS = [f"islands_{f}_{s}{k}" for f in ISLAND_FORMS for s in DE_STRATEGIES
               for k in ("", "_philox")] + ["islands_max"]


@pytest.mark.parametrize("islands", [1, 2])
def test_islands_and_lbfgs_are_dp_invariant_and_every_rank_returns_them(case, islands):
    """At a fixed island count the island DE's results do not depend on the
    dp split (tests/test_de_island.py:42-58 asks it of the JAX engine);
    neither do the L-BFGS's at a fixed count of dimension blocks."""
    outs = case[2]
    (w0, m0), *rest = SAME_ISLANDS[islands]
    first = outs[w0][0][m0]
    names = ISLAND_RUNS + [f"lbfgs_{k}" for k in LBFGS_OBJECTIVES]
    for world, mesh in SAME_ISLANDS[islands]:
        for rank, out in enumerate(outs[world]):
            for name in names:
                bit_equal(out[mesh][name], first[name], f"{name} {mesh}, world {world} rank {rank}")
    for rank, out in enumerate(outs[4]):
        for name in (f"lbfgs_{k}" for k in LBFGS_OBJECTIVES):
            bit_equal(out[(1, 4)][name], outs[4][0][(1, 4)][name], f"{name} (1, 4) rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_island_sync_interval_and_the_routes(case, world):
    """A world check every 3 generations gives the eager islands' result
    bit for bit (frozen lanes); ``maximize`` flips only f_value, on the PSO
    and the island routes; the routes' own draws run the fleets down."""
    for mesh in MESHES[world]:
        got = case[2][world][0][mesh]
        for strategy in DE_STRATEGIES:
            bit_equal(got[f"islands_sync3_{strategy}"], got[f"islands_eager_{strategy}"],
                      f"sync 3, {strategy} {mesh}")
        for up, down in (("pso_max", "pso_philox"),
                         ("islands_max", "islands_eager_random_philox")):
            np.testing.assert_array_equal(got[up]["x"], got[down]["x"])
            np.testing.assert_array_equal(got[up]["f_value"], -got[down]["f_value"])
            np.testing.assert_array_equal(got[up]["iterations"], got[down]["iterations"])
        for res in [got["pso_philox"]] + [got[f"islands_{form}_{strategy}_philox"]
                                          for form in ISLAND_FORMS for strategy in DE_STRATEGIES]:
            assert np.isfinite(res["f_value"]).all() and res["converged"].any()


def test_philox_draws_run_the_fleet_down(case):
    """The route's own draws (Philox by instance, agent and iteration)."""
    got = case[2][1][0][(1, 1)]
    for strategy in DE_STRATEGIES:
        res = got[f"de_{strategy}_philox"]
        assert np.isfinite(res["f_value"]).all() and res["converged"].any()
        assert (res["f_value"] < 50.0).all()


@pytest.mark.parametrize("world", WORLDS)
def test_pso_gathers_once_a_generation_and_islands_count_their_collectives(case, world):
    """The PSO: one packed gather at the start and one a generation.  The
    eager islands: one stats gather and one ring exchange a generation, a
    world count before each; the fused islands: ``migration_interval``
    generations with no collective, then the stats gather, the ring and
    the world count.  Both end with one gather of the islands."""
    every = case[0]["migration_interval"]
    for mesh in MESHES[world]:
        for out in case[2][world]:
            got = out[mesh]
            calls = got["pso_calls"]
            gens = calls.count("_generation")
            assert gens > 0 and calls.count("gather_swarm") == gens + 1, calls
            assert calls[0] == "gather_swarm"
            for strategy in DE_STRATEGIES:
                eager = got[f"islands_eager_{strategy}_calls"]
                gens = eager.count("_generation")
                assert gens > 0 and eager == ["all_sum"] + gens * [
                    "_generation", "island_stats", "ring_exchange", "all_sum"] + [
                    "best_member"], eager
                fused = got[f"islands_fused_{strategy}_calls"]
                blocks = fused.count("ring_exchange")
                assert blocks > 0 and fused == ["all_sum"] + blocks * (
                    every * ["_local_generation"] + ["island_stats", "ring_exchange", "all_sum"]
                ) + ["best_member"], fused


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
            "pso_width": _jax_raised(lambda: pso_sharded.minimize_sharded(
                JP["rastrigin"].fn, jnp.ones((dp + 1 if dp > 1 else 2, 2)),
                JPSOConfig(n_particles=pop + 5 if pop > 1 else 6), mesh)),
            "islands_width": _jax_raised(lambda: de_island.minimize_islands(
                JP["rosenbrock"].fn, jnp.ones((dp + 1 if dp > 1 else 2, 2)),
                JDEConfig(pop_size=4 * pop + 1 if pop > 1 else 8), mesh)),
            "islands_small": _jax_raised(lambda: de_island.minimize_islands(
                JP["rosenbrock"].fn, jnp.ones((dp, 2)), JDEConfig(pop_size=3 * pop), mesh)),
        }
        if pop > 1:
            want["lbfgs_dim"] = _jax_raised(lambda: lbfgs_sharded.minimize_dim_sharded(
                jnp.sum, lambda x: x, jnp.zeros(pop + 1), mesh))
        if dp > 1:
            want["fit_batch"] = _jax_raised(lambda: nlsolver_tpu.fit_sharded(
                jax_residual(inp["t"]), jnp.ones((dp + 1, 2)), jnlls.NLLSConfig(), mesh))
        assert got == want
        assert all(kind == "ValueError" for kind, _ in got.values())


@pytest.mark.parametrize("world", WORLDS)
def test_orbax_pair_resumes_every_rank_bit_for_bit(case, world):
    """``utils.save_orbax`` / ``load_orbax`` over torch.distributed.checkpoint
    in a world of gloo ranks, each with a DE fleet of its own lanes: every
    rank gets its own state back, and the resumed run is the one that went
    on, bit for bit."""
    outs = case[2][world]
    for rank, out in enumerate(outs):
        got = out["orbax"]
        bit_equal(got["restored"], got["saved"], f"restored, rank {rank}")
        bit_equal(got["resumed"], got["went_on"], f"resumed, rank {rank}")
        assert got["went_on"]["generation"] == 10
    agents = [out["orbax"]["saved"]["agents"] for out in outs]
    assert all(a.shape == agents[0].shape and not np.array_equal(a, agents[0])
               for a in agents[1:])


def test_process_slice(case):
    for world in WORLDS:
        for rank, out in enumerate(case[2][world]):
            per = 8 // world
            assert out["process_slice"] == (rank * per, (rank + 1) * per)


@pytest.mark.parametrize("layout,method", [("sharded", "bfgs"), ("sharded", "cmaes"),
                                           ("sharded", "de"), ("sharded", "pso_batched"),
                                           ("sharded", "sann"), ("sharded", "pso"),
                                           ("sharded", "lbfgs"), ("islands", "de"),
                                           ("islands", "cmaes")])
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
