"""nlsolver_torch.solvers.cmaes_fleet against nlsolver_tpu.solvers.cmaes_fleet
(f64 on the CPU unless said): the config, ``init``, single generations from
a JAX state carried over by ``interop`` on injected draws, runs of five
generations, the lazy and the deferred-covariance modes with a forced kick
refresh, ``_materialize``, bounds with tied candidates, whole runs by their
statistics, the ``minimize`` / ``maximize`` route, and the f32 scenarios of
``chip_smoke.py`` at B = 1024 against the JAX fleet's statistics.

Draws: the JAX step splits its key and draws ``z [n, lam, B]``
(``cmaes_fleet.py:264-265``); the tests make the same ``z`` and hand it to
the port's step, whose state has no key.  With ``eigh_method="jacobi"`` or
``"pallas"`` (on the CPU: the same plain Jacobi) the two packages run the
same operations in the same order: one step agrees to rtol 1e-10, five
steps to 1e-8 (PyTorch's CPU sqrt is an ulp off XLA's on some inputs, and
CMA-ES ranks candidates, so differences compound).  ``"xla"`` orders and
signs eigenvectors differently and is compared by statistics only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlsolver_torch as nt
from nlsolver_torch import benches
from nlsolver_torch.core import Bounds, lane_where
from nlsolver_torch.interop import cmaes_fleet_state_from_numpy, cmaes_fleet_state_to_numpy
from nlsolver_torch.solvers import cmaes_fleet as tf
from nlsolver_tpu.core import Bounds as JBounds
from nlsolver_tpu.problems import PROBLEMS as JPROBLEMS
from nlsolver_tpu.solvers import cmaes_fleet as jf

torch.set_num_threads(1)
EXACT_FIELDS = ("iteration", "nfev", "no_change", "gen", "kicked", "filled", "done", "converged")
FLOAT_FIELDS = ("mean", "sigma", "C", "D", "Bv", "p_sigma", "p_c", "best_x", "best_value",
                "prev_best", "a_buf", "pc_buf", "y_buf")
MODES = {
    "eager": {},
    "lazy": {"eigen_interval": 5},
    "deferred": {"eigen_interval": 5, "defer_covariance": True},
}


def rosen(x):
    return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2


def t_rastrigin(x):
    return 10.0 * x.shape[0] + (x * x - 10.0 * torch.cos(2.0 * torch.pi * x)).sum(0)


def j_rastrigin(x):
    return 10.0 * x.shape[0] + jnp.sum(x * x - 10.0 * jnp.cos(2.0 * jnp.pi * x))


def test_config_and_state_fields_equal_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(tf.CMAESFleetConfig) == spec(jf.CMAESFleetConfig)
    assert nt.CMAESFleetConfig is tf.CMAESFleetConfig
    # the port's state is JAX's without the key: the draws are an input
    assert tf.CMAESFleetState._fields == tuple(
        f for f in jf.CMAESFleetState._fields if f != "key")


def test_init_refuses_deferral_without_an_interval_as_jax_does():
    for mod, zeros, extra in ((tf, torch.zeros(4, 8), ()), (jf, jnp.zeros((4, 8)),
                                                           (jax.random.key(0),))):
        with pytest.raises(ValueError, match="eigen_interval"):
            mod.init(lambda x: (x * x).sum(), zeros,
                     mod.CMAESFleetConfig(defer_covariance=True, eigen_interval=1), *extra)


def _fields(j_state):
    return {k: np.asarray(v) for k, v in j_state._asdict().items() if k != "key"}


def _assert_states_match(t_state, j_state, rtol):
    got = cmaes_fleet_state_to_numpy(t_state)
    for f in EXACT_FIELDS:
        want = np.asarray(getattr(j_state, f))
        assert np.array_equal(got[f], want), f
        assert got[f].dtype == want.dtype, f
    for f in FLOAT_FIELDS:
        want = np.asarray(getattr(j_state, f))
        finite = want[np.isfinite(want)]
        scale = float(np.abs(finite).max()) if finite.size else 0.0
        np.testing.assert_allclose(got[f], want, rtol=rtol, atol=rtol * scale, err_msg=f)


def _draws(j_state, n, lam, B):
    """The z that the JAX step will draw from this state."""
    _, k_z = jax.random.split(j_state.key)
    return torch.from_numpy(np.array(jax.random.normal(k_z, (n, lam, B), jnp.float64)))


@pytest.mark.parametrize("mode", list(MODES))
def test_init_and_single_steps_from_a_carried_state_match_jax(mode):
    """Each step starts from JAX's own state, so no difference builds up.
    Twelve generations cross two scheduled refreshes of the lazy modes; a
    kick is forced on generation 7, which must refresh on a stale one."""
    n, B = 4, 24
    tcfg = tf.CMAESFleetConfig(**MODES[mode])
    jcfg = jf.CMAESFleetConfig(**MODES[mode])
    lam = tf._params(n, 0)[0]
    X0 = np.full((n, B), -0.5)
    j_state = jf.init(j_rastrigin, jnp.asarray(X0), jcfg, jax.random.key(1))
    _assert_states_match(tf.init(t_rastrigin, torch.from_numpy(X0), tcfg), j_state, rtol=1e-15)
    j_step = jax.jit(lambda s: jf.step(j_rastrigin, s, jcfg))
    refreshed = []
    for g in range(12):
        if g == 7:
            j_state = j_state._replace(kicked=jnp.asarray(True))
        carried = cmaes_fleet_state_from_numpy(_fields(j_state), "cpu")
        refreshed.append(tf.refresh_due(carried, tcfg))
        t_next = tf.step(t_rastrigin, carried, tcfg, z=_draws(j_state, n, lam, B))
        j_state = j_step(j_state)
        _assert_states_match(t_next, j_state, rtol=1e-10)
    want = {"eager": [True] * 12,
            "lazy": [g % 5 == 0 or g == 7 for g in range(12)],
            # the window fills on generations 0-4 and 5-6, the kick empties it
            "deferred": [g in (5, 7) for g in range(12)]}[mode]
    assert refreshed == want


@pytest.mark.parametrize("mode", list(MODES))
def test_five_generations_match_jax(mode):
    """Each package steps from its own state.  ``pop_size=12`` gives mu = n:
    the first covariance update then has full rank, and C no eigenvalue of
    multiplicity two, in whose eigenspace the basis would be arbitrary and
    follow the last bit of C."""
    n, B = 6, 32
    tcfg = tf.CMAESFleetConfig(pop_size=12, **MODES[mode])
    jcfg = jf.CMAESFleetConfig(pop_size=12, **MODES[mode])
    X0 = np.full((n, B), -0.5)
    j_state = jf.init(j_rastrigin, jnp.asarray(X0), jcfg, jax.random.key(2))
    t_state = tf.init(t_rastrigin, torch.from_numpy(X0), tcfg)
    j_step = jax.jit(lambda s: jf.step(j_rastrigin, s, jcfg))
    for g in range(7 if mode == "deferred" else 5):      # the deferred mode first refreshes on 5
        t_state = tf.step(t_rastrigin, t_state, tcfg, z=_draws(j_state, n, 12, B))
        j_state = j_step(j_state)
    _assert_states_match(t_state, j_state, rtol=1e-8)


def test_step_leaves_its_input_state_alone():
    """``step`` writes the deferred buffers into new tensors."""
    n, B = 3, 8
    cfg = tf.CMAESFleetConfig(eigen_interval=3, defer_covariance=True)
    g = torch.Generator().manual_seed(0)
    state = tf.init(rosen, torch.full((n, B), -0.5, dtype=torch.float64), cfg)
    state = tf.step(rosen, state, cfg, generator=g)
    before = {f: v.clone() for f, v in state._asdict().items() if isinstance(v, torch.Tensor)}
    nxt = tf.step(rosen, state, cfg, generator=g)
    for f, v in before.items():
        assert torch.equal(getattr(state, f), v), f
    assert nxt.filled == state.filled + 1 == 2 and nxt.gen == 2
    assert not torch.equal(nxt.pc_buf[1], state.pc_buf[1])
    assert torch.equal(nxt.pc_buf[0], state.pc_buf[0])


@pytest.mark.parametrize("filled", [0, 2, 5])
def test_materialize_matches_jax(filled):
    n, B, K, mu = 4, 12, 5, 3
    rng = np.random.default_rng(filled)
    G = rng.standard_normal((n, n, B))
    C = G + np.swapaxes(G, 0, 1)
    a_buf = rng.uniform(0.8, 1.0, (K, B))
    pc_buf, y_buf = rng.standard_normal((K, n, B)), rng.standard_normal((K, n, mu, B))
    w = np.array([0.5, 0.3, 0.2])
    got = tf._materialize(*(torch.from_numpy(x) for x in (C, a_buf, pc_buf, y_buf)), filled,
                          0.05, 0.1, torch.from_numpy(w), mu, K)
    want = jf._materialize(jnp.asarray(C), jnp.asarray(a_buf), jnp.asarray(pc_buf),
                           jnp.asarray(y_buf), jnp.int32(filled), 0.05, 0.1, jnp.asarray(w), mu, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)
    assert torch.equal(got, got.transpose(0, 1))


def test_bounded_step_with_tied_candidates_matches_jax():
    """A box far smaller than sigma clamps most candidates onto its faces:
    the values of an objective of the first coordinate alone then tie
    exactly (no sum whose order could differ), and the stable argsort must
    break the ties as ``jnp.argsort`` does."""
    n, B = 3, 16
    t_fn, j_fn = (lambda x: (x[0] + 1.0) ** 2), (lambda x: (x[0] + 1.0) ** 2)
    tb = Bounds(torch.zeros(n, dtype=torch.float64), torch.full((n,), 0.05, dtype=torch.float64))
    jb = JBounds(jnp.zeros(n), jnp.full(n, 0.05))
    tcfg, jcfg = tf.CMAESFleetConfig(), jf.CMAESFleetConfig()
    lam = tf._params(n, 0)[0]
    j_state = jf.init(j_fn, jnp.full((n, B), 0.02), jcfg, jax.random.key(4))
    j_step = jax.jit(lambda s: jf.step(j_fn, s, jcfg, jb))
    for _ in range(4):
        z = _draws(j_state, n, lam, B)
        carried = cmaes_fleet_state_from_numpy(_fields(j_state), "cpu")
        xs = torch.clamp(carried.mean[:, None, :] + carried.sigma * z, 0.0, 0.05)
        vals = (xs[0] + 1.0) ** 2
        assert int((vals.sort(dim=0).values.diff(dim=0) == 0).sum()) > B      # many exact ties
        t_next = tf.step(t_fn, carried, tcfg, tb, z=z)
        j_state = j_step(j_state)
        _assert_states_match(t_next, j_state, rtol=1e-10)
    # scalar bounds broadcast like [n] ones
    s_next = tf.step(t_fn, carried, tcfg, Bounds(0.0, 0.05), z=z)
    assert torch.equal(s_next.mean, t_next.mean)


def test_lane_where_keeps_fleet_global_fields():
    """``gen``, ``filled`` (host ints) and ``kicked`` (0-d) carry no lane
    axis: they advance with the state being advanced, whatever the lanes do."""
    state = tf.init(rosen, torch.zeros(2, 4, dtype=torch.float64), tf.CMAESFleetConfig())
    adv = state._replace(gen=7, filled=3, kicked=torch.tensor(True),
                         sigma=state.sigma * 2, mean=state.mean + 1.0)
    pred = torch.tensor([True, False, True, False])
    out = lane_where(pred, state, adv)
    assert out.gen == 7 and out.filled == 3 and bool(out.kicked)
    assert out.sigma.tolist() == [0.5, 1.0, 0.5, 1.0]
    assert out.mean[0].tolist() == [0.0, 1.0, 0.0, 1.0]


def test_finished_lanes_are_frozen_and_the_fleet_runs_on():
    """Lanes halt at different generations (``max_iter`` per lane through
    the carried iteration counts); a halted lane's state stays as it was."""
    n, B = 2, 6
    cfg = tf.CMAESFleetConfig(max_iter=8)
    g = torch.Generator().manual_seed(0)
    state = tf.init(rosen, torch.full((n, B), -0.5, dtype=torch.float64), cfg)
    state = state._replace(iteration=torch.tensor([0, 2, 4, 6, 8, 8], dtype=torch.int32))
    final = tf.drive_fleet(lambda s: tf.step(rosen, s, cfg, generator=g), state)
    assert bool(final.done.all()) and not bool(final.converged.any())
    assert final.iteration.tolist() == [8] * B
    assert final.nfev.tolist() == [1 + 6 * k for k in (8, 6, 4, 2, 0, 0)]
    assert final.gen == 9                     # the slowest lane: 8 steps, and one that halts it
    assert torch.equal(final.mean[:, 4:], state.mean[:, 4:])
    scan = tf.drive_fleet_scan(lambda s: tf.step(rosen, s, cfg, generator=g), state, 12)
    assert scan.gen == 12 and scan.iteration.tolist() == [8] * B


def test_fleet_converges_rosenbrock_as_jax_does():
    B = 64
    got = tf.minimize_fleet(rosen, torch.full((2, B), -0.5, dtype=torch.float64))
    want = jax.jit(lambda X0, k: jf.minimize_fleet(rosen, X0, jf.CMAESFleetConfig(), key=k))(
        jnp.full((2, B), -0.5), jax.random.key(0))
    for res in (got, want):
        fv = np.asarray(res.f_value)
        assert np.asarray(res.x).shape == (2, B)
        assert float(np.median(fv)) < 1e-6 and int(np.sum(fv < 1e-2)) >= 60
        assert np.array_equal(np.asarray(res.function_calls), 1 + 6 * np.asarray(res.iterations))
    # other draws, the same algorithm: the lanes take as long
    assert abs(float(got.iterations.double().median()) - float(np.median(want.iterations))) < 40
    assert got.iterations.dtype == torch.int32 and got.converged.dtype == torch.bool


@pytest.mark.parametrize("method", ["jacobi", "pallas", "xla"])
def test_eigh_backends_agree_statistically(method):
    """The eigensolvers drive the same algorithm: every fleet cracks
    Himmelblau to the JAX fleet's quality (28 of 32 lanes within 0.05 of a
    minimum, the JAX package's own bar)."""
    p, B = nt.PROBLEMS["himmelblau"], 32
    res = tf.minimize_fleet(p.fn, torch.full((2, B), -0.5, dtype=torch.float64),
                            tf.CMAESFleetConfig(eigh_method=method, max_iter=200))
    d = jax.vmap(JPROBLEMS["himmelblau"].distance_to_nearest_minimum, in_axes=1)(
        jnp.asarray(res.x.numpy()))
    assert int(jnp.sum(d <= 0.05)) >= 28, (method, d)
    with pytest.raises(ValueError, match="unknown eigh_method"):
        tf.minimize_fleet(p.fn, torch.zeros(2, 4), tf.CMAESFleetConfig(eigh_method="nope"))


def test_fleet_bounds_projection_reaches_the_corner():
    box = Bounds(torch.zeros(2, dtype=torch.float64), torch.full((2,), 4.0, dtype=torch.float64))
    res = tf.minimize_fleet(lambda x: ((x + 1.0) ** 2).sum(),
                            torch.full((2, 16), 2.0, dtype=torch.float64),
                            tf.CMAESFleetConfig(max_iter=200), bounds=box)
    assert float(res.x.min()) >= -1e-9
    assert float(res.x.abs().max()) <= 1e-2                 # corner optimum
    assert abs(float(res.f_value.median()) - 2.0) < 1e-2
    # a start outside the box is clamped into it first
    out = tf.minimize_fleet(lambda x: ((x + 1.0) ** 2).sum(),
                            torch.full((2, 4), 9.0, dtype=torch.float64),
                            tf.CMAESFleetConfig(max_iter=3), bounds=box)
    assert float(out.x.max()) <= 4.0


def test_deferred_mode_solves_with_kick_and_termination_on():
    res = tf.minimize_fleet(lambda x: (x * x).sum(), torch.full((4, 16), 2.0),
                            tf.CMAESFleetConfig(max_iter=200, eigen_interval=5,
                                                defer_covariance=True),
                            generator=torch.Generator().manual_seed(1))
    assert res.f_value.dtype == torch.float32 and float(res.f_value.median()) < 1e-3


def test_api_route_minimizes_and_maximizes():
    X0 = torch.full((2, 16), -0.5, dtype=torch.float64)
    cfg = nt.CMAESFleetConfig(max_iter=150)
    direct = tf.minimize_fleet(rosen, X0, cfg, generator=torch.Generator().manual_seed(5))
    for method in ("cmaes", "cmaes_fleet"):
        res = nt.minimize(rosen, X0, method=method, layout="fleet", config=cfg,
                          generator=torch.Generator().manual_seed(5))
        assert all(torch.equal(a, b) for a, b in zip(res, direct))
    up = nt.maximize(lambda x: -rosen(x), X0, method="cmaes", layout="fleet", config=cfg,
                     generator=torch.Generator().manual_seed(5))
    assert torch.equal(up.x, direct.x) and torch.equal(up.f_value, -direct.f_value)
    # the default config and generator; bounds pass through
    box = Bounds(torch.zeros(2, dtype=torch.float64), torch.full((2,), 4.0, dtype=torch.float64))
    res = nt.minimize(lambda x: ((x + 1.0) ** 2).sum(), torch.full((2, 8), 2.0, dtype=torch.float64),
                      method="cmaes", layout="fleet", bounds=box)
    assert bool(res.converged.all()) and float(res.x.abs().max()) <= 1e-2
    with pytest.raises(ValueError, match="expects a 2-D x0"):
        nt.minimize(rosen, X0[0], method="cmaes", layout="fleet")
    # layout="single" is the single-instance CMA-ES on one point [n]
    from nlsolver_torch.solvers import cmaes as tc

    one = nt.minimize(rosen, X0[:, 0], method="cmaes", layout="single",
                      config=nt.CMAESConfig(max_iter=50), generator=torch.Generator().manual_seed(5))
    want = tc.minimize(rosen, X0[:, 0], nt.CMAESConfig(max_iter=50),
                       generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(one, want))
    with pytest.raises(ValueError, match="a single start point is"):
        nt.minimize(rosen, X0, method="cmaes", layout="single")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="x0 is not a torch.Tensor and there is no CUDA"):
            nt.minimize(rosen, X0.numpy(), method="cmaes", layout="fleet")


def test_interop_round_trip():
    cfg = jf.CMAESFleetConfig(eigen_interval=3, defer_covariance=True)
    j_state = jf.init(rosen, jnp.full((2, 5), -0.5), cfg, jax.random.key(0))
    j_state = jax.jit(lambda s: jf.step(rosen, s, cfg))(j_state)
    t_state = cmaes_fleet_state_from_numpy(_fields(j_state), "cpu")
    assert t_state.gen == 1 and t_state.filled == 1 and isinstance(t_state.gen, int)
    assert t_state.kicked.ndim == 0 and t_state.y_buf.shape == (3, 2, 3, 5)
    back = cmaes_fleet_state_to_numpy(t_state)
    for f, v in _fields(j_state).items():
        assert np.array_equal(back[f], v) and back[f].dtype == v.dtype, f
    with pytest.raises(ValueError, match="missing fields"):
        cmaes_fleet_state_from_numpy({"mean": np.zeros((2, 5))}, "cpu")


# the f32 scenarios that chip_smoke.py drives at B = 65536, here at B = 1024
# through both packages; the limits are the ones the script holds on the card
RASTRIGIN_MEDIAN_LIMIT = {"eager": 80.0, "deferred": 85.0}


@pytest.mark.parametrize("mode", ["eager", "deferred"])
def test_f32_rastrigin_fleet_reaches_the_jax_fleets_statistics(mode):
    """The bench scenario (16-D Rastrigin from -0.5, termination off, 50
    generations): from 324.0 the JAX fleet's median best value falls to
    61-65 (eager) and 66-71 (interval 5, deferred) over three keys at
    B = 1024; the port's draws differ, its median lies within 10 of JAX's,
    and both lie under the limit that chip_smoke.py holds."""
    n, B = 16, 1024
    kw = MODES[mode]
    jcfg = jf.CMAESFleetConfig(max_iter=1 << 30, best_value_no_change=1 << 30, f_tol=0.0,
                               kick_tol=0.0, cond_max=jnp.inf, **kw)
    fn = JPROBLEMS["rastrigin"].fn
    want = np.asarray(jax.jit(lambda X0, key: jf.drive_fleet_scan(
        lambda s: jf.step(fn, s, jcfg), jf.init(fn, X0, jcfg, key), 50).best_value)(
            jnp.full((n, B), -0.5, jnp.float32), jax.random.key(0)))
    tcfg = benches.rastrigin_fleet_config("pallas", kw.get("eigen_interval", 1),
                                          kw.get("defer_covariance", False))
    final = benches.run_rastrigin_fleet(tcfg, B, n, 50, device="cpu")
    got = final.best_value.numpy()
    assert got.dtype == want.dtype == np.float32 and final.gen == 50
    assert abs(float(np.median(got)) - float(np.median(want))) < 10.0
    for bv in (got, want):
        assert float(np.median(bv)) < RASTRIGIN_MEDIAN_LIMIT[mode] and float(bv.max()) < 324.0


def test_f32_bowl_fleet_halts_as_the_jax_fleet_does():
    """``minimize`` with the default config until every lane halts, on an
    8-D anisotropic bowl from per-lane starts: in both packages every lane
    converges by the stagnation rule well before ``max_iter``, ends below
    1e-6 (97 % of the lanes below 1e-9: 0.9775 here, 0.9814 in JAX), and
    counts ``1 + lam * iterations`` function calls.  chip_smoke.py holds
    the same limits on the card."""
    n, B = 8, 1024
    rng = np.random.default_rng(0)
    scales = rng.uniform(0.5, 3.0, n).astype(np.float32)
    X0 = rng.standard_normal((n, B)).astype(np.float32)
    ts = torch.from_numpy(scales)
    got = nt.minimize(lambda x: (ts * x * x).sum(), torch.from_numpy(X0),
                      method="cmaes", layout="fleet")
    want = jax.jit(lambda X: jf.minimize_fleet(lambda x: jnp.sum(scales * x * x), X))(
        jnp.asarray(X0))
    lam = tf._params(n, 0)[0]
    for res in (got, want):
        its, fv = np.asarray(res.iterations), np.asarray(res.f_value)
        assert np.asarray(res.converged).all() and its.max() < 500
        assert np.array_equal(np.asarray(res.function_calls), 1 + lam * its)
        assert fv.dtype == np.float32 and float(fv.max()) < 1e-6
        assert float((fv < 1e-9).mean()) >= 0.97
        assert 200 < float(np.median(its)) < 400
    assert abs(float(got.iterations.double().median()) - float(np.median(want.iterations))) < 30
