"""nlsolver_torch.solvers.bfgs_fleet against nlsolver_tpu.solvers.bfgs_fleet
(f64 on the CPU): the config, ``init`` and single steps from a JAX state
carried over by ``interop``, whole fleets lane by lane, lane freezing, the
curvature guard, and the ``minimize`` / ``maximize`` route.

The update + direction runs the plain twin of kernels K4a/K4b on the CPU.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlsolver_torch as nt
from nlsolver_torch import api as tapi
from nlsolver_torch.interop import bfgs_fleet_state_from_numpy, bfgs_fleet_state_to_numpy
from nlsolver_torch.solvers import bfgs_fleet as tb
from nlsolver_tpu.solvers import bfgs_fleet as jb

torch.set_num_threads(1)
LINESEARCHES = ["more_thuente", "speculative"]
EXACT_FIELDS = ("pending_reset", "iteration", "nfev", "gfev", "done", "converged")
FLOAT_FIELDS = ("x", "gradient", "inv_hessian", "direction", "prev_grad_norm", "grad_norm")
COUNTERS = ("iterations", "function_calls", "gradient_calls", "converged")


def _bowls(n, B, seed=0):
    """Anisotropic bowls closing over per-lane [n, B] data, for both packages."""
    rng = np.random.default_rng(seed)
    centers, scales = rng.standard_normal((n, B)), rng.uniform(0.5, 3.0, (n, B))
    tc, ts = torch.from_numpy(centers), torch.from_numpy(scales)
    return (lambda X: (ts * (X - tc) ** 2).sum(0),
            lambda X: jnp.sum(scales * (X - centers) ** 2, axis=0), centers)


def _rosen(X):
    return 100.0 * (X[0] ** 2 - X[1]) ** 2 + (X[0] - 1.0) ** 2


def _mixed(B):
    """tests/test_bfgs_fleet.py's mixed-conditioning fleet: n=4, per-lane
    condition numbers 1..100."""
    conds = np.logspace(0, 2, B)
    w = np.stack([np.ones(B), conds, np.ones(B), conds])
    tw = torch.from_numpy(w)
    return (lambda X: (X ** 2 * tw).sum(0) + 0.05 * (X ** 4).sum(0),
            lambda X: jnp.sum(X ** 2 * w, axis=0) + 0.05 * jnp.sum(X ** 4, axis=0))


def test_config_fields_and_defaults_equal_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(tb.BFGSFleetConfig) == spec(jb.BFGSFleetConfig)
    assert tb.BFGSFleetState._fields == jb.BFGSFleetState._fields
    assert nt.BFGSFleetConfig is tb.BFGSFleetConfig


def _assert_states_match(t_state, j_state, rtol):
    got = bfgs_fleet_state_to_numpy(t_state)
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j_state, f)), err_msg=f)
        assert got[f].dtype == np.asarray(getattr(j_state, f)).dtype, f
    for f in FLOAT_FIELDS:
        want = np.asarray(getattr(j_state, f))
        np.testing.assert_allclose(got[f], want, rtol=rtol, atol=rtol * np.abs(want).max(),
                                   err_msg=f)


@pytest.mark.parametrize("linesearch", LINESEARCHES)
def test_init_and_steps_from_a_carried_state_match_jax(linesearch):
    """Each step starts from JAX's own state, so no difference builds up."""
    n, B = 6, 40
    t_cols, j_cols, _ = _bowls(n, B, seed=1)
    tcfg = tb.BFGSFleetConfig(max_iter=30, linesearch=linesearch)
    jcfg = jb.BFGSFleetConfig(max_iter=30, linesearch=linesearch)
    j_state = jb.init(j_cols, jnp.zeros((n, B)), jcfg)
    _assert_states_match(tb.init(t_cols, torch.zeros(n, B, dtype=torch.float64), tcfg),
                         j_state, rtol=1e-14)
    j_step = jax.jit(lambda s: jb.step(j_cols, s, jcfg))
    for k in range(6):
        if k == 3:  # injected: a third of the lanes take the identity for H in this update
            j_state = j_state._replace(pending_reset=jnp.arange(B) % 3 == 0)
        fields = {k: np.asarray(v) for k, v in j_state._asdict().items()}
        t_next = tb.step(t_cols, bfgs_fleet_state_from_numpy(fields, "cpu"), tcfg)
        j_state = j_step(j_state)
        _assert_states_match(t_next, j_state, rtol=1e-12)
    assert not bool(np.asarray(j_state.done).all())


def _assert_results_match(got, want, atol=1e-8):
    for field in COUNTERS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=atol)
    np.testing.assert_allclose(got.f_value.numpy(), np.asarray(want.f_value), rtol=1e-9, atol=1e-12)
    assert got.iterations.dtype == torch.int32 and got.converged.dtype == torch.bool


@pytest.mark.parametrize("linesearch", LINESEARCHES)
def test_bowls_fleet_matches_jax_lane_by_lane(linesearch):
    n, B = 16, 128
    t_cols, j_cols, centers = _bowls(n, B)
    got = tb.minimize_fleet(t_cols, torch.zeros(n, B, dtype=torch.float64),
                            tb.BFGSFleetConfig(max_iter=30, linesearch=linesearch))
    want = jax.jit(lambda X: jb.minimize_fleet(
        j_cols, X, jb.BFGSFleetConfig(max_iter=30, linesearch=linesearch)))(jnp.zeros((n, B)))
    _assert_results_match(got, want)
    assert got.x.shape == (n, B) and int(got.iterations.max()) < 30
    # grad_eps=5e-3 with scale >= 0.5 allows |x - c| up to about 5e-3
    np.testing.assert_allclose(got.x.numpy(), centers, atol=5e-3)
    assert float((got.f_value < 1e-4).double().mean()) == 1.0


def _f32_bowls_through_both(centers, scales, linesearch):
    n, B = centers.shape
    tc, ts = torch.from_numpy(centers), torch.from_numpy(scales)
    got = tb.minimize_fleet(lambda X: (ts * (X - tc) ** 2).sum(0), torch.zeros(n, B),
                            tb.BFGSFleetConfig(max_iter=30, linesearch=linesearch))
    want = jax.jit(lambda X: jb.minimize_fleet(
        lambda X: jnp.sum(scales * (X - centers) ** 2, axis=0), X,
        jb.BFGSFleetConfig(max_iter=30, linesearch=linesearch)))(jnp.zeros((n, B), jnp.float32))
    return got, want


@pytest.mark.parametrize("linesearch", LINESEARCHES)
def test_f32_bowls_halt_unconverged_on_the_same_lanes_as_jax(linesearch):
    """In f32 the stalled-gradient-norm rule (|grad_norm - prev_grad_norm| <
    grad_eps) halts about 1 % (more_thuente) and 7 % (speculative) of the
    bowls before grad_norm < grad_eps: in both packages, on the same lanes,
    after the same iterations.  So a fleet of many lanes is not all
    ``converged``, and its worst lane lies within 1e-2 of its center, not
    5e-3."""
    n, B = 16, 1024
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((n, B)).astype(np.float32)
    scales = rng.uniform(0.5, 3.0, (n, B)).astype(np.float32)
    got, want = _f32_bowls_through_both(centers, scales, linesearch)
    for field in COUNTERS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-5)
    share = float(got.converged.float().mean())
    assert (0.98 if linesearch == "more_thuente" else 0.92) <= share < 1.0
    assert int(got.iterations.max()) < 30 and float(got.f_value.max()) < 1e-4
    assert float(np.abs(got.x.numpy() - centers).max()) < 1e-2


@pytest.mark.parametrize("linesearch", LINESEARCHES)
def test_lanes_unconverged_on_the_h100_are_unconverged_in_jax_too(linesearch):
    """tests/data/torch_bfgs_unconverged_lanes.npz holds 65 of the lanes that
    halted without ``converged`` when an H100 ran the 65536-bowl fleet
    (``nlsolver_torch.benches.unconverged_bowls``, f32, kernel K4a), the lane
    farthest from its center among them, with the card's x, iterations and
    function calls.  Lanes are independent, so the same lanes go through the
    JAX fleet and through the port's CPU path here: both halt them
    unconverged too, after the same iterations and function calls."""
    data = np.load(pathlib.Path(__file__).parent / "data" / "torch_bfgs_unconverged_lanes.npz")
    card = {k: data[f"{linesearch}_{k}"] for k in
            ("centers", "scales", "x", "iterations", "function_calls")}
    got, want = _f32_bowls_through_both(card["centers"], card["scales"], linesearch)
    for res, x in ((got, got.x.numpy()), (want, np.asarray(want.x))):
        assert not np.asarray(res.converged).any()
        np.testing.assert_array_equal(np.asarray(res.iterations), card["iterations"])
        np.testing.assert_array_equal(np.asarray(res.function_calls), card["function_calls"])
        np.testing.assert_allclose(x, card["x"], rtol=0, atol=1e-5)
    assert 5e-3 < float(np.abs(card["x"] - card["centers"]).max()) < 1e-2


@pytest.mark.parametrize("linesearch", LINESEARCHES)
def test_rosenbrock_fleet_matches_jax(linesearch):
    B = 64
    starts = np.stack([np.full(B, -0.5), np.linspace(-1.0, 1.0, B)])
    kw = dict(max_iter=100 if linesearch == "more_thuente" else 200, grad_eps=1e-5,
              linesearch=linesearch)
    got = tb.minimize_fleet(_rosen, torch.from_numpy(starts), tb.BFGSFleetConfig(**kw))
    want = jax.jit(lambda X: jb.minimize_fleet(_rosen, X, jb.BFGSFleetConfig(**kw)))(starts)
    _assert_results_match(got, want)
    if linesearch == "more_thuente":
        assert float(got.f_value.max()) < 1e-6
        np.testing.assert_allclose(got.x.numpy(), np.ones((2, B)), atol=1e-2)
    else:  # the unrefined grid stalls on some of these starts, in both packages alike
        assert float(got.f_value.median()) < 1e-6


def test_mixed_conditioning_fleet_matches_jax_and_lanes_freeze_independently():
    n, B = 4, 8
    t_cols, j_cols = _mixed(B)
    kw = dict(max_iter=60, grad_eps=1e-6)
    got = tb.minimize_fleet(t_cols, torch.ones(n, B, dtype=torch.float64), tb.BFGSFleetConfig(**kw))
    want = jax.jit(lambda X: jb.minimize_fleet(j_cols, X, jb.BFGSFleetConfig(**kw)))(
        jnp.ones((n, B)))
    _assert_results_match(got, want)
    its = got.iterations.tolist()
    assert len(set(its)) > 1 and max(its) <= 60     # different stop times, and they stick
    assert float(got.x.abs().max()) < 1e-2
    # step freezes finished lanes itself: lanes done early sit through the
    # slower lanes' steps, and one more step on the finished fleet moves nothing
    cfg = tb.BFGSFleetConfig(**kw)
    state = tb.drive_fleet(lambda s: tb.step(t_cols, s, cfg),
                           tb.init(t_cols, torch.ones(n, B, dtype=torch.float64), cfg))
    assert bool(state.done.all()) and torch.equal(state.iteration, got.iterations)
    for a, b in zip(state, tb.step(t_cols, state, cfg)):
        assert torch.equal(a, b)


def test_failed_linesearch_never_stores_nonfinite_H():
    """An alpha = 0 line search (s = y = 0) would make rho = 1/0 and write
    a non-finite inv_hessian.  The curvature guard keeps H finite and flags
    the reset.  Forced with an ASCENT direction on a linear objective, as
    in the JAX package's test, and held against its step."""
    n, B = 3, 4
    w = np.linspace(1.0, 2.0, n)[:, None]
    tw = torch.from_numpy(w).float()
    t_cols = lambda X: (tw * X).sum(0)  # noqa: E731
    j_cols = lambda X: jnp.sum(w.astype(np.float32) * X, axis=0)  # noqa: E731
    tcfg = tb.BFGSFleetConfig(linesearch="speculative")
    state = tb.init(t_cols, torch.ones(n, B), tcfg)
    state = state._replace(direction=state.gradient)
    new = tb.step(t_cols, state, tcfg)
    assert bool(torch.isfinite(new.inv_hessian).all()) and bool(new.pending_reset.all())
    assert torch.equal(new.direction, -new.gradient)
    j_state = jb.init(j_cols, jnp.ones((n, B), jnp.float32), jb.BFGSFleetConfig(linesearch="speculative"))
    j_new = jb.step(j_cols, j_state._replace(direction=j_state.gradient),
                    jb.BFGSFleetConfig(linesearch="speculative"))
    _assert_states_match(new, j_new, rtol=1e-6)
    # a subnormal curvature is no curvature: rho stays 0 and H finite
    tiny = tb.init(lambda X: 1e-30 * (X ** 2).sum(0), torch.ones(2, 3), tcfg)
    stepped = tb.step(lambda X: 1e-30 * (X ** 2).sum(0), tiny, tb.BFGSFleetConfig())
    assert bool(torch.isfinite(stepped.inv_hessian).all())


def test_unknown_linesearch_raises():
    t_cols, _, _ = _bowls(2, 3)
    with pytest.raises(ValueError, match="unknown linesearch"):
        tb.minimize_fleet(t_cols, torch.zeros(2, 3, dtype=torch.float64),
                          tb.BFGSFleetConfig(linesearch="nope"))


def test_api_route_with_fn_fn_cols_and_maximize():
    n, B = 3, 10
    t_cols, j_cols, centers = _bowls(n, B, seed=2)
    X0 = torch.zeros(n, B, dtype=torch.float64)
    cfg = tb.BFGSFleetConfig(max_iter=40, grad_eps=1e-8)
    direct = tb.minimize_fleet(t_cols, X0, cfg)
    via_cols = nt.minimize(None, X0, method="bfgs", layout="fleet", config=cfg, fn_cols=t_cols)
    for a, b in zip(direct, via_cols):
        assert torch.equal(a, b)
    # a single-point objective is lifted over the columns
    sphere = lambda x: ((x - 0.25) ** 2).sum()  # noqa: E731
    lifted = nt.minimize(sphere, X0, method="bfgs_fleet", layout="fleet")
    want = jax.jit(lambda X: jb.minimize_fleet(jb.colwise(lambda x: jnp.sum((x - 0.25) ** 2)), X))(
        jnp.zeros((n, B)))
    _assert_results_match(lifted, want)
    np.testing.assert_allclose(lifted.x.numpy(), 0.25, atol=1e-3)
    # maximize: the lifted objective is sign-wrapped, an explicit fn_cols negated
    up = nt.maximize(lambda x: -sphere(x), X0, method="bfgs", layout="fleet")
    assert torch.equal(up.x, lifted.x) and torch.equal(up.f_value, -lifted.f_value)
    up_cols = nt.maximize(None, X0, method="bfgs", layout="fleet", config=cfg,
                          fn_cols=lambda X: -t_cols(X))
    assert torch.equal(up_cols.x, direct.x) and torch.equal(up_cols.f_value, -direct.f_value)
    np.testing.assert_allclose(direct.x.numpy(), centers, atol=1e-6)


def test_api_route_refuses_bounds_shapes_and_unported_methods():
    X0 = torch.zeros(2, 4, dtype=torch.float64)
    sphere = lambda x: (x ** 2).sum()  # noqa: E731
    with pytest.raises(ValueError, match="the BFGS fleet is unconstrained; use method='lbfgsb'"):
        nt.minimize(sphere, X0, method="bfgs", layout="fleet", bounds=(-1.0, 1.0))
    with pytest.raises(ValueError, match="expects a 2-D x0"):
        nt.minimize(sphere, X0[0], method="bfgs", layout="fleet")
    # the mesh routes refuse what the JAX package's refuse: no mesh, bounds
    # on the BFGS fleet, a method the islands do not run
    with pytest.raises(ValueError, match="requires a mesh= argument"):
        nt.minimize(sphere, X0, method="cmaes", layout="sharded")
    with pytest.raises(ValueError, match="the BFGS fleet is unconstrained"):
        nt.minimize(sphere, X0, method="bfgs", layout="sharded", bounds=(-1.0, 1.0),
                    mesh=object())
    with pytest.raises(ValueError, match="requires a mesh= argument"):
        nt.minimize(sphere, X0.T, method="pso", layout="sharded")
    res = nt.minimize(sphere, X0[0] + 1.0, method="nelder_mead", layout="single")
    assert res.x.shape == (4,) and float(res.f_value) < 1e-8
    with pytest.raises(ValueError, match="layout='islands' supports method='de', got 'cmaes'"):
        nt.minimize(sphere, X0.T, method="cmaes", layout="islands", mesh=object())
    # layout="single" of bfgs is ported: it takes one start point [n]
    with pytest.raises(ValueError, match="a single start point is"):
        nt.minimize(sphere, X0, method="bfgs", layout="single")


def test_start_points_that_are_no_tensor_need_a_card():
    """A tensor keeps its device; a numpy array or a list goes to the card,
    and without one the entry points raise rather than run on the CPU."""
    t = torch.zeros(2, 3)
    assert tapi.start_points(t) is t
    if torch.cuda.is_available():
        assert tapi.start_points(np.zeros((2, 3))).device.type == "cuda"
        return
    sphere = lambda x: (x ** 2).sum(-1)  # noqa: E731
    for x0, kw in ((np.zeros((2, 3)), dict(method="bfgs", layout="fleet")),
                   ([[0.0, 1.0]], dict(method="de", layout="batched"))):
        for entry in (nt.minimize, nt.maximize):
            with pytest.raises(RuntimeError, match="x0 is not a torch.Tensor and there is no CUDA"):
                entry(sphere, x0, **kw)


def test_interop_round_trip():
    t_cols, _, _ = _bowls(3, 5)
    state = tb.init(t_cols, torch.zeros(3, 5, dtype=torch.float64), tb.BFGSFleetConfig())
    back = bfgs_fleet_state_from_numpy(bfgs_fleet_state_to_numpy(state), "cpu")
    assert len(state) == 12
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="missing fields"):
        bfgs_fleet_state_from_numpy({"x": np.zeros((2, 3))}, "cpu")
