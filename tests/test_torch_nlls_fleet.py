"""nlsolver_torch.solvers.nlls_fleet against nlsolver_tpu.solvers.nlls_fleet
(f64 on the CPU): the config, single steps from one shared state for each
solve backend, whole fleets lane by lane, the fleet against the port's
vmapped scalar driver, the shapes that would trip a leading-axis lane
select, and the state interop.

The JAX ``qr_pallas`` backend runs its Pallas kernel in interpret mode;
the port's runs kernel K2b's plain twin on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlsolver_torch as nt
from nlsolver_torch.interop import nlls_fleet_state_from_numpy, nlls_fleet_state_to_numpy
from nlsolver_torch.solvers import nlls as tn
from nlsolver_torch.solvers import nlls_fleet as tnf
from nlsolver_tpu.solvers import nlls_fleet as jnf

torch.set_num_threads(1)
SOLVES = ["cholesky", "qr", "qr_pallas"]
INT_FIELDS = ("iteration", "nfev", "jev", "done", "converged")


def _configs(solve, **kw):
    return (tnf.NLLSFleetConfig(solve=solve, **kw),
            jnf.NLLSFleetConfig(solve=solve, pallas_interpret=solve == "qr_pallas", **kw))


@pytest.fixture(scope="module")
def expfit():
    """tests/test_nlls_fleet.py's exp fit, drawn with numpy: B=64, m=32."""
    B, m = 64, 32
    rng = np.random.default_rng(0)
    amps, rates = rng.uniform(1.0, 3.0, B), rng.uniform(0.5, 2.0, B)
    t = np.linspace(0.0, 2.0, m)
    ys = amps[:, None] * np.exp(-rates[:, None] * t[None, :])
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    return (lambda p, y: p[0] * torch.exp(-p[1] * tt) - y,
            lambda p, y: p[0] * jnp.exp(-p[1] * jt) - y, ys, amps, rates)


def test_config_fields_and_defaults_equal_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(tnf.NLLSFleetConfig) == spec(jnf.NLLSFleetConfig)
    assert nt.NLLSFleetConfig is tnf.NLLSFleetConfig and nt.fit_fleet is tnf.fit_fleet


def _assert_states_match(t_state, j_state, rtol):
    got = nlls_fleet_state_to_numpy(t_state)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(j_state, f)), err_msg=f)
    for f in ("x", "cost", "prev_cost", "lam"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(j_state, f)), rtol=rtol, atol=1e-300,
                                   err_msg=f)


@pytest.mark.parametrize("solve", SOLVES)
def test_steps_from_one_state_match_jax(expfit, solve):
    tres, jres, ys, _, _ = expfit
    tcfg, jcfg = _configs(solve)
    B = ys.shape[0]
    j_state = jnf.init(jres, jnp.ones((2, B)), jcfg, jnp.asarray(ys))
    j_step = jax.jit(lambda s: jnf.step(jres, s, jcfg, jnp.asarray(ys)))
    for _ in range(3):
        fields = {k: np.asarray(v) for k, v in j_state._asdict().items()}
        t_next = tnf.step(tres, nlls_fleet_state_from_numpy(fields, "cpu"), tcfg,
                          torch.from_numpy(ys))
        j_state = j_step(j_state)
        _assert_states_match(t_next, j_state, rtol=1e-10)
    assert not bool(np.asarray(j_state.done).all())


@pytest.mark.parametrize("solve", SOLVES)
def test_fit_fleet_matches_jax_lane_by_lane(expfit, solve):
    tres, jres, ys, amps, rates = expfit
    tcfg, jcfg = _configs(solve, max_iter=30)
    B = ys.shape[0]
    got = nt.fit_fleet(tres, torch.ones(2, B, dtype=torch.float64), tcfg, data=torch.from_numpy(ys))
    want = jax.jit(lambda X, d: jnf.fit_fleet(jres, X, jcfg, data=d))(jnp.ones((2, B)), ys)
    for field in ("iterations", "function_calls", "gradient_calls", "converged"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-9)
    assert got.x.shape == (2, B) and float((got.f_value < 1e-6).double().mean()) == 1.0
    np.testing.assert_allclose(got.x.numpy(), np.stack([amps, rates]), atol=1e-6)


def test_fleet_matches_vmapped_scalar(expfit):
    """Same algorithm and lambda schedule: the same accept/reject path and
    the same iterates as solvers.nlls.fit_batched."""
    tres, _, ys, _, _ = expfit
    B = ys.shape[0]
    fleet = nt.fit_fleet(tres, torch.ones(2, B, dtype=torch.float64),
                         tnf.NLLSFleetConfig(max_iter=30), data=torch.from_numpy(ys))
    ref = nt.fit_batched(tres, torch.ones(B, 2, dtype=torch.float64), tn.NLLSConfig(max_iter=30),
                         data=torch.from_numpy(ys))
    np.testing.assert_array_equal(fleet.iterations.numpy(), ref.iterations.numpy())
    np.testing.assert_allclose(fleet.x.numpy(), ref.x.T.numpy(), rtol=0, atol=1e-12)


def test_fleet_no_data_mode():
    target = torch.tensor([2.0, -1.0], dtype=torch.float64)
    res = nt.fit_fleet(lambda x: x - target, torch.zeros(2, 16, dtype=torch.float64),
                       tnf.NLLSFleetConfig(max_iter=20))
    torch.testing.assert_close(res.x, target[:, None].expand(2, 16), atol=1e-6, rtol=0)


def test_unknown_solve_raises(expfit):
    tres, _, ys, _, _ = expfit
    with pytest.raises(ValueError, match="unknown solve"):
        nt.fit_fleet(tres, torch.ones(2, ys.shape[0], dtype=torch.float64),
                     tnf.NLLSFleetConfig(solve="nope"), data=torch.from_numpy(ys))


def test_rejected_step_stall_halts_via_lambda_ceiling_n1():
    """n=1: x is [1, B], the shape a leading-axis select would broadcast to
    [B, B].  The lambda ceiling halts the stalled lanes, converged=False,
    as in the JAX package."""
    def residual(p):
        return p[:1].abs() + 1.0

    cfg = tnf.NLLSFleetConfig(max_iter=10_000, lambda_max=1e6, f_delta=0.0)
    res = nt.fit_fleet(residual, torch.tensor([[1.0, -2.0]], dtype=torch.float64), cfg)
    want = jnf.fit_fleet(lambda p: jnp.abs(p[:1]) + 1.0, jnp.asarray([[1.0, -2.0]]),
                         jnf.NLLSFleetConfig(max_iter=10_000, lambda_max=1e6, f_delta=0.0))
    assert res.x.shape == (1, 2)
    assert int(res.iterations.max()) < 100 and not bool(res.converged.any())
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-12)


def test_square_fleet_n_equals_B_matches_jax():
    """n == B: a leading-axis select would pick along the parameter axis."""
    t = np.linspace(0.0, 2.0, 12)
    ys = np.array([1.5, 2.5])[:, None] * np.exp(-np.array([0.7, 1.8])[:, None] * t)
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    X0 = np.array([[1.5, 1.0], [0.7, 1.0]])          # [n=2, B=2]; lane 0 starts at its fit
    got = nt.fit_fleet(lambda p, y: p[0] * torch.exp(-p[1] * tt) - y, torch.from_numpy(X0),
                       tnf.NLLSFleetConfig(max_iter=30), data=torch.from_numpy(ys))
    want = jnf.fit_fleet(lambda p, y: p[0] * jnp.exp(-p[1] * jt) - y, jnp.asarray(X0),
                         jnf.NLLSFleetConfig(max_iter=30), data=jnp.asarray(ys))
    assert len(set(got.iterations.tolist())) == 2           # the lanes stop at different steps
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-9)


def test_interop_round_trip(expfit):
    tres, _, ys, _, _ = expfit
    state = tnf.init(tres, torch.ones(2, ys.shape[0], dtype=torch.float64),
                     tnf.NLLSFleetConfig(), torch.from_numpy(ys))
    back = nlls_fleet_state_from_numpy(nlls_fleet_state_to_numpy(state), "cpu")
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="missing fields"):
        nlls_fleet_state_from_numpy({"x": np.zeros((2, 3))}, "cpu")


def test_chebyshev_fleet_through_cholesky_matches_jax_lane_by_lane():
    """A fleet of series in a polynomial basis, 12 Chebyshev coefficients
    from 32 samples at the Chebyshev nodes (``benches.chebyshev_scenario``'s
    fits, drawn with numpy), through the default backend: the twin of K3
    past K3's n = 2 exp fits; f64, B = 16."""
    n, m, B = 12, 32, 16
    rng = np.random.default_rng(3)
    theta = np.pi * (np.arange(m) + 0.5) / m
    basis = np.cos(np.arange(n)[:, None] * theta[None, :])            # [n, m]
    coefs = rng.standard_normal((n, B))
    ys = np.ascontiguousarray((basis.T @ coefs).T)                     # [B, m]
    tb, jb = torch.from_numpy(basis), jnp.asarray(basis)
    tcfg, jcfg = _configs("cholesky", max_iter=30)
    got = nt.fit_fleet(lambda p, y: p @ tb - y, torch.zeros(n, B, dtype=torch.float64), tcfg,
                       data=torch.from_numpy(ys))
    want = jax.jit(lambda X, d: jnf.fit_fleet(lambda p, y: p @ jb - y, X, jcfg, data=d))(
        jnp.zeros((n, B)), ys)
    for field in ("iterations", "function_calls", "gradient_calls", "converged"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), coefs, atol=1e-6)


def test_numpy_start_points_need_a_card(expfit):
    """X0 and data that are no torch.Tensor go to the card as minimize's
    start points do; without one fit_fleet raises the start points' error,
    not a vmap error."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_smallchol.py::"
                    "test_fit_fleet_numpy_start_points_land_on_the_card covers it")
    tres, _, ys, _, _ = expfit
    with pytest.raises(RuntimeError, match="X0 is not a torch.Tensor and there is no CUDA card"):
        nt.fit_fleet(tres, np.ones((2, ys.shape[0])), tnf.NLLSFleetConfig(max_iter=3),
                     data=torch.from_numpy(ys))
    with pytest.raises(RuntimeError, match="data is not a torch.Tensor and there is no CUDA card"):
        nt.fit_fleet(tres, torch.ones(2, ys.shape[0], dtype=torch.float64),
                     tnf.NLLSFleetConfig(max_iter=3), data=ys)



def test_pytree_data_of_cpu_tensors(expfit):
    """data may be any pytree whose leaves lead with B (a dict, nested
    tuples): its CPU tensors stay where they are and the fleet equals the
    one given the bare tensor; a numpy leaf goes the start points' way."""
    tres, _, ys, _, _ = expfit
    cfg, y = tnf.NLLSFleetConfig(max_iter=30), torch.from_numpy(ys)
    X0 = torch.ones(2, ys.shape[0], dtype=torch.float64)
    want = nt.fit_fleet(tres, X0, cfg, data=y)
    got = nt.fit_fleet(lambda p, d: tres(p, d["y"]) * d["w"][0][0], X0, cfg,
                       data={"y": y, "w": ((torch.ones_like(y[:, 0]),),)})
    assert torch.equal(got.x, want.x) and torch.equal(got.iterations, want.iterations)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="data is not a torch.Tensor and there is no CUDA"):
            nt.fit_fleet(tres, X0, cfg, data={"y": ys})
