"""nlsolver_torch.solvers.nlls against nlsolver_tpu.solvers.nlls: the
config, single fits of tests/test_nlls.py, curve fitting, and the batched
exp fit lane by lane (f64 on the CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlsolver_torch as nt
from nlsolver_torch.solvers import nlls as tn
from nlsolver_tpu.solvers import nlls as jn

torch.set_num_threads(1)


def test_config_fields_and_defaults_equal_jax():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(tn.NLLSConfig) == spec(jn.NLLSConfig)
    assert nt.NLLSConfig is tn.NLLSConfig and nt.fit is tn.fit


def test_linear_fit_exact():
    A = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], dtype=torch.float64)
    y = torch.tensor([7.0, 8.0, 9.0], dtype=torch.float64)
    res = nt.fit(lambda x: A @ x - y, torch.zeros(2, dtype=torch.float64))
    expect = torch.linalg.lstsq(A, y).solution
    torch.testing.assert_close(res.x, expect, atol=1e-6, rtol=0)
    assert bool(res.converged)


def test_rosenbrock_as_residuals():
    def r(x):
        return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    res = nt.fit(r, torch.tensor([-1.2, 1.0], dtype=torch.float64))
    torch.testing.assert_close(res.x, torch.ones(2, dtype=torch.float64), atol=1e-6, rtol=0)
    assert float(res.f_value) < 1e-12


@pytest.mark.parametrize("solve", ["cholesky", "qr"])
def test_curve_fit_matches_jax(solve):
    t = np.linspace(0.0, 4.0, 64)
    y = 2.5 * np.exp(-1.3 * t) + 0.5 + 0.001 * np.random.default_rng(0).standard_normal(64)
    cfg_t, cfg_j = tn.NLLSConfig(solve=solve), jn.NLLSConfig(solve=solve)
    got = nt.curve_fit(lambda p, t: p[0] * torch.exp(-p[1] * t) + p[2], torch.from_numpy(t),
                       torch.from_numpy(y), torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64), cfg_t)
    want = jax.jit(lambda p0: jn.curve_fit(lambda p, t: p[0] * jnp.exp(-p[1] * t) + p[2],
                                           jnp.asarray(t), jnp.asarray(y), p0, cfg_j))(
        jnp.asarray([1.0, 1.0, 0.0]))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), [2.5, 1.3, 0.5], atol=0.05)


@pytest.fixture(scope="module")
def expfit():
    B, m = 32, 24
    rng = np.random.default_rng(1)
    amps, rates = rng.uniform(1.0, 3.0, B), rng.uniform(0.5, 2.0, B)
    t = np.linspace(0.0, 2.0, m)
    ys = amps[:, None] * np.exp(-rates[:, None] * t[None, :])
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    return (lambda p, y: p[0] * torch.exp(-p[1] * tt) - y,
            lambda p, y: p[0] * jnp.exp(-p[1] * jt) - y, ys)


@pytest.mark.parametrize("solve", ["cholesky", "qr"])
def test_fit_batched_matches_jax_lane_by_lane(expfit, solve):
    tres, jres, ys = expfit
    B = ys.shape[0]
    x0 = np.ones((B, 2))
    got = nt.fit_batched(tres, torch.from_numpy(x0), tn.NLLSConfig(max_iter=40, solve=solve),
                         data=torch.from_numpy(ys))
    want = jax.jit(lambda x0, ys: jn.fit_batched(jres, x0, jn.NLLSConfig(max_iter=40, solve=solve),
                                                 data=ys))(x0, ys)
    for field in ("iterations", "function_calls", "gradient_calls", "converged"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-9)
    assert float(got.f_value.max()) < 1e-10


def test_fit_batched_without_data():
    target = torch.tensor([2.0, -1.0], dtype=torch.float64)
    res = nt.fit_batched(lambda x: x - target, torch.zeros(5, 2, dtype=torch.float64),
                         tn.NLLSConfig(max_iter=20))
    torch.testing.assert_close(res.x, target.expand(5, 2), atol=1e-6, rtol=0)
    assert res.iterations.shape == (5,)
