"""nlsolver_torch.deriv against nlsolver_tpu.deriv on the CPU: the FD
stencils, their costs, the derivative providers and the config fields.

The stencils of both packages build the same points and sum in the same
order, so with nothing fused they agree bit for bit: the JAX reference runs
op by op (``jax.disable_jit``; jitted, XLA contracts the weighted sums into
fused multiply-adds, and one ulp of f grows by 1 / (dd eps) in a
difference quotient).  Jitted, the JAX gradient agrees to 1e-8 of its
largest entry in float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from nlsolver_torch import deriv as td
from nlsolver_torch.deriv import fd as tf
from nlsolver_tpu import deriv as jd
from nlsolver_tpu.deriv import fd as jf

torch.set_num_threads(1)


def j_rosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def t_rosen(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()


def points(dtype, count=5, n=4, seed=1):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (count, n)).astype(dtype)


@pytest.mark.parametrize("cls", ["FDConfig", "Deriv"])
def test_config_fields_match_jax(cls):
    jc, tc = getattr(jd, cls), getattr(td, cls)
    assert [(f.name, f.default) for f in dataclasses.fields(jc)] == \
        [(f.name, f.default) for f in dataclasses.fields(tc)]


@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("accuracy", [0, 1, 2, 3])
def test_costs_match_jax(n, accuracy):
    assert tf.fd_gradient_cost(n, accuracy) == jf.fd_gradient_cost(n, accuracy)
    assert tf.fd_hessian_cost(n, accuracy) == jf.fd_hessian_cost(n, accuracy)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("accuracy", [0, 1, 2, 3])
def test_fd_gradient_bit_equal_op_by_op(accuracy, dtype):
    X = points(dtype)
    with jax.disable_jit():
        want = np.stack([np.asarray(jf.fd_gradient(j_rosen, jnp.asarray(x), accuracy)) for x in X])
    got = vmap(lambda x: tf.fd_gradient(t_rosen, x, accuracy))(torch.from_numpy(X)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("accuracy", [0, 1])
def test_fd_hessian_bit_equal_op_by_op(accuracy, dtype):
    X = points(dtype, count=3)
    with jax.disable_jit():
        want = np.stack([np.asarray(jf.fd_hessian(j_rosen, jnp.asarray(x), accuracy)) for x in X])
    got = vmap(lambda x: tf.fd_hessian(t_rosen, x, accuracy))(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fd_on_lanes_matches_jitted_jax():
    """The solvers' use: vmapped over lanes, against the jitted vmapped JAX
    stencil (fused there), within 1e-8 of the largest entry in float64."""
    X = points("float64", count=16)
    for accuracy in range(4):
        want = np.asarray(jax.jit(jax.vmap(lambda x: jf.fd_gradient(j_rosen, x, accuracy)))(X))
        got = vmap(lambda x: tf.fd_gradient(t_rosen, x, accuracy))(torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())
    want = np.asarray(jax.jit(jax.vmap(lambda x: jf.fd_hessian(j_rosen, x, 1)))(X))
    got = vmap(lambda x: tf.fd_hessian(t_rosen, x, 1))(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["autodiff", "fd"])
def test_make_grad_and_hessian_match_jax(mode):
    """Values within rounding of JAX's providers, and the same
    ``f_evals_per_call``; a custom callable costs nothing."""
    X = points("float64", count=3)
    jg, jgc = jd.make_grad(j_rosen, 4, jd.Deriv(mode=mode))
    tg, tgc = td.make_grad(t_rosen, 4, td.Deriv(mode=mode))
    jh, jhc = jd.make_hessian(j_rosen, 4, jd.Deriv(mode=mode))
    th, thc = td.make_hessian(t_rosen, 4, td.Deriv(mode=mode))
    assert (tgc, thc) == (jgc, jhc)
    for x in X:
        wg, wh = np.asarray(jg(jnp.asarray(x))), np.asarray(jh(jnp.asarray(x)))
        t = torch.from_numpy(x)
        np.testing.assert_allclose(tg(t).numpy(), wg, rtol=0, atol=1e-8 * np.abs(wg).max())
        np.testing.assert_allclose(th(t).numpy(), wh, rtol=0, atol=1e-8 * np.abs(wh).max())
    custom = lambda x: x  # noqa: E731
    assert td.make_grad(t_rosen, 4, custom=custom) == (custom, 0)
    assert td.make_hessian(t_rosen, 4, custom=custom) == (custom, 0)
