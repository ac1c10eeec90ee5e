"""nlsolver_torch's Brent minimizer and cyclic coordinate descent on lane
tensors against ``jax.vmap`` of the JAX solvers, in float64 on the CPU, and
against the JAX ``minimize`` on one point.

Brent runs on 32 one-dimensional quartics s (t - c)^2 + (t - c)^4 / 4,
their minima inside the bracket [-5, 5], on its edge and outside it: the
port's lanes equal JAX's bit for bit in x and the counters, and f within an
ulp (XLA contracts the quartic's ``a * b + c`` into fused multiply-adds).  Coordinate descent runs on the lanes
of tests/torch_lanes_common.py.  There every lane's iterations, converged
flag and x agree, but the function calls of some lanes do not: each sweep
runs a Brent search per coordinate whose stopping tests compare values of
f, and XLA's CPU compiler contracts the objective's ``a * b + c`` into fused
multiply-adds in the jitted JAX program, which moves those values by an ulp.
``test_coordinate_differing_lanes_are_rounding`` runs one sweep of the JAX
solver op by op (``jax.disable_jit``: nothing fused) and finds the port's
counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lanes_common import (B, COUNTERS, N, counters_differ, fields, j_objective, jax_batched,
                                lanes, t_objective, torch_data)

import nlsolver_torch as nt
from nlsolver_torch import interop
from nlsolver_torch.solvers import brent as tbr
from nlsolver_torch.solvers import coordinate as tcd
from nlsolver_tpu.core import Bounds as JBounds
from nlsolver_tpu.solvers import brent as jbr
from nlsolver_tpu.solvers import coordinate as jcd

torch.set_num_threads(1)

# function calls of coordinate descent's lanes that differ, as read on the
# CPU (jax 0.9.0, torch 2.13.0+cpu): five of the eight lanes, at one sweep
# and at the default 100; iterations, converged and x agree on every lane
CD_CALLS_DIFFER = 5
CD_XTOL = 1e-7


def quartics():
    rng = np.random.default_rng(2)
    s = rng.uniform(0.5, 3.0, 32)
    c = np.concatenate([rng.uniform(-4.0, 4.0, 28), [6.0, -7.0, 4.99, 0.0]])
    return s, c


def brent_fields(res):
    return {f: np.asarray(getattr(res, f)) for f in ("x", "f_value", "iterations",
                                                     "function_calls", "converged")}


@pytest.mark.parametrize("minimize", [True, False])
def test_brent_matches_jax_vmap(minimize):
    s, c = quartics()
    sign = 1.0 if minimize else -1.0

    def jf(s, c):
        return lambda t: sign * (s * (t - c) ** 2 + 0.25 * (t - c) ** 4)

    jrun = jbr.minimize if minimize else jbr.maximize
    want = brent_fields(jax.jit(jax.vmap(lambda s, c: jrun(jf(s, c))))(s, c))
    S, C = torch.from_numpy(s), torch.from_numpy(c)
    trun = tbr.minimize if minimize else tbr.maximize
    got = brent_fields(trun(lambda t: sign * (S * (t - C) ** 2 + 0.25 * (t - C) ** 4),
                            torch.zeros(32, 1, dtype=torch.float64)))
    for f, w in want.items():
        assert got[f].dtype == w.dtype, f
        if f == "f_value":
            np.testing.assert_allclose(got[f], w, rtol=1e-15, atol=0)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
    # minima beyond the bracket stop on its edge
    np.testing.assert_allclose(got["x"][28:30], [5.0, -5.0], atol=1e-6)


def test_brent_bounds_are_python_floats_as_in_jax():
    """``bounds`` sets the bracket (floats, the reference's call shape);
    ``x0`` gives only the lanes, the dtype and the device."""
    want = brent_fields(jax.jit(lambda: jbr.minimize(lambda t: (t - 7.5) ** 2, None,
                                                     bounds=JBounds(6.0, 9.0)))())
    got = brent_fields(tbr.minimize(lambda t: (t - 7.5) ** 2, torch.zeros(1, dtype=torch.float64),
                                    bounds=nt.Bounds(6.0, 9.0)))
    for f, w in want.items():
        assert got[f].shape == () and got[f].dtype == w.dtype, f
        np.testing.assert_array_equal(got[f], w, err_msg=f)


def test_brent_refuses_a_function_that_is_not_elementwise():
    with pytest.raises(ValueError, match="elementwise"):
        tbr.minimize_scalar(lambda t: t.sum(), like=torch.zeros(4, dtype=torch.float64))


@pytest.mark.parametrize("max_iter", [1, 100])
def test_coordinate_matches_jax_vmap(max_iter):
    x0, k, c, w = lanes()
    want = fields(jax_batched(jcd.minimize, jcd.CoordinateDescentConfig(max_iter=max_iter))(
        x0, k, c, w))
    got = fields(tcd.minimize_batched(t_objective, torch.from_numpy(x0),
                                      tcd.CoordinateDescentConfig(max_iter=max_iter),
                                      data=torch_data(k, c, w)))
    for f in got:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape, f
    for f in ("iterations", "gradient_calls", "hessian_calls", "converged"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert (got["function_calls"] != want["function_calls"]).sum() <= CD_CALLS_DIFFER
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=CD_XTOL)
    np.testing.assert_allclose(got["f_value"], want["f_value"], rtol=CD_XTOL, atol=1e-12)


def test_coordinate_differing_lanes_are_rounding():
    """One sweep: on the Rosenbrock lane 3, whose function calls differ
    from the jitted JAX program's, the JAX solver run op by op gives the
    port's counters."""
    x0, k, c, w = lanes()
    cfg = jcd.CoordinateDescentConfig(max_iter=1)
    want = fields(jax_batched(jcd.minimize, cfg)(x0, k, c, w))
    got = fields(tcd.minimize_batched(t_objective, torch.from_numpy(x0),
                                      tcd.CoordinateDescentConfig(max_iter=1),
                                      data=torch_data(k, c, w)))
    lane = 3
    assert counters_differ(got, want)[lane]
    with jax.disable_jit():
        one = fields(jcd.minimize(lambda p: j_objective(p, k[lane], c[lane], w[lane]),
                                  jnp.asarray(x0[lane]), cfg))
    for f in COUNTERS:
        assert one[f] == got[f][lane], (f, one[f], got[f][lane])


def test_coordinate_single_point_matches_jax():
    """``minimize(fn, x0[n])`` on the bowl lane 1 (whose calls agree),
    and ``maximize`` of -f the same."""
    x0, k, c, w = lanes()
    lane = 1
    cfg = jcd.CoordinateDescentConfig()
    want = fields(jax.jit(lambda x: jcd.minimize(
        lambda p: j_objective(p, k[lane], c[lane], w[lane]), x, cfg))(x0[lane]))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in (k[lane], c[lane], w[lane]))
    got = fields(tcd.minimize(t_objective, torch.from_numpy(x0[lane]),
                              tcd.CoordinateDescentConfig(), data=data))
    up = fields(tcd.maximize(lambda x, d: -t_objective(x, d), torch.from_numpy(x0[lane]),
                             tcd.CoordinateDescentConfig(), data=data))
    for res in (got, up):
        assert res["x"].shape == (N,)
        for f in COUNTERS:
            assert res[f] == want[f], f
        np.testing.assert_allclose(res["x"], want["x"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(up["f_value"], -want["f_value"], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("cls", ["BrentConfig", "CoordinateDescentConfig"])
def test_config_fields_match_jax(cls):
    jm, tm = (jbr, tbr) if cls == "BrentConfig" else (jcd, tcd)
    assert [(f.name, f.default) for f in dataclasses.fields(getattr(jm, cls))] == \
        [(f.name, f.default) for f in dataclasses.fields(getattr(tm, cls))]


def test_cd_state_crosses_packages():
    """A JAX coordinate-descent state after one vmapped sweep, carried into
    the port by ``interop``, swept once by each package: the same state
    (the x of a sweep within CD_XTOL, its calls on the lanes read)."""
    x0, k, c, w = lanes()
    cfg = jcd.CoordinateDescentConfig()

    def two(x, kk, cc, ww):
        f = lambda p: j_objective(p, kk, cc, ww)  # noqa: E731
        s = jcd.step(f, jcd.init(f, x, cfg), cfg)
        return s, jcd.step(f, s, cfg)

    s1, s2 = jax.jit(jax.vmap(two))(x0, k, c, w)
    carried = {f: np.asarray(v) for f, v in s1._asdict().items()}
    ts = interop.cd_state_from_numpy(carried, "cpu")
    back = interop.cd_state_to_numpy(tcd.step(t_objective, ts, tcd.CoordinateDescentConfig(),
                                               data=torch_data(k, c, w)))
    assert set(back) == set(carried)
    for f, v in back.items():
        want = np.asarray(getattr(s2, f))
        assert v.dtype == want.dtype, f
        if f == "nfev":
            assert (v != want).sum() <= CD_CALLS_DIFFER
        else:
            np.testing.assert_allclose(v, want, rtol=CD_XTOL, atol=CD_XTOL, err_msg=f)


def test_coordinate_refuses_bounds():
    with pytest.raises(ValueError, match="takes no bounds"):
        tcd.minimize_batched(t_objective, torch.zeros(B, N, dtype=torch.float64),
                             bounds=nt.Bounds(-1.0, 1.0))
