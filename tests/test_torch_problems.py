"""All test functions of nlsolver_torch against nlsolver_tpu.problems,
on the same points (f64): values, batching and minima oracles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolver_torch.problems import PROBLEMS as TP
from nlsolver_torch.problems import REFERENCE_SUITE as T_SUITE
from nlsolver_tpu.problems import PROBLEMS as JP
from nlsolver_tpu.problems import REFERENCE_SUITE as J_SUITE

torch.set_num_threads(1)
RTOL = ATOL = 1e-12


def test_same_registry():
    assert list(TP) == list(JP)
    assert T_SUITE == J_SUITE
    for name, p in TP.items():
        q = JP[name]
        assert (p.dim, p.minima, p.fmin, p.lower, p.upper) == (
            q.dim, q.minima, q.fmin, q.lower, q.upper
        )


@pytest.mark.parametrize("name", sorted(JP))
def test_values_match_jax(name):
    p = JP[name]
    rng = np.random.default_rng(sorted(JP).index(name))
    lo, hi = np.asarray(p.lower), np.asarray(p.upper)
    X = lo + (hi - lo) * rng.random((16, p.dim))
    X = np.concatenate([X, np.asarray(p.minima, np.float64)])
    want = np.asarray(jax.vmap(p.fn)(jnp.asarray(X)))
    got = TP[name].fn(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # a batch with two leading axes reduces over the last one only
    got2 = TP[name].fn(torch.from_numpy(X[:16].reshape(4, 4, p.dim))).numpy()
    np.testing.assert_allclose(got2.reshape(-1), want[:16], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["rastrigin", "sphere", "ackley", "rosenbrock", "styblinski_tang"])
def test_nd_forms_match_jax(name):
    X = np.random.default_rng(11).uniform(-2, 2, (8, 10))
    want = np.asarray(jax.vmap(JP[name].fn)(jnp.asarray(X)))
    got = TP[name].fn(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_distance_to_nearest_minimum():
    p, q = TP["himmelblau"], JP["himmelblau"]
    X = np.random.default_rng(12).uniform(-5, 5, (10, 2))
    want = np.asarray(jax.vmap(q.distance_to_nearest_minimum)(jnp.asarray(X)))
    got = p.distance_to_nearest_minimum(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
