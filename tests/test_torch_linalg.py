"""nlsolver_torch.linalg against nlsolver_tpu.linalg on the same inputs
(f64 on the CPU): Givens coefficients, the Sameh-Kuck schedule and
wavefront QR, the batch-minor back-substitution and least squares, the
``qr`` dispatcher, and the dense solves."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolver_torch import linalg as tl
from nlsolver_torch.linalg import solve as tsolve
from nlsolver_tpu import linalg as jl
from nlsolver_tpu.linalg import solve as jsolve

# the submodules, which the packages' ``qr_parallel`` functions shadow
tqp = importlib.import_module("nlsolver_torch.linalg.qr_parallel")
jqp = importlib.import_module("nlsolver_tpu.linalg.qr_parallel")

torch.set_num_threads(1)
RTOL = 1e-12


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_givens_rotation_on_a_grid():
    vals = np.array([-3.0, -1.0, -0.25, 0.0, 0.5, 1.0, 2.0, 1e-300, -7e5])
    a, b = (g.ravel() for g in np.meshgrid(vals, vals))   # a=0, b=0, both, |a|<|b|, signs
    tc, ts = tl.givens_rotation(torch.from_numpy(a), torch.from_numpy(b))
    jc, js = jl.givens_rotation(jnp.asarray(a), jnp.asarray(b))
    # PyTorch's vectorized CPU sqrt is not correctly rounded (sqrt(2) comes
    # out 1 ulp low), so c and s agree with XLA's to an ulp, not bit for bit
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=4e-16, atol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=4e-16, atol=0)
    exact = np.abs(a) != np.abs(b)     # the ulp falls on sqrt(2); elsewhere on this grid c is equal
    np.testing.assert_array_equal(tc.numpy()[exact], np.asarray(jc)[exact])
    both = (a == 0) & (b == 0)
    assert (tc.numpy()[both] == 1).all() and (ts.numpy()[both] == 0).all()
    # the rotation zeroes b against a
    np.testing.assert_allclose((-ts * torch.from_numpy(a) + tc * torch.from_numpy(b)).numpy(),
                               0.0, atol=1e-9)


@pytest.mark.parametrize("m,n", [(16, 16), (16, 8), (32, 8), (34, 2), (5, 5)])
def test_sameh_kuck_schedule_equals_jax(m, n):
    got, want = tqp.sameh_kuck_schedule(m, n), jqp.sameh_kuck_schedule(m, n)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for ga, wa in zip(g, w):
            np.testing.assert_array_equal(ga, wa)


def _fleet(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


# the annihilated entries of R hold rounding residue (~1e-16 |A|), which no
# relative tolerance can compare; they are held to an absolute 1e-13
@pytest.mark.parametrize("shape", [(8, 5, 7), (6, 6), (7, 3, 2, 3)])
def test_qr_parallel_matches_jax(shape):
    A = _fleet(0, shape)
    got = tqp.qr_parallel(torch.from_numpy(A))
    want = jqp.qr_parallel(jnp.asarray(A))
    close(got.R, want.R, atol=1e-13)
    close(got.Q, want.Q, atol=1e-13)
    assert tqp.qr_parallel(torch.from_numpy(A), compute_q=False).Q is None
    with pytest.raises(ValueError, match="m >= n"):
        tqp.qr_parallel(torch.zeros(3, 4, 2, dtype=torch.float64))


@pytest.mark.parametrize("shape", [(9, 4, 11), (34, 2, 5), (5, 5)])
def test_least_squares_parallel_matches_jax(shape):
    A, y = _fleet(1, shape), _fleet(2, (shape[0],) + shape[2:])
    got = tqp.least_squares_parallel(torch.from_numpy(A), torch.from_numpy(y))
    want = jqp.least_squares_parallel(jnp.asarray(A), jnp.asarray(y))
    close(got, want)


def test_backsolve_bm_matches_jax():
    R = np.triu(_fleet(3, (5, 5, 6)).transpose(2, 0, 1)).transpose(1, 2, 0) + 3 * np.eye(5)[..., None]
    b = _fleet(4, (5, 6))
    close(tqp.backsolve_bm(torch.from_numpy(R), torch.from_numpy(b)),
          jqp.backsolve_bm(jnp.asarray(R), jnp.asarray(b)))


def test_qr_dispatcher_methods():
    A = _fleet(5, (6, 6))
    tA = torch.from_numpy(A)
    for method in ("householder", "givens", "parallel"):
        got = tl.qr(tA, method=method)
        assert float(tl.validate_qr(got, tA)) < 1e-12, method
        close(got.Q.T @ got.Q, np.eye(6), atol=1e-12)
    close(tl.qr(tA, method="givens").R, jl.qr(jnp.asarray(A), method="givens").R, atol=1e-13)
    close(tl.qr(tA, method="givens").Q, jl.qr(jnp.asarray(A), method="givens").Q, atol=1e-13)
    # householder: LAPACK in both packages, equal up to the signs of R's rows
    hR, jR = tl.qr(tA).R.numpy(), np.asarray(jl.qr(jnp.asarray(A)).R)
    close(np.abs(hR), np.abs(jR), rtol=1e-10, atol=1e-12)
    # pallas: batch-minor only; on the CPU the wavefront twin, bit for bit
    F = torch.from_numpy(_fleet(6, (8, 4, 5)))
    got, par = tl.qr(F, method="pallas", tile=256, interpret=True), tl.qr(F, method="parallel")
    assert torch.equal(got.R, par.R) and torch.equal(got.Q, par.Q)
    close(got.R, jl.qr(jnp.asarray(F.numpy()), method="parallel").R, atol=1e-13)


def test_qr_dispatcher_errors():
    A = torch.eye(4, dtype=torch.float64)
    with pytest.raises(TypeError, match="takes no extra kwargs"):
        tl.qr(A, method="givens", tile=128)
    with pytest.raises(TypeError, match="takes no extra kwargs"):
        tl.qr(A, interpret=True)
    with pytest.raises(ValueError, match="unknown qr method"):
        tl.qr(A, method="nope")
    with pytest.raises(ValueError, match="batch-minor"):
        tl.qr(A, method="pallas")


def _spd(seed, n):
    M = _fleet(seed, (n, n))
    return M @ M.T + n * np.eye(n)


@pytest.mark.parametrize("diagonal", [True, False, None])
@pytest.mark.parametrize("n", [3, 10])
def test_damped_solve_matches_jax(diagonal, n):
    g = _fleet(7, (n,))
    for H in (_spd(8, n), np.diag(np.arange(1.0, n + 1))):
        got = tsolve.damped_solve(torch.from_numpy(H), torch.from_numpy(g), 0.5, diagonal=diagonal)
        want = jsolve.damped_solve(jnp.asarray(H), jnp.asarray(g), 0.5, diagonal=diagonal)
        close(got, want, rtol=1e-11)


def test_is_diagonal_matches_jax():
    for H in (np.eye(3), np.eye(3) + 1e-5, np.eye(3) - 1e-3, _spd(9, 4)):
        assert bool(tsolve.is_diagonal(torch.from_numpy(H))) == bool(jsolve.is_diagonal(jnp.asarray(H)))


def test_dense_solves_match_jax():
    A, b = _spd(10, 5), _fleet(11, (5,))
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    L = tsolve.cholesky(tA)
    close(L, jsolve.cholesky(jnp.asarray(A)))
    close(tsolve.forwardsolve(L, tb), jsolve.forwardsolve(jnp.asarray(L.numpy()), jnp.asarray(b)),
          rtol=1e-11)
    close(tsolve.backsolve(L.T, tb), jsolve.backsolve(jnp.asarray(L.numpy().T), jnp.asarray(b)),
          rtol=1e-11)
    close(tsolve.solve_cholesky(tA, tb), jsolve.solve_cholesky(jnp.asarray(A), jnp.asarray(b)),
          rtol=1e-11)
    assert torch.isnan(tsolve.cholesky(-tA)).all()      # not SPD: NaN, as in JAX
    Aq, y = _fleet(12, (9, 4)), _fleet(13, (9,))
    close(tsolve.least_squares(torch.from_numpy(Aq), torch.from_numpy(y)),
          jsolve.least_squares(jnp.asarray(Aq), jnp.asarray(y)), rtol=1e-10)
