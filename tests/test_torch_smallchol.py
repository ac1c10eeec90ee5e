"""Kernel K3 of nlsolver_torch (``ops.smallchol``): the batch-minor
Cholesky twin against the JAX package's ``solve_spd_batchminor`` and its
Pallas kernel in interpret mode, the standard-layout solves, the shapes
refused, and the CUDA kernel against its twin (on a card only).

JAX is imported only inside the tests that compare with it, so that the
card's tests run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_smallchol.py
"""
import numpy as np
import pytest
import torch

from nlsolver_torch.ops import smallchol as tsc

torch.set_num_threads(1)


def _spd_batchminor(seed, n, B, dtype=np.float64):
    """A = M M^T + 2 I per lane, batch-minor [n, n, B], and b [n, B]."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    A = M @ M.transpose(0, 2, 1) + 2.0 * np.eye(n)
    return (np.ascontiguousarray(A.transpose(1, 2, 0), dtype=dtype),
            rng.standard_normal((n, B)).astype(dtype))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_twin_matches_jax_batchminor_f64(n):
    import jax
    from nlsolver_tpu.ops.smallchol import solve_spd_batchminor

    A, b = _spd_batchminor(n, n, 37)
    got = tsc.solve_spd_batchminor(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(solve_spd_batchminor)(A, b)),
                               rtol=1e-12)
    # the solution solves the systems
    np.testing.assert_allclose(np.einsum("ijb,jb->ib", A, got.numpy()), b, atol=1e-10)


def test_kernel_entry_matches_jax_pallas_interpret_f32():
    from nlsolver_tpu.ops.smallchol import solve_spd_batched_pallas

    A, b = _spd_batchminor(10, 4, 256, np.float32)
    A_std, b_std = np.ascontiguousarray(A.transpose(2, 0, 1)), np.ascontiguousarray(b.T)
    got = tsc.solve_spd_batched_kernel(torch.from_numpy(A_std), torch.from_numpy(b_std))
    want = solve_spd_batched_pallas(A_std, b_std, tile=128, interpret=True)
    assert got.shape == (256, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_standard_layout_solve_matches_jax():
    from nlsolver_tpu.ops.smallchol import solve_spd_batched

    A, b = _spd_batchminor(11, 5, 9)
    A_std, b_std = A.transpose(2, 0, 1), b.T
    got = tsc.solve_spd_batched(torch.from_numpy(A_std.copy()), torch.from_numpy(b_std.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(solve_spd_batched(A_std, b_std)),
                               rtol=1e-11)
    via_kernel_entry = tsc.solve_spd_batched_kernel(torch.from_numpy(A_std.copy()),
                                                    torch.from_numpy(b_std.copy()))
    np.testing.assert_allclose(via_kernel_entry.numpy(), got.numpy(), rtol=1e-11)


def test_cpu_route_is_the_twin_and_errors():
    A, b = (torch.from_numpy(a) for a in _spd_batchminor(12, 3, 5))
    before = tsc.solve_spd_batchminor.launches
    assert torch.equal(tsc.solve_spd_batchminor(A, b), tsc._chol_solve_batchminor(A, b))
    assert tsc.solve_spd_batchminor.launches == before
    with pytest.raises(ValueError, match=r"A must be \[n, n, B\]"):
        tsc.solve_spd_batchminor(A[:2], b)
    with pytest.raises(ValueError, match=r"b must be \[n, B\]"):
        tsc.solve_spd_batchminor(A, b[:, :4])
    with pytest.raises(ValueError, match="unsupported device"):
        tsc.solve_spd_batchminor(A.to("meta"), b)
    with pytest.raises(ValueError, match="need A"):
        tsc.solve_spd_batched_kernel(A, b.T[0])


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_smallchol.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 8, 16, 33])
def test_kernel_bit_equal_to_twin_on_card(n, dtype):
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(n, n, 1000))
    before = tsc.solve_spd_batchminor.launches
    x = tsc.solve_spd_batchminor(A, b)
    torch.cuda.synchronize()
    assert tsc.solve_spd_batchminor.launches == before + 1
    assert torch.equal(x, tsc._chol_solve_batchminor(A, b))


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take_on_card():
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, torch.float32) for a in _spd_batchminor(13, 4, 64))
    with pytest.raises(ValueError, match="float32 or float64"):
        tsc.solve_spd_batchminor(A.half(), b.half())
    with pytest.raises(ValueError, match="contiguous"):
        tsc.solve_spd_batchminor(A.transpose(0, 1), b)
    with pytest.raises(ValueError, match="is on cpu"):
        tsc.solve_spd_batchminor(A, b.cpu())
