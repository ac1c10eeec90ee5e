"""Kernels K2a and K2b of nlsolver_torch (``ops.qr_wavefront``): the CPU
route (the plain twins) against the JAX package's Pallas kernels in
interpret mode and its jnp wavefront, the shapes the kernel takes and
refuses, and the CUDA kernels against their twins (on a card only).

JAX is imported only inside the tests that compare with it, so that the
card's tests run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_qr_wavefront.py
"""
import numpy as np
import pytest
import torch

from nlsolver_torch.ops import qr_wavefront as tqw

torch.set_num_threads(1)


def _system(seed, m, n, B, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n, B)).astype(dtype), rng.standard_normal((m, B)).astype(dtype)


def test_cpu_route_matches_jax_pallas_interpret_f32():
    from nlsolver_tpu.ops.qr_wavefront import (least_squares_wavefront_pallas,
                                               qr_wavefront_pallas)

    A, y = _system(0, 16, 8, 128, np.float32)
    R, Q = tqw.qr_wavefront_kernel(torch.from_numpy(A), compute_q=True)
    jR, jQ = qr_wavefront_pallas(A, compute_q=True, interpret=True)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), atol=1e-5)
    x = tqw.least_squares_wavefront_kernel(torch.from_numpy(A), torch.from_numpy(y))
    jx = least_squares_wavefront_pallas(A, y, interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5)


# B=60 and B=300 are no multiple of the TPU kernel's 128-lane tile: the port
# takes them as they are, with no padding lanes
@pytest.mark.parametrize("m,n,B", [(34, 2, 64), (16, 16, 64), (12, 5, 60), (10, 3, 300)])
def test_cpu_route_matches_jax_wavefront_f64(m, n, B):
    import jax
    from nlsolver_tpu.linalg.qr_parallel import least_squares_parallel, qr_parallel

    A, y = _system(1, m, n, B)
    x = tqw.least_squares_wavefront_kernel(torch.from_numpy(A), torch.from_numpy(y))
    want_x = jax.jit(least_squares_parallel)(A, y)
    np.testing.assert_allclose(x.numpy(), np.asarray(want_x), rtol=1e-12)
    assert x.shape == (n, B)
    R, Q = tqw.qr_wavefront_kernel(torch.from_numpy(A), compute_q=True)
    want = jax.jit(qr_parallel)(A)
    # the annihilated entries hold rounding residue: absolute slack for them
    np.testing.assert_allclose(R.numpy(), np.asarray(want.R), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(Q.numpy(), np.asarray(want.Q), rtol=1e-12, atol=1e-13)
    R_only, none = tqw.qr_wavefront_kernel(torch.from_numpy(A))
    assert none is None and torch.equal(R_only, R)


def test_cpu_route_is_the_twin_and_no_launch():
    A, y = (torch.from_numpy(a) for a in _system(2, 9, 4, 7))
    before = (tqw.qr_wavefront_kernel.launches, tqw.least_squares_wavefront_kernel.launches)
    assert torch.equal(tqw.least_squares_wavefront_kernel(A, y),
                       tqw.least_squares_wavefront_reference(A, y))
    R, Q = tqw.qr_wavefront_kernel(A, compute_q=True)
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q=True)
    assert torch.equal(R, tR) and torch.equal(Q, tQ)
    assert (tqw.qr_wavefront_kernel.launches, tqw.least_squares_wavefront_kernel.launches) == before


def test_shape_and_device_errors():
    A = torch.zeros(3, 4, 5)
    with pytest.raises(ValueError, match="need m >= n"):
        tqw.qr_wavefront_kernel(A)
    with pytest.raises(ValueError, match="need m >= n"):
        tqw.least_squares_wavefront_kernel(A, torch.zeros(3, 5))
    with pytest.raises(ValueError, match=r"rhs must be \[m, B\]"):
        tqw.least_squares_wavefront_kernel(torch.zeros(6, 2, 5), torch.zeros(6, 4))
    with pytest.raises(ValueError, match="batch-minor"):
        tqw.qr_wavefront_kernel(torch.zeros(6, 2))
    # a tensor on no CPU and no card is refused, never run on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        tqw.qr_wavefront_kernel(torch.zeros(6, 2, 5, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tqw.least_squares_wavefront_kernel(torch.zeros(6, 2, 5), torch.zeros(6, 5, device="meta"))


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_qr_wavefront.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,B", [(34, 2, 1000), (16, 16, 300), (32, 8, 257)])
def test_kernels_bit_equal_to_twins_on_card(dtype, m, n, B):
    dev = _on_card()
    A, y = (torch.from_numpy(a).to(dev, dtype) for a in _system(3, m, n, B))
    x = tqw.least_squares_wavefront_kernel(A, y)
    R, Q = tqw.qr_wavefront_kernel(A, compute_q=True)
    torch.cuda.synchronize()
    assert torch.equal(x, tqw.least_squares_wavefront_reference(A, y))
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q=True)
    assert torch.equal(R, tR) and torch.equal(Q, tQ)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take_on_card():
    dev = _on_card()
    A, y = torch.randn(10, 3, 64, device=dev), torch.randn(10, 64, device=dev)
    with pytest.raises(ValueError, match="float32 or float64"):
        tqw.least_squares_wavefront_kernel(A.half(), y.half())
    with pytest.raises(ValueError, match="contiguous"):
        tqw.qr_wavefront_kernel(torch.randn(10, 64, 3, device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="is on cpu"):
        tqw.least_squares_wavefront_kernel(A, y.cpu())
