"""Kernels K4a, K4b and K4c of nlsolver_torch (``ops.rank2``): the three
plain twins against the JAX package's jnp formulations (f64, rtol 1e-12)
and against its Pallas kernels in interpret mode (f32), the CPU routes,
the shapes refused, the shared-memory envelopes, and the CUDA kernels
against their twins (on a card only).

JAX is imported only inside the tests that compare with it, so that the
card's tests run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_rank2.py
"""
import numpy as np
import pytest
import torch

from nlsolver_torch.ops import rank2 as tr

torch.set_num_threads(1)


def _batchminor_case(seed, n, B, dtype=np.float64):
    """SPD H [n, n, B], s, y, g [n, B], rho [B] with every fifth lane 0,
    reset [B] on every third lane."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    H = M @ M.transpose(0, 2, 1) + 2.0 * np.eye(n)
    s, y, g = (rng.standard_normal((n, B)).astype(dtype) for _ in range(3))
    rho = rng.uniform(0.1, 2.0, B).astype(dtype)
    rho[::5] = 0.0
    reset = np.arange(B) % 3 == 0
    return np.ascontiguousarray(H.transpose(1, 2, 0), dtype=dtype), s, y, g, rho, reset


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _close(got, want, rtol, atol_rel=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()))


@pytest.mark.parametrize("n,B", [(1, 7), (2, 33), (8, 200), (16, 50)])
def test_batchminor_twin_matches_jax_f64(n, B):
    import jax
    from nlsolver_tpu.ops.rank2 import rank2_direction_batchminor_jnp

    case = _batchminor_case(n, n, B)
    Hn, d = tr.rank2_direction_batchminor(*_t(*case))
    jH, jd = jax.jit(rank2_direction_batchminor_jnp)(*case)
    _close(Hn, jH, rtol=1e-12, atol_rel=1e-15)
    _close(d, jd, rtol=1e-12, atol_rel=1e-15)
    # a reset lane updates the identity; a rho = 0 lane keeps Heff
    H = case[0]
    eye = np.broadcast_to(np.eye(n)[:, :, None], H.shape)
    Hid, _ = tr.rank2_direction_batchminor_reference(
        *_t(eye, *case[1:5], np.zeros(B, dtype=bool)))
    assert torch.equal(Hn[:, :, ::3], Hid[:, :, ::3])
    keep = (case[4] == 0.0) & ~case[5]
    assert keep.any() and np.array_equal(Hn.numpy()[:, :, keep], H[:, :, keep])


def test_batched_and_single_twins_match_jax_f64():
    import jax
    from nlsolver_tpu.ops.rank2 import rank2_update_batched_jnp, rank2_update_reference

    H, s, y, _, rho, _ = _batchminor_case(3, 8, 37)
    Hb, sb, yb = H.transpose(2, 0, 1), s.T, y.T
    got = tr.rank2_update_batched(*_t(Hb, sb, yb, rho))
    _close(got, jax.jit(rank2_update_batched_jnp)(Hb, sb, yb, rho), rtol=1e-12, atol_rel=1e-15)
    one = tr.rank2_update_reference(*_t(Hb[1], sb[1], yb[1]), float(rho[1]))
    _close(one, rank2_update_reference(Hb[1], sb[1], yb[1], rho[1]), rtol=1e-12, atol_rel=1e-15)
    _close(one, got[1].numpy(), rtol=1e-12, atol_rel=1e-15)
    # the two layouts hold the same update
    Hn, _ = tr.rank2_direction_batchminor_reference(
        *_t(H, s, y, s, rho, np.zeros(37, dtype=bool)))
    _close(Hn.permute(2, 0, 1), got.numpy(), rtol=1e-12, atol_rel=1e-15)


def test_batchminor_twin_matches_pallas_interpret_f32():
    """K4a's TPU counterpart as the JAX tests run it: interpret mode,
    tile=128, B no multiple of it.  f32 sums in another order: rtol 1e-6
    beside 1e-5 of the largest entry."""
    from nlsolver_tpu.ops.rank2 import rank2_direction_batchminor_pallas

    case = _batchminor_case(4, 8, 200, np.float32)
    Hn, d = tr.rank2_direction_batchminor(*_t(*case))
    jH, jd = rank2_direction_batchminor_pallas(*case, tile=128, interpret=True)
    _close(Hn, jH, rtol=1e-6, atol_rel=1e-5)
    _close(d, jd, rtol=1e-6, atol_rel=1e-5)


@pytest.mark.parametrize("n,B", [(16, 64), (8, 100)])
def test_batchminor_twin_matches_pallas_rowtiled_interpret_f32(n, B):
    """K4b's TPU counterpart: interpret mode, tile=32, tile_r=8."""
    from nlsolver_tpu.ops.rank2 import rank2_direction_batchminor_pallas_rowtiled

    case = _batchminor_case(5, n, B, np.float32)
    Hn, d = tr.rank2_direction_batchminor(*_t(*case))
    jH, jd = rank2_direction_batchminor_pallas_rowtiled(*case, tile=32, tile_r=8, interpret=True)
    _close(Hn, jH, rtol=1e-6, atol_rel=1e-5)
    _close(d, jd, rtol=1e-6, atol_rel=1e-5)


def test_batched_twin_matches_pallas_interpret_f32():
    """K4c's TPU counterpart: interpret mode, tile=32."""
    from nlsolver_tpu.ops.rank2 import rank2_update_batched_pallas

    H, s, y, _, rho, _ = _batchminor_case(6, 8, 64, np.float32)
    Hb, sb, yb = (np.ascontiguousarray(a) for a in (H.transpose(2, 0, 1), s.T, y.T))
    got = tr.rank2_update_batched(*_t(Hb, sb, yb, rho))
    _close(got, rank2_update_batched_pallas(Hb, sb, yb, rho, tile=32, interpret=True),
           rtol=1e-6, atol_rel=1e-5)


def test_cpu_routes_are_the_twins_and_errors():
    case = _t(*_batchminor_case(7, 3, 5))
    H, s, y, g, rho, reset = case
    counters = (tr.rank2_direction_batchminor_resident, tr.rank2_direction_batchminor_rowsplit,
                tr.rank2_update_batched_kernel)
    before = [f.launches for f in counters]
    Hn, d = tr.rank2_direction_batchminor(*case)
    tH, td = tr.rank2_direction_batchminor_reference(*case)
    assert torch.equal(Hn, tH) and torch.equal(d, td)
    Hb = H.permute(2, 0, 1).contiguous()
    assert torch.equal(tr.rank2_update_batched(Hb, s.T, y.T, rho),
                       tr.rank2_update_batched_reference(Hb, s.T, y.T, rho))
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match=r"H must be \[n, n, B\]"):
        tr.rank2_direction_batchminor(H[:2], s, y, g, rho, reset)
    with pytest.raises(ValueError, match=r"y must be \[n, B\]"):
        tr.rank2_direction_batchminor(H, s, y[:, :4], g, rho, reset)
    with pytest.raises(ValueError, match=r"rho must be \[B\]"):
        tr.rank2_direction_batchminor(H, s, y, g, rho[:4], reset)
    with pytest.raises(ValueError, match="reset must be bool"):
        tr.rank2_direction_batchminor(H, s, y, g, rho, reset.to(torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tr.rank2_direction_batchminor(H.to("meta"), s, y, g, rho, reset)
    with pytest.raises(ValueError, match=r"H must be \[B, n, n\]"):
        tr.rank2_update_batched(H[:2], s.T, y.T, rho)
    with pytest.raises(ValueError, match="unsupported device"):
        tr.rank2_update_batched(Hb.to("meta"), s.T, y.T, rho)


def test_shared_memory_envelopes():
    """The n each kernel's slab fits, worked out from 232448 bytes."""
    assert tr.resident_fits(40, torch.float32) and not tr.resident_fits(41, torch.float32)
    assert tr.resident_fits(28, torch.float64) and not tr.resident_fits(29, torch.float64)
    assert tr.batched_fits(239, torch.float32) and not tr.batched_fits(240, torch.float32)
    assert tr.batched_fits(168, torch.float64) and not tr.batched_fits(169, torch.float64)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_rank2.py)")
    return torch.device("cuda")


def _assert_within(got, twin, n, what):
    """Kernel against twin: a few ulp times n of the largest entry (the
    sums run in another order); bit for bit where n <= 2."""
    if n <= 2:
        assert torch.equal(got, twin), what
        return
    tol = tr.KERNEL_TOL_ULPS * n * torch.finfo(twin.dtype).eps * float(twin.abs().max())
    assert float((got - twin).abs().max()) <= tol, what


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 8, 16, 28])
def test_resident_kernel_matches_twin_on_card(n, dtype):
    dev = _on_card()
    case = tuple(t.to(dev) if t.dtype == torch.bool else t.to(dev, dtype)
                 for t in _t(*_batchminor_case(n, n, 1000)))
    before = tr.rank2_direction_batchminor_resident.launches
    Hn, d = tr.rank2_direction_batchminor(*case)
    torch.cuda.synchronize()
    assert tr.rank2_direction_batchminor_resident.launches == before + 1
    tH, td = tr.rank2_direction_batchminor_reference(*case)
    _assert_within(Hn, tH, n, "H'")
    _assert_within(d, td, n, "d'")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 16, 45, 64])
def test_rowsplit_kernel_matches_twin_on_card(n, dtype):
    dev = _on_card()
    case = tuple(t.to(dev) if t.dtype == torch.bool else t.to(dev, dtype)
                 for t in _t(*_batchminor_case(n, n, 333)))
    before = tr.rank2_direction_batchminor_rowsplit.launches
    Hn, d = tr.rank2_direction_batchminor_rowsplit(*case)
    torch.cuda.synchronize()
    assert tr.rank2_direction_batchminor_rowsplit.launches == before + 1
    tH, td = tr.rank2_direction_batchminor_reference(*case)
    _assert_within(Hn, tH, n, "H'")
    _assert_within(d, td, n, "d'")
    if n == 45:  # beyond the resident slab: the dispatcher takes K4b
        tr.rank2_direction_batchminor(*case)
        assert tr.rank2_direction_batchminor_rowsplit.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 16, 33, 64])
def test_batched_kernel_matches_twin_on_card(n, dtype):
    dev = _on_card()
    H, s, y, _, rho, _ = _batchminor_case(n, n, 777)
    args = tuple(t.to(dev, dtype) for t in _t(H.transpose(2, 0, 1), s.T, y.T, rho))
    before = tr.rank2_update_batched_kernel.launches
    Hn = tr.rank2_update_batched(*args)
    torch.cuda.synchronize()
    assert tr.rank2_update_batched_kernel.launches == before + 1
    _assert_within(Hn, tr.rank2_update_batched_reference(*args), n, "H'")


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take_on_card():
    dev = _on_card()
    H, s, y, g, rho, reset = (t.to(dev) if t.dtype == torch.bool else t.to(dev, torch.float32)
                              for t in _t(*_batchminor_case(8, 4, 64)))
    with pytest.raises(ValueError, match="float32 or float64"):
        tr.rank2_direction_batchminor(H.half(), s.half(), y.half(), g.half(), rho.half(), reset)
    with pytest.raises(ValueError, match="contiguous"):
        tr.rank2_direction_batchminor(H.transpose(0, 1), s, y, g, rho, reset)
    with pytest.raises(ValueError, match="is on cpu"):
        tr.rank2_direction_batchminor(H, s, y.cpu(), g, rho, reset)
    with pytest.raises(ValueError, match="does not fit"):
        big = torch.zeros(41, 41, 8, device=dev)
        v = torch.zeros(41, 8, device=dev)
        tr.rank2_direction_batchminor_resident(big, v, v, v, torch.zeros(8, device=dev),
                                               torch.zeros(8, dtype=torch.bool, device=dev))
