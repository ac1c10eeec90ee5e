"""Kernels K4a, K4b-c, K4b and K4c of nlsolver_torch (``ops.rank2``): the
three plain twins against the JAX package's jnp formulations (f64, rtol
1e-12) and against its Pallas kernels in interpret mode (f32), a
plain-tensor emulation of K4b-c's order, the CPU routes, the shapes
refused, the shared-memory envelopes and the dispatcher's choice, and the
CUDA kernels against their twins (on a card only).

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
    counters = (tr.rank2_direction_batchminor_resident, tr.rank2_direction_batchminor_cluster,
                tr.rank2_direction_batchminor_rowsplit, tr.rank2_update_batched_kernel)
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


def ascending_reference(H, s, y, g, rho, reset):
    """K4b's three passes in plain torch ops, one lane per element of the
    batch: Hy over j, y^T Hy over i and d' over j each summed in ascending
    order, every operation rounded on its own."""
    n = H.shape[0]
    eye = torch.eye(n, dtype=H.dtype)[:, :, None]
    Heff = torch.where(reset[None, None, :], eye, H)
    Hy = []
    for i in range(n):
        acc = torch.zeros_like(rho)
        for j in range(n):
            acc = acc + Heff[i, j] * y[j]
        Hy.append(acc)
    yHy = torch.zeros_like(rho)
    for i in range(n):
        yHy = yHy + y[i] * Hy[i]
    coef = rho * (1.0 + rho * yHy)
    Hn, d = torch.empty_like(H), torch.empty_like(g)
    for i in range(n):
        acc = torch.zeros_like(rho)
        for j in range(n):
            sym = s[i] * Hy[j] + Hy[i] * s[j]
            Hn[i, j] = (Heff[i, j] - rho * sym) + coef * (s[i] * s[j])
            acc = acc + Hn[i, j] * g[j]
        d[i] = -acc
    return Hn, d


def cluster_emulation(H, s, y, g, rho, reset, size, group):
    """K4b-c in plain torch ops, in the kernel's order.  CTA k of a cluster
    of ``size`` stages rows k R .. k R + R - 1 (R = ceil(n / size)) of H in
    a slab that starts as NaN, lane group by lane group of ``group`` lanes
    (the kernel's 16-byte copies), skipping a group whose lanes all reset;
    it forms Hy for its rows into its own copy of Hy (NaN elsewhere), then
    gathers every other row of Hy from the CTA that owns it, sums y^T Hy
    over its whole copy in ascending i, and forms its rows of H' and d'.
    A reset lane's rows take the identity in the slab once fetched; the
    kernel's chunks of columns keep each sum's ascending order."""
    n, _, B = H.shape
    R = -(-n // size)
    fetched = (~reset).reshape(-1, group).any(dim=1).repeat_interleave(group) \
        if B % group == 0 else ~reset
    nan = float("nan")
    slabs, Hys = [], []
    for k in range(size):
        lo, rows = k * R, max(0, min(R, n - k * R))
        slab = torch.full((rows, n, B), nan, dtype=H.dtype)
        slab[:, :, fetched] = H[lo:lo + rows][:, :, fetched]
        slab[:, :, reset] = torch.eye(n, dtype=H.dtype)[lo:lo + rows, :, None]
        own = torch.full((n, B), nan, dtype=H.dtype)
        for i in range(lo, lo + rows):
            acc = torch.zeros_like(rho)
            for j in range(n):
                acc = acc + slab[i - lo, j] * y[j]
            own[i] = acc
        slabs.append(slab)
        Hys.append(own)
    Hn, d = torch.full_like(H, nan), torch.full_like(g, nan)
    for k in range(size):
        lo, rows = k * R, max(0, min(R, n - k * R))
        Hy = Hys[k].clone()
        for i in range(n):
            if i // R != k:
                Hy[i] = Hys[i // R][i]
        yHy = torch.zeros_like(rho)
        for i in range(n):
            yHy = yHy + y[i] * Hy[i]
        coef = rho * (1.0 + rho * yHy)
        for i in range(lo, lo + rows):
            acc = torch.zeros_like(rho)
            for j in range(n):
                h = slabs[k][i - lo, j]
                hn = (h - rho * (s[i] * Hy[j] + Hy[i] * s[j])) + coef * (s[i] * s[j])
                Hn[i, j] = hn
                acc = acc + hn * g[j]
            d[i] = -acc
    return Hn, d


def _cluster_case(n, B, dtype, seed=21):
    """A batch-minor case whose reset lanes hold NaN in H: a kernel that
    read their H in place of the identity would show it."""
    H, s, y, g, rho, reset = _t(*_batchminor_case(seed, n, B, dtype))
    H[:, :, reset] = float("nan")
    return H, s, y, g, rho, reset


# (n, CTAs a cluster, B): rows split evenly and not, CTAs left without a
# row (n = 9 over 8: R = 2, CTAs 5 to 7 hold none), a lone CTA, B no
# multiple of a lane group (one-word copies)
CLUSTER_CASES = [(12, 4, 24), (9, 8, 16), (13, 2, 21), (6, 1, 12), (16, 8, 8), (5, 4, 10)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,size,B", CLUSTER_CASES)
def test_cluster_order_equals_ascending_reference(n, size, B, dtype):
    """K4b-c's order (rows split over the cluster, Hy gathered, y^T Hy and
    the rows summed in every CTA) is K4b's ascending order bit for bit,
    with the 16-byte lane groups of the kernel (4 float32, 2 float64
    lanes) or single lanes where B leaves a group ragged."""
    case = _cluster_case(n, B, dtype)
    group = 16 // np.dtype(dtype).itemsize
    Hn, d = cluster_emulation(*case, size=size, group=group)
    want_H, want_d = ascending_reference(*case)
    assert torch.equal(Hn, want_H) and torch.equal(d, want_d)
    assert not torch.isnan(Hn).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_cluster_order_within_twin_and_jax_rowtiled(n, dtype):
    """K4b-c's order against the twin (torch.sum's order) and against the
    JAX package's row-tiled kernel in interpret mode (tile=32, tile_r=4 or
    8, a divisor of n, as it needs): within KERNEL_TOL_ULPS * n * eps of
    their largest entries."""
    from nlsolver_tpu.ops.rank2 import rank2_direction_batchminor_pallas_rowtiled

    case = _t(*_batchminor_case(22, n, 64, dtype))
    got = cluster_emulation(*case, size=4, group=16 // np.dtype(dtype).itemsize)
    jax_out = rank2_direction_batchminor_pallas_rowtiled(
        *(a.numpy() for a in case), tile=32, tile_r=min(8, n), interpret=True)
    for want in (tr.rank2_direction_batchminor_reference(*case),
                 tuple(torch.from_numpy(np.asarray(a)) for a in jax_out)):
        for a, b in zip(got, want):
            tol = tr.KERNEL_TOL_ULPS * n * torch.finfo(b.dtype).eps * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol


def test_cluster_envelope_and_dispatcher():
    """K4b-c's range, worked out from 232448 bytes a CTA: ceil(n / 8) rows
    of n | 1 words and four vectors, 8 lanes, and 256 threads, a row and
    lane each; the dispatcher's three ranges by n and dtype alone."""
    f32, f64 = torch.float32, torch.float64
    assert (tr.CLUSTER_SIZE, tr.CLUSTER_LANES, tr.CLUSTER_THREADS) == (8, 8, 256)
    assert tr.cluster_bytes(128, f32) == (16 * 129 + 512) * 8 * 4 == 82432
    assert tr.cluster_bytes(224, f32) == (28 * 225 + 896) * 8 * 4 <= 232448 < \
        tr.cluster_bytes(225, f32)
    assert tr.cluster_bytes(152, f64) == (19 * 153 + 608) * 8 * 8 <= 232448 < \
        tr.cluster_bytes(153, f64)
    assert [n for n in range(1, 400) if tr.cluster_fits(n, f32)] == list(range(1, 225))
    assert [n for n in range(1, 400) if tr.cluster_fits(n, f64)] == list(range(1, 153))
    assert not tr.cluster_fits(16, torch.float16) and not tr.cluster_fits(0, f32)
    # the probe's shapes at n = 128: a CTA's rows in its shared memory and
    # in 256 threads; a tile of at least 16 bytes, a power of two
    takes = {(size, lanes) for size in (1, 2, 4, 8, 16) for lanes in (2, 4, 8, 16, 32)
             if tr.cluster_takes(128, f32, size, lanes)}
    assert takes == {(2, 4), (4, 4), (8, 4), (16, 4), (4, 8), (8, 8), (16, 8), (8, 16), (16, 16),
                     (16, 32)}
    assert tr.cluster_takes(40, f64, 4, 2) and not tr.cluster_takes(40, f64, 4, 1)
    for dtype, ends in ((f32, (40, 224)), (f64, (28, 152))):
        forms = [tr.direction_form(n, dtype) for n in range(1, 300)]
        assert forms == ["resident"] * ends[0] + ["cluster"] * (ends[1] - ends[0]) + \
            ["rowsplit"] * (299 - ends[1])


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
    if n == 45:  # beyond the resident slab: the dispatcher takes K4b-c, K4b's bits
        cluster_before = tr.rank2_direction_batchminor_cluster.launches
        Hc, dc = tr.rank2_direction_batchminor(*case)
        assert tr.rank2_direction_batchminor_cluster.launches == cluster_before + 1
        assert torch.equal(Hc, Hn) and torch.equal(dc, d)


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


def _cluster_on_card(n, B, dtype, dev):
    return tuple(t.to(dev) if t.dtype == torch.bool else t.to(dev, dtype)
                 for t in _cluster_case(n, B, np.float64))


@pytest.mark.gpu
@pytest.mark.parametrize("n,B,dtype", [
    (128, 4096, torch.float32), (128, 1001, torch.float32), (41, 1001, torch.float32),
    (224, 1001, torch.float32), (224, 4096, torch.float32), (29, 1001, torch.float64),
    (152, 1001, torch.float64), (152, 4096, torch.float64), (64, 16389, torch.float32)])
def test_cluster_kernel_bit_equal_to_rowsplit_on_card(n, B, dtype):
    """K4b-c at the wide fleet's [128, 128, 4096], at the first and last n
    of its range in float32 and float64, with B = 1001 (one-word copies)
    and reset lanes whose H is NaN: K4b's bits, and the twin within
    tolerance; the dispatcher takes it."""
    dev = _on_card()
    case = _cluster_on_card(n, B, dtype, dev)
    before = tr.rank2_direction_batchminor_cluster.launches
    Hn, d = tr.rank2_direction_batchminor(*case)  # the dispatcher's choice
    torch.cuda.synchronize()
    assert tr.rank2_direction_batchminor_cluster.launches == before + 1
    wH, wd = tr.rank2_direction_batchminor_rowsplit(*case)
    assert torch.equal(Hn, wH) and torch.equal(d, wd)
    tH, td = tr.rank2_direction_batchminor_reference(*case)
    _assert_within(Hn, tH, n, "H'")
    _assert_within(d, td, n, "d'")


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype", [(225, torch.float32), (153, torch.float64)])
def test_rowsplit_past_the_cluster_form_on_card(n, dtype):
    """Past K4b-c's range the dispatcher takes K4b, within tolerance of the
    twin."""
    dev = _on_card()
    case = _cluster_on_card(n, 97, dtype, dev)
    before = tr.rank2_direction_batchminor_rowsplit.launches
    Hn, d = tr.rank2_direction_batchminor(*case)
    torch.cuda.synchronize()
    assert tr.rank2_direction_batchminor_rowsplit.launches == before + 1
    tH, td = tr.rank2_direction_batchminor_reference(*case)
    _assert_within(Hn, tH, n, "H'")
    _assert_within(d, td, n, "d'")


@pytest.mark.gpu
@pytest.mark.parametrize("size,lanes", [(2, 8), (4, 8), (4, 16), (16, 8), (16, 32), (8, 4)])
def test_cluster_shapes_bit_equal_on_card(size, lanes):
    """Every cluster size and tile the probe times, at n = 50 with a ragged
    last tile: K4b's bits."""
    dev = _on_card()
    case = _cluster_on_card(50, 1003, torch.float32, dev)
    Hn, d = tr.rank2_direction_batchminor_cluster(*case, size=size, lanes=lanes)
    wH, wd = tr.rank2_direction_batchminor_rowsplit(*case)
    torch.cuda.synchronize()
    assert torch.equal(Hn, wH) and torch.equal(d, wd)


@pytest.mark.gpu
def test_cluster_kernel_refuses_what_it_does_not_take_on_card():
    dev = _on_card()
    H, s, y, g, rho, reset = _cluster_on_card(64, 64, torch.float32, dev)
    cluster = tr.rank2_direction_batchminor_cluster
    with pytest.raises(ValueError, match="float32 or float64"):
        cluster(H.half(), s.half(), y.half(), g.half(), rho.half(), reset)
    with pytest.raises(ValueError, match="contiguous"):
        cluster(H.transpose(0, 1), s, y, g, rho, reset)
    with pytest.raises(ValueError, match="does not fit"):
        cluster(H, s, y, g, rho, reset, size=2, lanes=32)  # 1024 threads
    with pytest.raises(ValueError, match="does not fit"):
        big = torch.zeros(225, 225, 8, device=dev)
        v = torch.zeros(225, 8, device=dev)
        cluster(big, v, v, v, torch.zeros(8, device=dev),
                torch.zeros(8, dtype=torch.bool, device=dev))
