"""Kernels K4a, K4b-c, K4b and K4c (K4c-r, K4c-w, K4c-g) of nlsolver_torch
(``ops.rank2``): the three plain twins against the JAX package's jnp
formulations (f64, rtol 1e-12) and against its Pallas kernels in interpret
mode (f32), K4c's twin also past one block's shared memory, a plain-tensor
emulation of K4b-c's order, the CPU routes, the shapes refused, the
shared-memory envelopes and the dispatchers' choices, and the CUDA kernels
against their twins and each other (on a card only).

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
                tr.rank2_direction_batchminor_streamed, tr.rank2_direction_batchminor_rowsplit,
                tr.rank2_update_batched_kernel, tr.rank2_update_batched_rows,
                tr.rank2_update_batched_warp, tr.rank2_update_batched_global)
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


def test_batched_form_envelopes():
    """K4c's forms by n: K4c-r while an instance's rows are lanes of one
    warp (n <= 32) and n is at most ``ROWS_LAST``, K4c-w to ``WARP_LAST``,
    within the n whose instance, (n (n + 1) + 3 n) words, fits a block's
    232448 bytes (n <= 239 in float32, 168 in float64), K4c-g beyond; every
    n takes a form."""
    assert tr.ROWS_MOST == 32
    assert [n for n in range(0, 40) if tr.rows_takes(n)] == list(range(1, 33))
    for dtype, item, last, rows, warp in ((torch.float32, 4, 239, 32, 48),
                                          (torch.float64, 8, 168, 15, 48)):
        words = [n * (n + 1) + 3 * n for n in (last, last + 1)]
        assert words[0] * item <= 232448 < words[1] * item
        assert tr.batched_fits(last, dtype) and not tr.batched_fits(last + 1, dtype)
        assert (tr.ROWS_LAST[dtype], tr.WARP_LAST[dtype]) == (rows, warp)
        forms = [tr.batched_form(n, dtype) for n in range(1, 2 * last)]
        assert forms == (["rows"] * rows + ["warp"] * (warp - rows)
                         + ["global"] * (2 * last - 1 - warp)), dtype
        assert tr.batched_form(5000, dtype) == "global"
    assert set(tr.BATCHED_FORMS) == {"rows", "warp", "global"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_staged_by_lanes(dtype):
    """K4c-r's way by n and B: staged through shared memory at the n
    ``ROWS_STAGED`` lists for the first bound that B is at most, the last
    bound's n for every B beyond, straight from device memory elsewhere."""
    table = tr.ROWS_STAGED[dtype]
    assert [most for most, _ in table] == [256, 10000, 65536]
    for (most, staged), fewer in zip(table, (1, 257, 10001)):
        assert staged <= set(range(1, tr.ROWS_MOST + 1))
        for B in (fewer, most):
            assert {n for n in range(1, 40) if tr.rows_staged(n, dtype, B)} == staged, B
    beyond = {n for n in range(1, 40) if tr.rows_staged(n, dtype, 10 ** 6)}
    assert beyond == table[-1][1]
    if dtype == torch.float32:  # the single-instance BFGS's n = 16: staged on 10000 lanes only
        assert [tr.rows_staged(16, dtype, B) for B in (256, 10000, 65536)] == [False, True, False]
        assert [n for n in range(1, 33) if not tr.rows_staged(n, dtype, 10000)] == [
            1, 2, 3, 4, 8, 12, 20, 24]
        assert [n for n in range(1, 33) if not tr.rows_staged(n, dtype, 65536)] == [
            1, 2, 3, 4, 8, 12, 16, 20, 24, 28]


@pytest.mark.parametrize("n,dtype", [(240, np.float32), (169, np.float64)])
def test_batched_twin_past_the_block_matches_jax(n, dtype):
    """The first n past K4c-w's block, K4c-g's on a card: the twin on 3
    lanes against the JAX jnp formulation and the Pallas kernel in
    interpret mode (tile 32, here the 3 lanes).  The sums run in another
    order: within ``KERNEL_TOL_ULPS`` n ulp of the largest entry."""
    import jax
    from nlsolver_tpu.ops.rank2 import rank2_update_batched_jnp, rank2_update_batched_pallas

    H, s, y, _, rho, _ = _batchminor_case(8, n, 3, dtype)
    Hb, sb, yb = (np.ascontiguousarray(a) for a in (H.transpose(2, 0, 1), s.T, y.T))
    got = tr.rank2_update_batched(*_t(Hb, sb, yb, rho))
    assert got.dtype == torch.from_numpy(Hb).dtype and tuple(got.shape) == (3, n, n)
    for want in (jax.jit(rank2_update_batched_jnp)(Hb, sb, yb, rho),
                 rank2_update_batched_pallas(Hb, sb, yb, rho, tile=32, interpret=True)):
        want = np.asarray(want)
        tol = tr.KERNEL_TOL_ULPS * n * np.finfo(dtype).eps * float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= tol


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
    lane each; the dispatcher's four ranges by n, dtype and B (K4b-t past
    K4b-c's up to streamed_last, K4b past it)."""
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
        for B in (1, 256, 257, 4096, 16385):
            end = max(ends[1], tr.streamed_last(dtype, B))
            forms = [tr.direction_form(n, dtype, B) for n in range(1, 1500)]
            assert forms == ["resident"] * ends[0] + ["cluster"] * (ends[1] - ends[0]) + \
                ["streamed"] * (end - ends[1]) + ["rowsplit"] * (1499 - end)


def streamed_emulation(H, s, y, g, rho, reset, size, chunk, group):
    """K4b-t in plain torch ops, in the kernel's order.  CTA k of a cluster
    of ``size`` owns rows k R .. k R + R - 1 (R = ceil(n / size)) and
    streams them in chunks of ``chunk`` columns twice, each copy starting as
    NaN and filled lane group by lane group of ``group`` lanes, a group
    whose lanes all reset left out (a reset lane takes the identity in place
    of what it read).  The first pass sums Hy of the CTA's rows, the CTA's
    copy of Hy takes its peers' rows, y^T Hy runs once over it in ascending
    i, and the second pass forms the rows' H' and d' from a fresh copy,
    chunk by chunk in ascending j."""
    n, _, B = H.shape
    R = -(-n // size)
    fetched = (~reset).reshape(-1, group).any(dim=1).repeat_interleave(group) \
        if B % group == 0 else ~reset
    nan = float("nan")
    eye = torch.eye(n, dtype=H.dtype)

    def copy(i, j0, j1):
        """Rows i of H, columns j0 .. j1 - 1, as a CTA's shared memory holds
        them: NaN where not fetched, the identity on reset lanes."""
        got = torch.full((len(i), j1 - j0, B), nan, dtype=H.dtype)
        got[:, :, fetched] = H[i][:, j0:j1][:, :, fetched]
        got[:, :, reset] = eye[i][:, j0:j1, None]
        return got

    ctas = []
    for k in range(size):
        rows = list(range(k * R, min(n, k * R + R)))
        Hy = torch.full((n, B), nan, dtype=H.dtype)
        accs = [torch.zeros_like(rho) for _ in rows]
        for j0 in range(0, n, chunk) if rows else ():
            ring = copy(rows, j0, min(n, j0 + chunk))
            for a in range(len(rows)):
                for j in range(j0, min(n, j0 + chunk)):
                    accs[a] = accs[a] + ring[a, j - j0] * y[j]
        for a, i in enumerate(rows):
            Hy[i] = accs[a]
        ctas.append((rows, Hy))
    Hn, d = torch.full_like(H, nan), torch.full_like(g, nan)
    for k, (rows, own) in enumerate(ctas):
        Hy = own.clone()
        for i in range(n):
            if i // R != k:
                Hy[i] = ctas[i // R][1][i]
        yHy = torch.zeros_like(rho)
        for i in range(n):
            yHy = yHy + y[i] * Hy[i]
        coef = rho * (1.0 + rho * yHy)
        accs = [torch.zeros_like(rho) for _ in rows]
        for j0 in range(0, n, chunk) if rows else ():
            ring = copy(rows, j0, min(n, j0 + chunk))
            for a, i in enumerate(rows):
                for j in range(j0, min(n, j0 + chunk)):
                    hn = (ring[a, j - j0] - rho * (s[i] * Hy[j] + Hy[i] * s[j])) + \
                        coef * (s[i] * s[j])
                    Hn[i, j] = hn
                    accs[a] = accs[a] + hn * g[j]
        for a, i in enumerate(rows):
            d[i] = -accs[a]
    return Hn, d


# (n, CTAs a cluster, columns a chunk, B): chunks that split the columns
# evenly and not, a chunk of every column, CTAs with fewer rows than R (n =
# 13 over 4: R = 4, the last CTA has 1) or none (n = 9 over 8), one CTA, a
# chunk of one column, B no multiple of a lane group (one-word copies)
STREAMED_CASES = [(12, 4, 5, 24), (12, 4, 12, 24), (9, 8, 3, 16), (13, 4, 4, 21),
                  (16, 2, 16, 8), (6, 1, 1, 12), (10, 2, 7, 10), (13, 4, 6, 16)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,size,chunk,B", STREAMED_CASES)
def test_streamed_order_equals_ascending_reference(n, size, chunk, B, dtype):
    """K4b-t's order (rows streamed twice over the cluster, Hy gathered,
    y^T Hy once a lane) is K4b's ascending order bit for bit; no NaN of a
    copy that was left out reaches H' or d'."""
    case = _cluster_case(n, B, dtype)
    group = 16 // np.dtype(dtype).itemsize
    Hn, d = streamed_emulation(*case, size=size, chunk=chunk, group=group)
    want_H, want_d = ascending_reference(*case)
    assert torch.equal(Hn, want_H) and torch.equal(d, want_d)
    assert not torch.isnan(Hn).any() and not torch.isnan(d).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [16, 24])
def test_streamed_order_within_twin_and_jax_rowtiled(n, dtype):
    """K4b-t's order, the rows streamed in chunks of 5 columns over
    clusters of 4, against the twin and against the JAX package's row-tiled
    kernel in interpret mode (tile=32, tile_r=8, which divides n): within
    KERNEL_TOL_ULPS * n * eps of their largest entries."""
    from nlsolver_tpu.ops.rank2 import rank2_direction_batchminor_pallas_rowtiled

    case = _t(*_batchminor_case(23, n, 64, dtype))
    got = streamed_emulation(*case, size=4, chunk=5, group=16 // np.dtype(dtype).itemsize)
    jax_out = rank2_direction_batchminor_pallas_rowtiled(
        *(a.numpy() for a in case), tile=32, tile_r=8, interpret=True)
    for want in (tr.rank2_direction_batchminor_reference(*case),
                 tuple(torch.from_numpy(np.asarray(a)) for a in jax_out)):
        for a, b in zip(got, want):
            tol = tr.KERNEL_TOL_ULPS * n * torch.finfo(b.dtype).eps * float(b.abs().max())
            assert float((a - b).abs().max()) <= tol


def test_streamed_plan_and_residency_edges():
    """K4b-t's plan, worked out from 232448 bytes a CTA: chunks of 32
    columns (a ring of two chunks of R = ceil(n / 16) rows, 33 words a row,
    four vectors and the coefficients, 8 float32 or 4 float64 lanes: 32
    bytes an entry in both), narrower near the end of the range, which 512
    threads a CTA (a row and lane each) end at n = 1024 in float32 and the
    shared memory at 1415 in float64; the residency edge, n = 304, the last
    where a cluster of 16 could hold every row (K4b-c on 16 CTAs), streamed
    alike on both sides; the dispatcher stops at streamed_last(dtype, B)."""
    f32, f64 = torch.float32, torch.float64
    assert (tr.STREAMED_SIZE, tr.STREAMED_RING, tr.STREAMED_THREADS, tr.STREAMED_CHUNK) == \
        (16, 2, 512, 32)
    assert (tr.streamed_lanes(f32), tr.streamed_lanes(f64)) == (8, 4)
    for dtype, last, end in ((f32, 1024, 23), (f64, 1415, 9)):
        lanes = tr.streamed_lanes(dtype)
        for n in (153, 225, 304, 305, 320):
            assert tr.streamed_plan(n, dtype) == 32
        assert tr.cluster_takes(304, dtype, 16, lanes) and not tr.cluster_takes(305, dtype, 16, lanes)
        assert tr.streamed_bytes(320, dtype, 16, lanes, 32) == (2 * 20 * 33 + 4 * 320 + 1) * 32
        assert tr.streamed_plan(last, dtype) == end
        assert tr.streamed_plan(last + 1, dtype) is None
        assert all(tr.streamed_plan(n, dtype) for n in range(1, last + 1))
        # the widest chunk narrows where a ring of 32 columns leaves the
        # shared memory: the first n below 32 takes the widest odd chunk
        # that fits, and one more column pair would not
        wide = max(n for n in range(1, last + 1) if tr.streamed_plan(n, dtype) == 32)
        chunk = tr.streamed_plan(wide + 1, dtype)
        assert chunk < 32 and tr.streamed_bytes(wide + 1, dtype, 16, lanes, chunk) <= 232448 < \
            tr.streamed_bytes(wide + 1, dtype, 16, lanes, chunk + 2)
        # the dispatcher: K4b-t to streamed_last, within what the plan takes,
        # the last n falling as B grows, none past the largest B measured
        bounds = [most for most, _ in tr.STREAMED_LAST[dtype]]
        assert bounds == sorted(bounds)
        stops = [tr.streamed_last(dtype, B) for B in bounds]
        assert stops == sorted(stops, reverse=True) and stops[0] <= last
        for most, stop in tr.STREAMED_LAST[dtype]:
            for B in (most, most // 2 + 1):
                assert tr.streamed_last(dtype, B) == stop
                assert tr.streamed_fits(stop, dtype, B) == (stop > 0)
                assert not tr.streamed_fits(stop + 1, dtype, B)
        assert tr.streamed_last(dtype, bounds[-1] + 1) == 0
        assert not tr.streamed_fits(225, dtype, bounds[-1] + 1)
    # a chunk given is taken as it is, or refused
    assert tr.streamed_plan(225, f32, chunk=211) == 211
    assert tr.streamed_plan(225, f32, chunk=7) == 7
    assert tr.streamed_plan(225, f32, chunk=212) is None  # 233312 bytes
    assert tr.streamed_plan(225, f32, chunk=226) is None
    assert tr.streamed_plan(64, f32, size=1, lanes=32) is None    # 2048 threads
    assert tr.streamed_plan(64, torch.float16) is None
    assert tr.streamed_plan(64, f64, size=4, lanes=1) is None     # under 16 bytes a copy


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


def _batched_on_card(n, B, dtype, dev, offset=0):
    """K4c's inputs on the card; with ``offset`` H starts that many words
    into its storage (off 16 bytes: the forms' one-word accesses)."""
    H, s, y, _, rho, _ = _batchminor_case(n, n, B)
    H = torch.from_numpy(np.ascontiguousarray(H.transpose(2, 0, 1))).to(dev, dtype)
    if offset:
        H = torch.empty(H.numel() + offset, device=dev, dtype=dtype)[offset:].view_as(H).copy_(H)
    return (H, *(t.to(dev, dtype) for t in _t(s.T, y.T, rho)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B,offset", [(1, 777, 0), (2, 777, 0), (10, 1001, 0), (16, 4097, 0),
                                        (16, 1001, 1), (31, 333, 0), (32, 333, 0)])
def test_rows_kernel_bit_equal_to_warp_on_card(n, B, offset, dtype):
    """K4c-r equals K4c-w bit for bit (the same sums in the same order),
    staged through shared memory and straight from device memory with
    16-byte and one-word accesses; the dispatcher takes the form
    ``batched_form`` names."""
    dev = _on_card()
    args = _batched_on_card(n, B, dtype, dev, offset)
    before = tr.rank2_update_batched_rows.launches
    got = tr.rank2_update_batched_rows(*args)
    torch.cuda.synchronize()
    assert tr.rank2_update_batched_rows.launches == before + 1
    assert torch.equal(got, tr.rank2_update_batched_warp(*args))
    for staged in (False, True):  # straight from device memory and through shared memory
        assert torch.equal(got, tr.rank2_update_batched_rows(*args, _staged=staged)), staged
    _assert_within(got, tr.rank2_update_batched_reference(*args), n, "H'")
    form = tr.BATCHED_FORMS[tr.batched_form(n, dtype)]
    before = form.launches, tr.rank2_update_batched_kernel.launches
    assert torch.equal(got, tr.rank2_update_batched(*args))
    assert (form.launches, tr.rank2_update_batched_kernel.launches) == (before[0] + 1,
                                                                         before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype,offset", [(64, torch.float32, 0), (63, torch.float32, 0),
                                            (64, torch.float32, 1), (33, torch.float64, 0),
                                            (34, torch.float64, 0), (16, torch.float32, 0)])
def test_global_kernel_bit_equal_to_warp_on_card(n, dtype, offset):
    """K4c-g equals K4c-w bit for bit where both take n."""
    dev = _on_card()
    args = _batched_on_card(n, 1001, dtype, dev, offset)
    before = tr.rank2_update_batched_global.launches
    got = tr.rank2_update_batched_global(*args)
    torch.cuda.synchronize()
    assert tr.rank2_update_batched_global.launches == before + 1
    assert torch.equal(got, tr.rank2_update_batched_warp(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("n,dtype", [(240, torch.float32), (169, torch.float64),
                                     (300, torch.float32)])
def test_global_kernel_past_the_block_on_card(n, dtype):
    """Past K4c-w's block the dispatcher takes K4c-g, within tolerance of
    the twin."""
    dev = _on_card()
    args = _batched_on_card(n, 5, dtype, dev)
    assert tr.batched_form(n, dtype) == "global"
    before = tr.rank2_update_batched_global.launches
    got = tr.rank2_update_batched(*args)
    torch.cuda.synchronize()
    assert tr.rank2_update_batched_global.launches == before + 1
    _assert_within(got, tr.rank2_update_batched_reference(*args), n, "H'")


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
    with pytest.raises(ValueError, match="passes the 32 rows of a warp"):
        tr.rank2_update_batched_rows(*_batched_on_card(33, 4, torch.float32, dev))
    with pytest.raises(ValueError, match="does not fit"):
        tr.rank2_update_batched_warp(*_batched_on_card(240, 2, torch.float32, dev))
    with pytest.raises(ValueError, match="float32 or float64"):
        tr.rank2_update_batched(*(t.half() for t in _batched_on_card(4, 8, torch.float32, dev)))


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
    """Past K4b-c's range the dispatcher takes K4b-t, K4b's bits; past
    K4b-t's range (the n past streamed_last on 5 lanes) K4b; each within
    tolerance of the twin."""
    dev = _on_card()
    past = tr.streamed_last(dtype, 5) + 1
    for m, B, kernel in ((n, 97, tr.rank2_direction_batchminor_streamed),
                         (past, 5, tr.rank2_direction_batchminor_rowsplit)):
        case = _cluster_on_card(m, B, dtype, dev)
        before = kernel.launches
        Hn, d = tr.rank2_direction_batchminor(*case)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        wH, wd = tr.rank2_direction_batchminor_rowsplit(*case)
        assert torch.equal(Hn, wH) and torch.equal(d, wd)
        tH, td = tr.rank2_direction_batchminor_reference(*case)
        _assert_within(Hn, tH, m, "H'")
        _assert_within(d, td, m, "d'")


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


@pytest.mark.gpu
@pytest.mark.parametrize("n,B,dtype", [
    (225, 256, torch.float32), (225, 1001, torch.float32), (153, 1001, torch.float64),
    (304, 256, torch.float32), (305, 256, torch.float32), (320, 256, torch.float32),
    (305, 98, torch.float64), (1024, 24, torch.float32), (1415, 6, torch.float64)])
def test_streamed_kernel_bit_equal_to_rowsplit_on_card(n, B, dtype):
    """K4b-t through the dispatcher at the wide fleet's [225, 225, 256], at
    the first n of its range in float64, at n = 304 and 305, at the second
    wide fleet's n = 320, and by a direct call where the dispatcher stops
    short of the plan's last n in float32 and float64: K4b's bits (reset
    lanes' H is NaN), the twin within tolerance."""
    dev = _on_card()
    case = _cluster_on_card(n, B, dtype, dev)
    before = tr.rank2_direction_batchminor_streamed.launches
    Hn, d = (tr.rank2_direction_batchminor if tr.streamed_fits(n, dtype, B)
             else tr.rank2_direction_batchminor_streamed)(*case)
    torch.cuda.synchronize()
    assert tr.rank2_direction_batchminor_streamed.launches == before + 1
    wH, wd = tr.rank2_direction_batchminor_rowsplit(*case)
    assert torch.equal(Hn, wH) and torch.equal(d, wd)
    tH, td = tr.rank2_direction_batchminor_reference(*case)
    _assert_within(Hn, tH, n, "H'")
    _assert_within(d, td, n, "d'")


# (n, B, dtype, size, lanes, chunk): small n in chunks that split the
# columns evenly and not, a chunk of every column, CTAs with fewer rows than
# R (n = 50 over 16), one CTA, ragged tiles, one-word copies (B odd),
# float64's 16-byte groups of 2; the wide fleet's n = 225 in one chunk of
# 211 columns (the widest that fits) and in chunks of 7, clusters of 8 at
# 225, n = 304 and 305 (the last n and the first past where a cluster of
# 16 could hold every row)
STREAMED_PLANS = [
    (50, 1003, torch.float32, 4, 8, 7), (50, 1003, torch.float32, 4, 8, 50),
    (50, 1003, torch.float32, 16, 8, 3), (50, 1003, torch.float32, 2, 8, 16),
    (50, 1003, torch.float32, 8, 4, 5), (50, 1000, torch.float32, 16, 32, 9),
    (50, 1000, torch.float32, 16, 8, 50), (33, 1000, torch.float32, 1, 8, 11),
    (50, 999, torch.float64, 4, 2, 11), (64, 1000, torch.float64, 8, 4, 64),
    (225, 256, torch.float32, 16, 8, 211), (225, 256, torch.float32, 8, 8, 64),
    (304, 256, torch.float32, 16, 8, 7), (305, 256, torch.float32, 16, 8, 123),
    (153, 99, torch.float64, 16, 4, 153)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,B,dtype,size,lanes,chunk", STREAMED_PLANS)
def test_streamed_plans_bit_equal_on_card(n, B, dtype, size, lanes, chunk):
    """K4b-t with a plan given: K4b's bits in H' and d', and in probe mode 2
    (no L2 hints) too."""
    dev = _on_card()
    case = _cluster_on_card(n, B, dtype, dev)
    wH, wd = tr.rank2_direction_batchminor_rowsplit(*case)
    for mode in (0, 2):
        Hn, d = tr.rank2_direction_batchminor_streamed(*case, size=size, lanes=lanes, chunk=chunk,
                                                       _mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(Hn, wH) and torch.equal(d, wd)


@pytest.mark.gpu
def test_streamed_kernel_refuses_what_it_does_not_take_on_card():
    dev = _on_card()
    H, s, y, g, rho, reset = _cluster_on_card(64, 64, torch.float32, dev)
    streamed = tr.rank2_direction_batchminor_streamed
    with pytest.raises(ValueError, match="float32 or float64"):
        streamed(H.half(), s.half(), y.half(), g.half(), rho.half(), reset)
    with pytest.raises(ValueError, match="contiguous"):
        streamed(H.transpose(0, 1), s, y, g, rho, reset)
    with pytest.raises(ValueError, match="does not fit"):
        streamed(H, s, y, g, rho, reset, size=1, lanes=32)  # 2048 threads
    with pytest.raises(ValueError, match="does not fit"):
        big = torch.zeros(1025, 1025, 8, device=dev)
        v = torch.zeros(1025, 8, device=dev)
        streamed(big, v, v, v, torch.zeros(8, device=dev),
                 torch.zeros(8, dtype=torch.bool, device=dev))
