"""Kernels K2a and K2b of nlsolver_torch (``ops.qr_wavefront``): the CPU
route (the plain twins) against the JAX package's Pallas kernels in
interpret mode and its jnp wavefront, plain-tensor emulations of the
order of K2a's warp, cluster, distributed and panel forms (the last with
its rotation log) and of K2b's window,
warp, cluster and distributed forms, the shapes each form takes and
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


LSTSQ_FORMS = (tqw.least_squares_wavefront_registers, tqw.least_squares_wavefront_shared,
               tqw.least_squares_wavefront_warp, tqw.least_squares_wavefront_cluster,
               tqw.least_squares_wavefront_distributed, tqw.least_squares_wavefront_panel,
               tqw.least_squares_wavefront_global)


QR_FORMS = (tqw.qr_wavefront_warp, tqw.qr_wavefront_cluster, tqw.qr_wavefront_distributed,
            tqw.qr_wavefront_panel, tqw.qr_wavefront_global)


def _counts():
    return [f.launches for f in QR_FORMS + LSTSQ_FORMS]


def test_cpu_route_is_the_twin_and_no_launch():
    A, y = (torch.from_numpy(a) for a in _system(2, 9, 4, 7))
    before = _counts()
    twin = tqw.least_squares_wavefront_reference(A, y)
    for solve in (tqw.least_squares_wavefront_kernel,) + LSTSQ_FORMS:
        assert torch.equal(solve(A, y), twin)
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q=True)
    for qr in (tqw.qr_wavefront_kernel,) + QR_FORMS:
        R, Q = qr(A, compute_q=True)
        assert torch.equal(R, tR) and torch.equal(Q, tQ)
    assert _counts() == before


def qr_warp_emulation(A, compute_q):
    """K2a's warp form in plain torch ops: a lane's [R | Q^T] as one m x (n
    + m) array (m x n without Q); at each stage every (c, s) is formed first
    from the pivots before the stage (the kernel's row of coefficients),
    then each of 32 threads turns its own columns (t, t + 32, ..) of every
    row pair of the stage, all n columns of R and all m of Q^T."""
    from nlsolver_torch.linalg.givens import givens_rotation

    m, n, B = A.shape
    cols = n + m if compute_q else n
    X = torch.full((m, cols, B), float("nan"), dtype=A.dtype)
    X[:, :n] = A
    if compute_q:
        X[:, n:] = torch.eye(m, dtype=A.dtype)[:, :, None]
    for k in range(m + n - 2):
        js = range(max(0, k - m + 2), min(n - 1, k // 2) + 1)
        ps = [m - 2 - k + 2 * j for j in js]
        cs = [givens_rotation(X[p, j], X[p + 1, j]) for j, p in zip(js, ps)]
        for t in range(32):
            mine = list(range(t, cols, 32))
            for p, (c, s) in zip(ps, cs):
                vp, vq = X[p, mine].clone(), X[p + 1, mine].clone()
                X[p, mine], X[p + 1, mine] = c * vp + s * vq, c * vq + (-s) * vp
    return X[:, :n], (X[:, n:].transpose(0, 1) if compute_q else None)


# square and tall, one and two columns a thread (n + m past 32), m = n = 1
QR_WARP_SHAPES = [(16, 16), (32, 8), (7, 3), (20, 19), (1, 1), (2, 1), (5, 5)]


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("compute_q", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", QR_WARP_SHAPES)
def test_qr_warp_order_equals_twin(m, n, dtype, compute_q, deficient):
    """K2a-w's order (a stage's coefficients first, then the columns dealt
    over 32 threads) is the twin's bit for bit, R below the diagonal and Q
    included; a zero column makes a = b = 0, the identity select."""
    A = torch.from_numpy(_system(10, m, n, 8, dtype)[0])
    if deficient:
        A[:, n // 2] = 0.0
    R, Q = qr_warp_emulation(A, compute_q)
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
    assert torch.equal(R, tR)
    assert (Q is None and tQ is None) if not compute_q else torch.equal(Q, tQ)


def test_qr_warp_limits():
    """K2a-w's range, worked out from 232448 bytes a warp: m (n + m) + 2 n
    words with Q, m n + 2 n without, in an odd number of words; 8 lanes a
    block, halved where they do not fit; past it the dispatcher's cluster
    form."""
    f32, f64 = torch.float32, torch.float64
    assert tqw.qr_warp_bytes(16, 16, f32, True) == (16 * 32 + 32 + 1) * 4
    assert tqw.qr_warp_bytes(32, 8, f64, False) == (32 * 8 + 16 + 1) * 8
    for dtype, q, square, tall in ((f32, True, 169, 169), (f64, True, 120, 119),
                                   (f32, False, 240, 239), (f64, False, 169, 168)):
        assert max(n for n in range(1, 300) if tqw.qr_warp_fits(n, n, dtype, q)) == square
        assert max(n for n in range(1, 300) if tqw.qr_warp_fits(n + 1, n, dtype, q)) == tall
        assert tqw.qr_form(square, square, dtype, q) == "warp"
        assert tqw.qr_form(square + 1, square + 1, dtype, q) == "cluster"
        assert tqw.qr_form(tall + 1, tall, dtype, q) == "warp"
        assert tqw.qr_form(tall + 2, tall + 1, dtype, q) == "cluster"
    assert tqw.qr_warp_fits(58000, 1, f32, False) and not tqw.qr_warp_fits(4, 5, f32, True)
    assert not tqw.qr_warp_fits(4, 4, torch.float16, True)
    assert [tqw.qr_warp_lanes(m, m, f32, True) for m in (59, 60, 84, 85, 120, 121)] == \
        [8, 4, 4, 2, 2, 1]
    assert all(tqw.qr_warp_lanes(m, n, dt, q) * tqw.qr_warp_bytes(m, n, dt, q) <= 232448
               for m in range(1, 170) for n in (1, m // 2 + 1, m) for dt in (f32, f64)
               for q in (True, False) if tqw.qr_warp_fits(m, n, dt, q))


def _qr_columns(A, compute_q):
    """The lane's m x (n + m) array [A | I] (m x n without Q), [m, cols, B]."""
    m, n, B = A.shape
    if not compute_q:
        return A.clone()
    eye = torch.eye(m, dtype=A.dtype)[:, :, None].expand(m, m, B)
    return torch.cat([A, eye], dim=1)


def _split_columns(X, parts):
    """Column c of X [m, cols, B] into part c % parts at local column c //
    parts: [parts, m, Lc, B], NaN where a part holds fewer columns."""
    m, cols, B = X.shape
    Lc = -(-cols // parts)
    out = torch.full((parts, m, Lc, B), float("nan"), dtype=X.dtype)
    for c in range(cols):
        out[c % parts, :, c // parts] = X[:, c]
    return out


def _join_columns(Xs, cols, n, compute_q):
    """The inverse of ``_split_columns``, as (R, Q | None)."""
    parts = Xs.shape[0]
    X = torch.stack([Xs[c % parts, :, c // parts] for c in range(cols)], dim=1)
    return X[:, :n], (X[:, n:].transpose(0, 1) if compute_q else None)


def _turn(Xs, cs, p, j):
    """Every part turns its local columns of rows (p, p + 1) by pivot j's
    (c, s) from its own coefficients cs [parts, 2 n, B]."""
    c, s = cs[:, 2 * j, None], cs[:, 2 * j + 1, None]
    vp, vq = Xs[:, p].clone(), Xs[:, p + 1].clone()
    Xs[:, p], Xs[:, p + 1] = c * vp + s * vq, c * vq + (-s) * vp


def qr_cluster_emulation(A, compute_q, C, groups=1):
    """K2a's cluster form in plain torch ops, in the kernel's order: column c
    of the lane's [A | I] (m x n without Q) in CTA c % C at local column c //
    C.  At each stage the owner of pivot column j forms (c, s) from its own
    column and stores it into the coefficient row of stage parity k % 2 of
    every CTA (the row poisoned with NaN first: what the stage before the
    last left there is never read); then every CTA turns all its local
    columns by the stage's rotations read from its own row, dealt over
    ``groups`` groups of threads (g takes j_lo + g, j_lo + g + groups, ..)."""
    from nlsolver_torch.linalg.givens import givens_rotation

    m, n, B = A.shape
    cols = n + m if compute_q else n
    Xs = _split_columns(_qr_columns(A, compute_q), C)
    coef = torch.full((C, 2, 2 * n, B), float("nan"), dtype=A.dtype)
    for k in range(m + n - 2):
        j_lo, j_hi = max(0, k - m + 2), min(n - 1, k // 2)
        p0 = m - 2 - k
        coef[:, k % 2] = float("nan")
        for j in range(j_lo, j_hi + 1):
            own = Xs[j % C]
            cs = givens_rotation(own[p0 + 2 * j, j // C], own[p0 + 2 * j + 1, j // C])
            coef[:, k % 2, 2 * j], coef[:, k % 2, 2 * j + 1] = cs
        for g in range(groups):
            for j in range(j_lo + g, j_hi + 1, groups):
                _turn(Xs, coef[:, k % 2], p0 + 2 * j, j)
    return _join_columns(Xs, cols, n, compute_q)


def qr_distributed_emulation(A, compute_q, P, groups=1, teams=1):
    """K2a's distributed form in plain torch ops, in the kernel's order:
    column c of the lane's [A | I] in CTA c % P at local column c // P;
    ``teams`` teams walk the lanes, team t taking lanes t, t + teams, .., so
    the lanes go in rounds of ``teams``.  At each stage the owner of pivot
    column j forms (c, s) from its own column into its team's coefficient
    row in device memory, the row chosen by the parity of the barriers the
    team has passed, which runs on from one lane to the next (the row
    poisoned with NaN first: what the stage before the last left there is
    never read); past the barrier every CTA copies the stage's pairs j_lo ..
    j_hi into its own shared row (NaN elsewhere) and turns all its local
    columns by them, dealt over ``groups`` groups of threads."""
    from nlsolver_torch.linalg.givens import givens_rotation

    m, n, B = A.shape
    cols = n + m if compute_q else n
    nan = float("nan")
    R, Q = torch.empty_like(A), torch.empty((m, m, B), dtype=A.dtype) if compute_q else None
    store = torch.full((2, 2 * n, teams), nan, dtype=A.dtype)  # a team's rows, by parity
    epoch = 0
    for first in range(0, B, teams):
        lanes = slice(first, min(B, first + teams))
        Xs = _split_columns(_qr_columns(A[:, :, lanes], compute_q), P)
        rows = store[:, :, :Xs.shape[-1]]
        for k in range(m + n - 2):
            j_lo, j_hi = max(0, k - m + 2), min(n - 1, k // 2)
            p0 = m - 2 - k
            row = rows[epoch % 2]
            row[:] = nan
            for j in range(j_lo, j_hi + 1):
                own = Xs[j % P]
                row[2 * j], row[2 * j + 1] = givens_rotation(own[p0 + 2 * j, j // P],
                                                             own[p0 + 2 * j + 1, j // P])
            epoch += 1  # the barrier
            cs = torch.full((P,) + row.shape, nan, dtype=A.dtype)
            cs[:, 2 * j_lo:2 * j_hi + 2] = row[2 * j_lo:2 * j_hi + 2]
            for g in range(groups):
                for j in range(j_lo + g, j_hi + 1, groups):
                    _turn(Xs, cs, p0 + 2 * j, j)
        R[:, :, lanes], Ql = _join_columns(Xs, cols, n, compute_q)
        if compute_q:
            Q[:, :, lanes] = Ql
    return R, Q


# square and with one row more, n below the cluster's CTAs, n + m no
# multiple of C or P, m = n = 1 (no stage), m = 2 (one), a tall [5, 3]
QR_SPREAD_SHAPES = [(12, 12), (12, 11), (9, 9), (1, 1), (2, 1), (5, 3)]


def _hold_qr_order(R, Q, A, compute_q):
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
    assert torch.equal(R, tR)
    assert (Q is None and tQ is None) if not compute_q else torch.equal(Q, tQ)


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("C,groups", [(2, 1), (4, 3), (8, 2)])
@pytest.mark.parametrize("compute_q", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", QR_SPREAD_SHAPES)
def test_qr_cluster_order_equals_twin(m, n, dtype, compute_q, C, groups, deficient):
    """K2a-c's order (columns of [R | Q^T] interleaved over C CTAs, each
    stage's coefficients formed by the pivots' owners into every CTA's row
    of the stage's parity, the rotations dealt over groups of threads) is
    the twin's bit for bit, R below the diagonal and Q included; a zero
    column makes a = b = 0, the identity select."""
    A = torch.from_numpy(_system(18, m, n, 6, dtype)[0])
    if deficient:
        A[:, n // 2] = 0.0
    _hold_qr_order(*qr_cluster_emulation(A, compute_q, C, groups), A, compute_q)


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("P,groups,teams", [(3, 1, 1), (5, 3, 2), (12, 2, 4)])
@pytest.mark.parametrize("compute_q", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", QR_SPREAD_SHAPES)
def test_qr_distributed_order_equals_twin(m, n, dtype, compute_q, P, groups, teams, deficient):
    """K2a-d's order (columns of [R | Q^T] interleaved over 3, 5 and 12 CTAs,
    more than a cluster holds and not a power of two; each stage's
    coefficients through the team's row of the barriers' parity in device
    memory, copied by every CTA past the barrier, the parity running on
    over a team's lanes; the rotations dealt over groups of threads) is the
    twin's bit for bit; a zero column makes a = b = 0, the identity select."""
    A = torch.from_numpy(_system(19, m, n, 5, dtype)[0])
    if deficient:
        A[:, n // 2] = 0.0
    _hold_qr_order(*qr_distributed_emulation(A, compute_q, P, groups, teams), A, compute_q)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qr_spread_orders_match_jax(dtype):
    """K2a-c's and K2a-d's orders against the JAX package: its Pallas kernel
    in interpret mode, and in float64 its jitted wavefront, with Q."""
    import jax
    from nlsolver_tpu.linalg.qr_parallel import qr_parallel
    from nlsolver_tpu.ops.qr_wavefront import qr_wavefront_pallas

    A = _system(20, 7, 6, 8, dtype)[0]
    jR, jQ = (np.asarray(a) for a in qr_wavefront_pallas(A, compute_q=True, interpret=True))
    want = jax.jit(qr_parallel)(A) if dtype == np.float64 else None
    for R, Q in (qr_cluster_emulation(torch.from_numpy(A), True, 4, 2),
                 qr_distributed_emulation(torch.from_numpy(A), True, 5, 2, 3)):
        if dtype == np.float32:
            np.testing.assert_allclose(R.numpy(), jR, atol=1e-5)
            np.testing.assert_allclose(Q.numpy(), jQ, atol=1e-5)
        else:
            for r, q in ((jR, jQ), (np.asarray(want.R), np.asarray(want.Q))):
                # the annihilated entries hold rounding residue: absolute slack for them
                np.testing.assert_allclose(R.numpy(), r, rtol=1e-12, atol=1e-13)
                np.testing.assert_allclose(Q.numpy(), q, rtol=1e-12, atol=1e-13)


# the last square m = n of K2a-c with clusters of 2, 4 and 8 CTAs, and of
# K2a-d on 132 CTAs, with and without Q; past the warp form's
QR_CLUSTER_ENDS = {(torch.float32, True): (239, 336, 472), (torch.float64, True): (168, 236, 332),
                   (torch.float32, False): (336, 472, 664), (torch.float64, False): (236, 332, 464)}
QR_DISTRIBUTED_END = {(torch.float32, True): 1874, (torch.float64, True): 1320,
                      (torch.float32, False): 2640, (torch.float64, False): 1816}


@pytest.mark.parametrize("dtype,compute_q", list(QR_CLUSTER_ENDS))
def test_qr_cluster_limits(dtype, compute_q):
    """K2a-c's range, worked out from 232448 bytes a CTA: m ceil(cols / C)
    words of [R | Q^T] (cols = n + m, or n without Q) and 4 n of
    coefficients, C of 2, 4 and 8; a multiple of 32 column threads that
    covers CTA 0's columns, at most 1024 threads; the plan's C the one that
    runs the most lanes at once, grown for few lanes."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for size, last in zip((2, 4, 8), QR_CLUSTER_ENDS[dtype, compute_q]):
        cols = 2 * last if compute_q else last
        assert tqw.qr_cluster_bytes(last, last, dtype, compute_q, size) == \
            (last * -(-cols // size) + 4 * last) * itemsize <= 232448 < \
            tqw.qr_cluster_bytes(last + 1, last + 1, dtype, compute_q, size)
    last = QR_CLUSTER_ENDS[dtype, compute_q][-1]
    assert tqw.qr_cluster_fits(last, last, dtype, compute_q)
    assert not tqw.qr_cluster_fits(last + 1, last + 1, dtype, compute_q)
    # with one row more: one column less with Q (a row of Q^T more), the same n without
    tall = last - 1 if compute_q else last
    assert tqw.qr_cluster_fits(tall + 1, tall, dtype, compute_q)
    assert not tqw.qr_cluster_fits(tall + 2, tall + 1, dtype, compute_q)
    assert tqw.qr_cluster_plan(last + 1, last + 1, dtype, compute_q) == (0, 0)
    for m in range(1, last + 1, 7):
        for n in (1, m // 2 + 1, m):
            C, T = tqw.qr_cluster_plan(m, n, dtype, compute_q)
            local = -(-tqw.qr_columns(m, n, compute_q) // C)
            assert tqw.qr_cluster_bytes(m, n, dtype, compute_q, C) <= 232448
            assert T % 32 == 0 and T - 32 < local <= T
            assert tqw.QR_CLUSTER_GROUPS * T <= 1024
    assert tqw.qr_cluster_plan(4, 4, torch.float16, compute_q) == (0, 0)
    assert tqw.qr_cluster_plan(3, 4, dtype, compute_q) == (0, 0)


def test_qr_cluster_plans():
    """The plans at linalg.qr's [170, 170] in float32 with Q: clusters of 2,
    4 and 8 all run 2 and 32 lanes at once, so the least, 2, doubles while
    the lanes' clusters still find an SM each (2 lanes: 8; 32 lanes: 4,
    128 CTAs); 4096 lanes take the C that runs the most at once (66, 99 and
    115 lanes: 8)."""
    f32, f64 = torch.float32, torch.float64
    assert tqw.qr_cluster_bytes(170, 170, f32, True, 4) == (170 * 85 + 680) * 4
    assert [tqw.qr_cluster_plan(170, 170, f32, True, lanes)[0] for lanes in (2, 32, 4096)] == \
        [8, 4, 8]
    assert tqw.qr_cluster_plan(170, 170, f32, True, 32) == (4, 96)
    assert tqw.qr_cluster_columns(170, 170, True, 2) == 192
    assert [tqw.qr_cluster_plan(121, 121, f64, True, lanes)[0] for lanes in (2, 32, 4096)] == \
        [8, 4, 4]
    assert [tqw.qr_cluster_plan(472, 472, f32, True, lanes) for lanes in (2, 32, 4096)] == \
        [(8, 128)] * 3


@pytest.mark.parametrize("dtype,compute_q", list(QR_DISTRIBUTED_END))
def test_qr_distributed_limits(dtype, compute_q):
    """K2a-d's range, worked out from 232448 bytes a CTA: m ceil(cols / P)
    words of [R | Q^T] and 2 n of coefficients, P up to the card's 132 SMs:
    from the end of K2a-c's range on; the least P that holds the array,
    about 256 threads a CTA."""
    first, last = QR_CLUSTER_ENDS[dtype, compute_q][-1] + 1, QR_DISTRIBUTED_END[dtype, compute_q]
    assert not tqw.qr_cluster_fits(first, first, dtype, compute_q)
    assert tqw.qr_distributed_fits(first, first, dtype, compute_q)
    assert tqw.qr_distributed_fits(last, last, dtype, compute_q)
    assert not tqw.qr_distributed_fits(last + 1, last + 1, dtype, compute_q)
    assert tqw.qr_distributed_least(last + 1, last + 1, dtype, compute_q) == 0
    assert tqw.qr_distributed_bytes(last, last, dtype, compute_q, 132) <= 232448 < \
        tqw.qr_distributed_bytes(last + 1, last + 1, dtype, compute_q, 132)
    for m in range(1, last + 1, 41):
        for n in (1, m // 3 + 1, m):
            P = tqw.qr_distributed_least(m, n, dtype, compute_q)
            assert tqw.qr_distributed_bytes(m, n, dtype, compute_q, P) <= 232448
            assert P == 1 or tqw.qr_distributed_bytes(m, n, dtype, compute_q, P - 1) > 232448
            columns = -(-tqw.qr_columns(m, n, compute_q) // P)
            G = tqw.qr_distributed_groups(m, n, compute_q, P)
            assert 1 <= columns * G <= 1024 and (columns * G <= 256 or G == 1)
    assert not tqw.qr_distributed_fits(last, last, dtype, compute_q, sms=100)
    assert tqw.qr_distributed_plan(4, 4, torch.float16, compute_q) == 0
    assert tqw.qr_distributed_plan(3, 4, dtype, compute_q) == 0


def test_qr_distributed_plans():
    """The plans at K2a-d's path, [333, 333] in float64 with Q: the least P
    that holds the array is 8; few lanes spread over the card's SMs (1 lane:
    132 CTAs, 2: 66, 32: the least), 11 columns and 23 groups a CTA at 66."""
    f32, f64 = torch.float32, torch.float64
    assert tqw.qr_distributed_bytes(333, 333, f64, True, 66) == (333 * 11 + 666) * 8
    assert tqw.qr_distributed_least(333, 333, f64, True) == 8
    assert [tqw.qr_distributed_plan(333, 333, f64, True, lanes) for lanes in
            (None, 1, 2, 32, 4096)] == [8, 132, 66, 8, 8]
    assert tqw.qr_distributed_groups(333, 333, True, 66) == 23
    assert tqw.qr_distributed_plan(473, 473, f32, True, 2) == 66
    assert tqw.qr_distributed_plan(2, 2, f32, True, 1) == 4  # a column a CTA at most


@pytest.mark.parametrize("dtype,compute_q", list(QR_DISTRIBUTED_END))
def test_qr_form_hands_over_at_each_end(dtype, compute_q):
    """The dispatcher's five ranges over square m = n, and its choice at each
    end, square and with one row more: K2a-p from the end of K2a-d's range,
    K2a-g only past K2a-p's."""
    warp = max(n for n in range(1, 300) if tqw.qr_warp_fits(n, n, dtype, compute_q))
    cluster, dist = QR_CLUSTER_ENDS[dtype, compute_q][-1], QR_DISTRIBUTED_END[dtype, compute_q]
    forms = [tqw.qr_form(n, n, dtype, compute_q) for n in range(1, dist + 3)]
    assert forms == ["warp"] * warp + ["cluster"] * (cluster - warp) + \
        ["distributed"] * (dist - cluster) + ["panel"] * 2
    panel = QR_PANEL_END[dtype]
    for last, form, after in ((warp, "warp", "cluster"), (cluster, "cluster", "distributed"),
                              (dist, "distributed", "panel"), (panel, "panel", "global")):
        assert tqw.qr_form(last, last, dtype, compute_q) == form
        assert tqw.qr_form(last + 1, last + 1, dtype, compute_q) == after
        tall = max(n for n in range(last - 2, last + 1)
                   if tqw.qr_form(n + 1, n, dtype, compute_q) == form)
        assert tqw.qr_form(tall + 2, tall + 1, dtype, compute_q) == after


def qr_panel_emulation(A, compute_q, width):
    """K2a-p in plain torch ops, in the kernel's order.  Phase 1, panel by
    panel (``qr_panel_bounds`` of at most ``width`` columns), each panel's
    columns of A alone: at each stage up to the last with a pivot below the
    panel's end j1, the panel's pivots form (c, s) from their own columns
    into the rotation log (poisoned with NaN first: no pair is read before
    it is written) at ``qr_log_offset(k) + j - j_lo``, then the stage's
    pivots below j1, earlier panels' and its own, turn the panel's columns
    from the log (the stages before 2 j0 replay the log alone).  Phase 2:
    each earlier panel's columns take the pivots from j1 on, and Q^T from
    the identity takes every pivot, from the log in stage order.  Within a
    stage the row pairs are disjoint, so how the kernel shares them out
    over CTAs and groups of threads leaves these values as they are."""
    from nlsolver_torch.linalg.givens import givens_rotation

    m, n, B = A.shape
    log = torch.full((2, tqw.qr_log_pairs(m, n), B), float("nan"), dtype=A.dtype)
    panels = tqw.qr_panel_bounds(n, width)

    def turn(X, k, lo, hi):
        j_lo, off, p0 = max(0, k - m + 2), tqw.qr_log_offset(k, m, n), m - 2 - k
        for j in range(lo, hi + 1):
            c, s = log[0, off + j - j_lo], log[1, off + j - j_lo]
            p = p0 + 2 * j
            vp, vq = X[p].clone(), X[p + 1].clone()
            X[p], X[p + 1] = c * vp + s * vq, c * vq + (-s) * vp

    R = torch.empty_like(A)
    for j0, j1 in panels:
        X = A[:, j0:j1].clone()
        for k in range(min(m + n - 3, m - 3 + j1) + 1):
            j_lo, j_hi = max(0, k - m + 2), min(n - 1, k // 2)
            hi, off = min(j_hi, j1 - 1), tqw.qr_log_offset(k, m, n)
            for j in range(max(j_lo, j0), hi + 1):
                p = m - 2 - k + 2 * j
                log[:, off + j - j_lo] = torch.stack(
                    givens_rotation(X[p, j - j0], X[p + 1, j - j0]))
            turn(X, k, j_lo, hi)
        R[:, j0:j1] = X

    def replay(X, jfrom):
        for k in range(2 * jfrom, m + n - 2):
            turn(X, k, max(jfrom, k - m + 2), min(n - 1, k // 2))
        return X

    for j0, j1 in panels[:-1]:
        R[:, j0:j1] = replay(R[:, j0:j1].clone(), j1)
    if not compute_q:
        return R, None
    eye = torch.eye(m, dtype=A.dtype)[:, :, None].repeat(1, 1, B)
    return R, replay(eye, 0).transpose(0, 1)


# (m, n, the most columns a panel): three panels of 4, tall with panels of
# 5 (3 panels, the last of 3), panels of 2 and of 1, one panel, m = n = 1
# (no stage), m = 2 (one), a tall [5, 3] in two panels
QR_PANEL_CASES = [(12, 12, 4), (20, 13, 5), (9, 9, 2), (7, 5, 1), (12, 11, 12), (1, 1, 1),
                  (2, 1, 1), (5, 3, 2)]


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("compute_q", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,width", QR_PANEL_CASES)
def test_qr_panel_order_equals_twin(m, n, width, dtype, compute_q, deficient):
    """K2a-p's order (R by panels with every rotation logged, the earlier
    panels' replay of the log, Q^T rebuilt from it) is the twin's bit for
    bit, R below the diagonal and Q included; a zero column makes a = b = 0,
    the identity select."""
    A = torch.from_numpy(_system(24, m, n, 4, dtype)[0])
    if deficient:
        A[:, n // 2] = 0.0
    _hold_qr_order(*qr_panel_emulation(A, compute_q, width), A, compute_q)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qr_panel_order_matches_jax(dtype):
    """K2a-p's order against the JAX package: its Pallas kernel in interpret
    mode and, in float64, its jitted wavefront, with Q, at [12, 12, 4] in
    three panels of 4 columns and at [13, 9, 4] in three of 3."""
    import jax
    from nlsolver_tpu.linalg.qr_parallel import qr_parallel
    from nlsolver_tpu.ops.qr_wavefront import qr_wavefront_pallas

    for m, n, width in ((12, 12, 4), (13, 9, 3)):
        A = _system(25, m, n, 4, dtype)[0]
        R, Q = qr_panel_emulation(torch.from_numpy(A), True, width)
        jR, jQ = (np.asarray(a) for a in qr_wavefront_pallas(A, compute_q=True, interpret=True))
        if dtype == np.float32:
            np.testing.assert_allclose(R.numpy(), jR, atol=1e-5)
            np.testing.assert_allclose(Q.numpy(), jQ, atol=1e-5)
        else:
            want = jax.jit(qr_parallel)(A)
            for r, q in ((jR, jQ), (np.asarray(want.R), np.asarray(want.Q))):
                # the annihilated entries hold rounding residue: absolute slack for them
                np.testing.assert_allclose(R.numpy(), r, rtol=1e-12, atol=1e-13)
                np.testing.assert_allclose(Q.numpy(), q, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("m,n", [(1, 1), (2, 1), (2, 2), (5, 3), (12, 12), (20, 13), (40, 1),
                                 (1875, 1875), (1321, 1321), (2000, 700)])
def test_qr_log_offset_counts_every_rotation(m, n):
    """The log's closed form: stage k's first pair lies past every rotation
    of the stages before it, and the log holds n (m - 1) - n (n - 1) / 2
    pairs, one a zeroed entry below the diagonal."""
    off = 0
    for k in range(m + n - 2):
        assert tqw.qr_log_offset(k, m, n) == off
        off += min(n - 1, k // 2) - max(0, k - m + 2) + 1
    assert tqw.qr_log_pairs(m, n) == off == sum(m - 1 - j for j in range(min(n, m - 1)))
    assert off == n * (m - 1) - n * (n - 1) // 2


# the last square m = n that K2a-p takes (a CTA holds one column beside a
# stage's coefficients), and the last it forms as one panel on 132 SMs
QR_PANEL_END = {torch.float32: 29055, torch.float64: 14527}
QR_ONE_PANEL_END = {torch.float32: 2641, torch.float64: 1848}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qr_panel_limits(dtype):
    """K2a-p's range, worked out from 232448 bytes a CTA: m words a column
    of R beside a stage's (c, s), at most 2 min(n, m / 2 + 1) words, from
    K2a-d's end with and without Q to the last m = n at which a CTA holds
    one column; one panel as far as 132 CTAs hold R, then panels of widths
    within one of each other, each over the fewest CTAs that hold it (at
    most 1024 columns a CTA), spread over the card for few lanes."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    last, one = QR_PANEL_END[dtype], QR_ONE_PANEL_END[dtype]
    for q in (True, False):
        first = QR_DISTRIBUTED_END[dtype, q] + 1
        assert tqw.qr_form(first, first, dtype, q) == "panel"
        assert tqw.qr_panel_fits(first, first, dtype, q)
        assert tqw.qr_panel_fits(last, last, dtype, q)
        assert not tqw.qr_panel_fits(last + 1, last + 1, dtype, q)
    assert tqw.qr_panel_columns(last, last, dtype) == 1
    assert last + 2 * (last // 2 + 1) <= 232448 // itemsize < (last + 1) + 2 * (last // 2 + 2)
    assert tqw.qr_panel_plan(last + 1, last + 1, dtype) == []
    assert [(j0, j1) for j0, j1, _ in tqw.qr_panel_plan(one, one, dtype, 1)] == [(0, one)]
    assert [(j0, j1) for j0, j1, _ in tqw.qr_panel_plan(one + 1, one + 1, dtype, 1)] == \
        [(0, (one + 2) // 2), ((one + 2) // 2, one + 1)]
    for m, n in ((one, one), (one + 1, one + 1), (3000, 2000), (5000, 5000), (last, last),
                 (40, 33), (1875, 1875), (1321, 1321)):
        per = min(tqw.qr_panel_columns(m, n, dtype), 1024)
        plan = tqw.qr_panel_plan(m, n, dtype, 2)
        assert plan[0][0] == 0 and plan[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
        widths = [j1 - j0 for j0, j1, _ in plan]
        assert max(widths) - min(widths) <= 1 and max(widths) <= 132 * per
        for j0, j1, P in plan:
            assert tqw.qr_panel_bytes(m, n, dtype, j1 - j0, P) <= 232448
            assert -(-(j1 - j0) // P) <= per and 1 <= P <= 132
            G = tqw.qr_panel_groups(j1 - j0, P)
            assert 1 <= -(-(j1 - j0) // P) * G <= 1024
        w = tqw.qr_replay_width(m, m, dtype, 2)
        assert 1 <= w and w * 2 * ((m + 1) // 2) * itemsize <= 232448
    assert tqw.qr_panel_plan(4, 4, torch.float16) == [] and tqw.qr_panel_plan(3, 4, dtype) == []


def test_qr_panel_plans():
    """The plans at K2a-p's paths: [1875, 1875] in float32 on 2 lanes, one
    panel over 66 CTAs a lane (29 columns and 35 groups a CTA), two lanes at
    once (on 3 lanes too, in two rounds); [1321, 1321] in float64, where the
    fewest CTAs that hold a lane are 67 (20 columns; 66 would need 21), so
    two teams do not fit: one lane at a time over the card's 132, on any
    number of lanes; [1817, 1817] in float64 on 1 lane over 132; the first
    shape of two panels in float64, [1849, 1849], 925 and 924 columns;
    forced panels of 4 at [12, 12]; many lanes of [333, 333] in float64, 33
    teams of the fewest, 4 CTAs."""
    f32, f64 = torch.float32, torch.float64
    assert tqw.qr_panel_plan(1875, 1875, f32, 2) == [(0, 1875, 66)]
    assert tqw.qr_panel_plan(1875, 1875, f32, 3) == [(0, 1875, 66)]
    assert tqw.qr_panel_bytes(1875, 1875, f32, 1875, 66) == (1875 * 29 + 2 * 938) * 4
    assert tqw.qr_panel_groups(1875, 66) == 35
    assert tqw.qr_panel_plan(1321, 1321, f64, 2) == [(0, 1321, 132)]
    assert tqw.qr_panel_plan(1321, 1321, f64, 64) == [(0, 1321, 132)]
    assert tqw.qr_panel_bytes(1321, 1321, f64, 1321, 67) <= 232448
    assert tqw.qr_panel_bytes(1321, 1321, f64, 1321, 66) > 232448
    assert tqw.qr_panel_plan(333, 333, f64, 64) == [(0, 333, 4)]
    assert tqw.qr_panel_plan(1817, 1817, f64, 1) == [(0, 1817, 132)]
    assert tqw.qr_panel_plan(1849, 1849, f64, 1) == [(0, 925, 132), (925, 1849, 132)]
    assert tqw.qr_panel_plan(12, 12, f64, 4, width=4) == [(0, 4, 4), (4, 8, 4), (8, 12, 4)]
    assert tqw.qr_panel_bounds(13, 5) == [(0, 5), (5, 9), (9, 13)]
    assert tqw.qr_replay_width(1875, 1875, f32, 2) == 29
    assert tqw.qr_replay_width(1321, 1321, f64, 2) == 21


@pytest.mark.parametrize("m,n,dtype,compute_q,width,launches", [
    (1875, 1875, torch.float32, True, None, 2), (2641, 2641, torch.float32, False, None, 1),
    (2642, 2642, torch.float32, True, None, 4), (1321, 1321, torch.float64, True, None, 2),
    (1849, 1849, torch.float64, True, None, 4), (1849, 1849, torch.float64, False, None, 3),
    (12, 12, torch.float64, True, 4, 6), (7, 5, torch.float32, False, 1, 9),
    (3, 4, torch.float64, True, None, 0)])
def test_qr_panel_launches(m, n, dtype, compute_q, width, launches):
    """The kernels that one call of K2a-p launches, each counted: one a
    panel, one replay of the log a panel but the last, one for Q^T."""
    assert tqw.qr_panel_launches(m, n, dtype, compute_q, width=width) == launches


def window_emulation(A, y):
    """K2b's sliding window in plain torch ops, in the kernel's order: before
    stage 0 window row 0 holds row m - 1 of [A | y]; each stage k shifts row
    m - 2 - k in at window row 0 (the row at window row 2 n - 1 is finished
    and drops out), then rotates window rows (2 j, 2 j + 1) over columns j ..
    n - 1 and the right-hand side for each of the stage's columns j.  After
    the last stage rows 0 .. n - 1 sit at window rows n - 1 .. 2 n - 2."""
    from nlsolver_torch.linalg.givens import givens_rotation
    from nlsolver_torch.linalg.qr_parallel import backsolve_bm

    m, n = A.shape[0], A.shape[1]
    W = 2 * n

    def row(r):
        return (A[r].clone(), y[r].clone()) if 0 <= r < m else None

    win = [row(m - 1)] + [None] * (W - 1)
    for k in range(m + n - 2):
        win = [row(m - 2 - k)] + win[:W - 1]
        for j in range(max(0, k - m + 2), min(n - 1, k // 2) + 1):
            (rp, yp), (rq, yq) = win[2 * j], win[2 * j + 1]
            c, s = givens_rotation(rp[j], rq[j])
            for col in range(j, n):
                vp, vq = rp[col].clone(), rq[col].clone()
                rp[col], rq[col] = c * vp + s * vq, c * vq + (-s) * vp
            vp, vq = yp.clone(), yq.clone()
            yp.copy_(c * vp + s * vq)
            yq.copy_(c * vq + (-s) * vp)
    rows = win[n - 1:2 * n - 1]
    return backsolve_bm(torch.stack([r for r, _ in rows]), torch.stack([q for _, q in rows]))


WINDOW_SHAPES = [(34, 2), (16, 16), (12, 5), (10, 3), (32, 8), (5, 4), (3, 3)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", WINDOW_SHAPES)
def test_window_order_equals_twin_and_jax(m, n, dtype):
    from nlsolver_tpu.ops.qr_wavefront import least_squares_wavefront_pallas

    A, y = _system(4, m, n, 64, dtype)
    # a dominant diagonal keeps the square systems well conditioned, so
    # that float32 x differs from the JAX kernel's by rounding alone
    A[np.arange(n), np.arange(n)] += np.asarray(2 * n, dtype)
    x = window_emulation(torch.from_numpy(A), torch.from_numpy(y))
    assert torch.equal(x, tqw.least_squares_wavefront_reference(torch.from_numpy(A),
                                                                torch.from_numpy(y)))
    jx = np.asarray(least_squares_wavefront_pallas(A, y, interpret=True))
    if dtype == np.float32:
        np.testing.assert_allclose(x.numpy(), jx, atol=1e-5)
    else:
        np.testing.assert_allclose(x.numpy(), jx, rtol=1e-12, atol=1e-13)


def warp_emulation(A, y):
    """K2b's warp form in plain torch ops: the window as a ring of 2 n + 1
    rows (ring row r % (2 n + 1) holds row r of [A | y]), a row fetched a
    stage ahead into the ring row of the row that left the window; at each
    stage every (c, s) is formed first from the pivots before the stage (the
    kernel's row of coefficients), then the rotations are applied in
    ascending j, each to the columns j .. n as they are dealt over 32
    threads (thread t holds columns t, t + 32, ..).  The ring starts as NaN,
    so a read of a row never fetched shows."""
    from nlsolver_torch.linalg.givens import givens_rotation
    from nlsolver_torch.linalg.qr_parallel import backsolve_bm

    m, n, B = A.shape
    slots, Q = 2 * n + 1, -(-(n + 1) // 32)
    ring = torch.full((slots, n + 1, B), float("nan"), dtype=A.dtype)

    def fetch(r):
        ring[r % slots, :n], ring[r % slots, n] = A[r], y[r]

    fetch(m - 1)
    if m >= 2:
        fetch(m - 2)
    for k in range(m + n - 2):
        if k <= m - 3:
            fetch(m - 3 - k)
        j_lo, j_hi = max(0, k - m + 2), min(n - 1, k // 2)
        js = list(range(j_lo, j_hi + 1))
        rp = [(m - 2 - k + 2 * j) % slots for j in js]
        rq = [(m - 1 - k + 2 * j) % slots for j in js]
        cs = [givens_rotation(ring[p, j], ring[q, j]) for j, p, q in zip(js, rp, rq)]
        for j, p, q, (c, s) in zip(js, rp, rq, cs):
            cols = [t + 32 * q2 for t in range(32) for q2 in range(Q) if j <= t + 32 * q2 <= n]
            assert sorted(cols) == list(range(j, n + 1))
            vp, vq = ring[p, cols].clone(), ring[q, cols].clone()
            ring[p, cols], ring[q, cols] = c * vp + s * vq, c * vq + (-s) * vp
    return backsolve_bm(ring[:n, :n], ring[:n, n])


WARP_SHAPES = [(78, 30), (40, 35), (32, 31), (1, 1), (35, 35), (36, 35)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", WARP_SHAPES)
def test_warp_order_equals_twin(m, n, dtype):
    """The warp form's order (every rotation of a stage formed at once,
    columns dealt over 32 threads, two words a thread from n = 32) is the
    twin's bit for bit; (78, 30) is the Chebyshev fleet's system, (35, 35)
    and (36, 35) square and with one row more at two words a thread."""
    A, y = _system(7, m, n, 16, dtype)
    A[np.arange(n), np.arange(n)] += np.asarray(2 * n, dtype)
    x = warp_emulation(torch.from_numpy(A), torch.from_numpy(y))
    assert torch.equal(x, tqw.least_squares_wavefront_reference(torch.from_numpy(A),
                                                                torch.from_numpy(y)))


# the JAX kernel in interpret mode takes 17 s at (16, 16) and 150 s at
# (32, 31) on one CPU; the larger shapes reach it through the twin, which
# the tests above hold against it
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", [(1, 1), (10, 9)])
def test_warp_order_matches_jax_pallas_interpret(m, n, dtype):
    from nlsolver_tpu.ops.qr_wavefront import least_squares_wavefront_pallas

    A, y = _system(9, m, n, 16, dtype)
    A[np.arange(n), np.arange(n)] += np.asarray(2 * n, dtype)
    x = warp_emulation(torch.from_numpy(A), torch.from_numpy(y))
    jx = np.asarray(least_squares_wavefront_pallas(A, y, interpret=True))
    if dtype == np.float32:
        np.testing.assert_allclose(x.numpy(), jx, atol=1e-5)
    else:
        np.testing.assert_allclose(x.numpy(), jx, rtol=1e-12, atol=1e-13)


def cluster_emulation(A, y, C, groups=1):
    """K2b's cluster form in plain torch ops, in the kernel's order: column
    c of the ring of 2 n + 1 rows (c = n is Q^T y) lives in CTA c % C at
    local column c // C, each CTA's ring starting as NaN so that a read of a
    word never fetched shows; a CTA fetches only its own columns of a row, a
    stage ahead.  At each stage the owner of pivot column j forms (c, s)
    from its own ring and stores it into the coefficient row of stage
    parity k % 2 of every CTA; then every CTA turns its own columns col >=
    j by the stage's rotations read from its own coefficient row, the
    rotations dealt over ``groups`` groups of threads (g takes j_lo + g,
    j_lo + g + groups, ..).  The back-substitution gathers row i's entries i
    .. n from every CTA's ring row i and runs the twin's chain on them."""
    from nlsolver_torch.linalg.givens import givens_rotation

    m, n, B = A.shape
    slots, Lc = 2 * n + 1, -(-(n + 1) // C)
    rings = [torch.full((slots, Lc, B), float("nan"), dtype=A.dtype) for _ in range(C)]
    coef = [torch.full((2, 2 * n, B), float("nan"), dtype=A.dtype) for _ in range(C)]
    mine = [[c for c in range(k, n + 1, C)] for k in range(C)]

    def fetch(r):
        for k in range(C):
            for c in mine[k]:
                rings[k][r % slots, c // C] = A[r, c] if c < n else y[r]

    fetch(m - 1)
    if m >= 2:
        fetch(m - 2)
    for k in range(m + n - 2):
        if k <= m - 3:
            fetch(m - 3 - k)
        j_lo, j_hi = max(0, k - m + 2), min(n - 1, k // 2)
        s0 = (m - 2 - k) % slots
        for j in range(j_lo, j_hi + 1):
            ring = rings[j % C]
            rp = (s0 + 2 * j) % slots
            cs = givens_rotation(ring[rp, j // C], ring[(rp + 1) % slots, j // C])
            for buf in coef:
                buf[k % 2, 2 * j], buf[k % 2, 2 * j + 1] = cs
        for kk in range(C):
            ring, buf = rings[kk], coef[kk]
            for g in range(groups):
                for j in range(j_lo + g, j_hi + 1, groups):
                    cols = [c // C for c in mine[kk] if c >= j]
                    if not cols:
                        continue
                    rp = (s0 + 2 * j) % slots
                    rq = (rp + 1) % slots
                    c, s = buf[k % 2, 2 * j], buf[k % 2, 2 * j + 1]
                    vp, vq = ring[rp, cols].clone(), ring[rq, cols].clone()
                    ring[rp, cols], ring[rq, cols] = c * vp + s * vq, c * vq + (-s) * vp
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        row = {col: rings[col % C][i, col // C] for col in range(i, n + 1)}
        acc = row[n]
        for col in range(i + 1, n):
            acc = acc - row[col] * xs[col]
        xs[i] = acc / row[i]
    return torch.stack(xs, dim=0)


# square and with one row more, one and two rows of the cluster's CTAs
# short of a column (n + 1 no multiple of C), n < C, m = n = 1
CLUSTER_SHAPES = [(12, 9), (20, 17), (9, 9), (10, 9), (1, 1), (5, 4), (3, 2)]


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("C,groups", [(2, 1), (4, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", CLUSTER_SHAPES)
def test_cluster_order_equals_twin(m, n, dtype, C, groups, deficient):
    """K2b-c's order (columns interleaved over C CTAs, each stage's
    coefficients formed by the pivots' owners into every CTA's row of the
    stage's parity, the rotations dealt over groups of threads, the
    back-substitution on gathered rows) is the twin's bit for bit; a zero
    column makes a = b = 0, the identity select."""
    A, y = _system(13, m, n, 16, dtype)
    A[np.arange(n), np.arange(n)] += np.asarray(2 * n, dtype)
    A, y = torch.from_numpy(A), torch.from_numpy(y)
    if deficient and n > 1:
        A[:, n // 2] = 0.0
    x = cluster_emulation(A, y, C, groups)
    # a zero column leaves R singular: x holds infinities and NaNs, each where the twin's are
    torch.testing.assert_close(x, tqw.least_squares_wavefront_reference(A, y), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", [(1, 1), (10, 9)])
def test_cluster_order_matches_jax_pallas_interpret(m, n, dtype, C):
    from nlsolver_tpu.ops.qr_wavefront import least_squares_wavefront_pallas

    A, y = _system(9, m, n, 16, dtype)
    A[np.arange(n), np.arange(n)] += np.asarray(2 * n, dtype)
    x = cluster_emulation(torch.from_numpy(A), torch.from_numpy(y), C)
    jx = np.asarray(least_squares_wavefront_pallas(A, y, interpret=True))
    if dtype == np.float32:
        np.testing.assert_allclose(x.numpy(), jx, atol=1e-5)
    else:
        np.testing.assert_allclose(x.numpy(), jx, rtol=1e-12, atol=1e-13)


def test_cluster_limits():
    """K2b-c's range, worked out from 232448 bytes a CTA: (2 n + 1)
    ceil((n + 1) / C) words of ring and 4 n + 2 of coefficients, C of 2, 4 and 8
    (2 up to n = 237 in f32 and 167 in f64, 4 to 335 and 235, 8 to 471 and
    329); a multiple of 32 column threads that covers CTA 0's columns; the
    plan's C the one that runs the most lanes at once, grown for few
    lanes."""
    f32, f64 = torch.float32, torch.float64
    assert tqw.cluster_bytes(120, f64, 2) == (241 * 61 + 482) * 8
    for dtype, ends in ((f32, (237, 335, 471)), (f64, (167, 235, 329))):
        for size, last in zip((2, 4, 8), ends):
            assert tqw.cluster_bytes(last, dtype, size) <= 232448 < \
                tqw.cluster_bytes(last + 1, dtype, size)
        assert tqw.cluster_fits(ends[-1], dtype) and not tqw.cluster_fits(ends[-1] + 1, dtype)
        assert tqw.cluster_plan(ends[-1] + 1, dtype) == (0, 0)
        for n in range(1, ends[-1] + 1):
            C, T = tqw.cluster_plan(n, dtype)
            assert tqw.cluster_bytes(n, dtype, C) <= 232448
            assert T % 32 == 0 and T - 32 < -(-(n + 1) // C) <= T
            assert all(tqw.cluster_lanes(n, dtype, C) >= tqw.cluster_lanes(n, dtype, c)
                       for c in (2, 4, 8) if tqw.cluster_bytes(n, dtype, c) <= 232448)
    # the float64 fleet's [248, 120, 256]: 66, 99 and 99 lanes at once
    assert [tqw.cluster_lanes(120, f64, c) for c in (2, 4, 8)] == [66, 99, 99]
    assert tqw.cluster_plan(120, f64, 256) == (4, 32) == tqw.cluster_plan(120, f64)
    assert tqw.cluster_plan(120, f64, 16) == (8, 32) and tqw.cluster_plan(120, f64, 33) == (4, 32)
    assert tqw.cluster_plan(471, f32) == (8, 64) and tqw.cluster_plan(237, f32) == (2, 128)
    assert tqw.cluster_plan(4, torch.float16) == (0, 0) and tqw.cluster_plan(0, f32) == (0, 0)


def distributed_emulation(A, y, P, groups=1):
    """K2b's distributed form in plain torch ops, in the kernel's order:
    column c of the ring (c = n is Q^T y) in CTA c % P at local column c //
    P, each CTA's ring starting as NaN; a CTA fetches only its own columns
    of a row, a stage ahead.  At each stage the owner of pivot column j
    forms (c, s) from its own ring into the team's coefficient row of
    parity k % 2 in device memory (NaN until written); past the barrier
    every CTA copies the stage's pairs j_lo .. j_hi into its own shared row
    (NaN elsewhere) and turns its own columns col >= j by them, the
    rotations dealt over ``groups`` groups of threads.  After the last
    stage each CTA stores its columns of R's rows 0 .. n - 1 into the
    team's store (NaN until written), and the back-substitution reads the
    store in the twin's order."""
    from nlsolver_torch.linalg.givens import givens_rotation

    m, n, B = A.shape
    nan = float("nan")
    slots, Lc = 2 * n + 1, -(-(n + 1) // P)
    rings = [torch.full((slots, Lc, B), nan, dtype=A.dtype) for _ in range(P)]
    coef = torch.full((2, 2 * n, B), nan, dtype=A.dtype)
    mine = [[c for c in range(k, n + 1, P)] for k in range(P)]

    def fetch(r):
        for k in range(P):
            for c in mine[k]:
                rings[k][r % slots, c // P] = A[r, c] if c < n else y[r]

    fetch(m - 1)
    if m >= 2:
        fetch(m - 2)
    for k in range(m + n - 2):
        if k <= m - 3:
            fetch(m - 3 - k)
        j_lo, j_hi = max(0, k - m + 2), min(n - 1, k // 2)
        s0 = (m - 2 - k) % slots
        coef[k % 2] = nan  # what the stage before left there is never read
        for j in range(j_lo, j_hi + 1):
            ring = rings[j % P]
            rp = (s0 + 2 * j) % slots
            coef[k % 2, 2 * j], coef[k % 2, 2 * j + 1] = givens_rotation(
                ring[rp, j // P], ring[(rp + 1) % slots, j // P])
        for kk in range(P):
            ring = rings[kk]
            cs = torch.full((2 * n, B), nan, dtype=A.dtype)
            cs[2 * j_lo:2 * j_hi + 2] = coef[k % 2, 2 * j_lo:2 * j_hi + 2]
            for g in range(groups):
                for j in range(j_lo + g, j_hi + 1, groups):
                    cols = [c // P for c in mine[kk] if c >= j]
                    if not cols:
                        continue
                    rp = (s0 + 2 * j) % slots
                    rq = (rp + 1) % slots
                    c, s = cs[2 * j], cs[2 * j + 1]
                    vp, vq = ring[rp, cols].clone(), ring[rq, cols].clone()
                    ring[rp, cols], ring[rq, cols] = c * vp + s * vq, c * vq + (-s) * vp
    store = torch.full((n, n + 1, B), nan, dtype=A.dtype)
    for kk in range(P):
        for c in mine[kk]:
            for i in range(min(c, n - 1) + 1):
                store[i, c] = rings[kk][i, c // P]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        acc = store[i, n]
        for col in range(i + 1, n):
            acc = acc - store[i, col] * xs[col]
        xs[i] = acc / store[i, i]
    return torch.stack(xs, dim=0)


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("P,groups", [(3, 1), (5, 3), (12, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", CLUSTER_SHAPES)
def test_distributed_order_equals_twin(m, n, dtype, P, groups, deficient):
    """K2b-d's order (columns interleaved over 3, 5 and 12 CTAs, more than a
    cluster holds and not a power of two; each stage's coefficients through
    the team's row of the stage's parity in device memory, copied by every
    CTA past the barrier; the rotations dealt over groups of threads; the
    back-substitution from the store) is the twin's bit for bit; a zero
    column makes a = b = 0, the identity select."""
    A, y = _system(17, m, n, 8, dtype)
    A[np.arange(n), np.arange(n)] += np.asarray(2 * n, dtype)
    A, y = torch.from_numpy(A), torch.from_numpy(y)
    if deficient and n > 1:
        A[:, n // 2] = 0.0
    x = distributed_emulation(A, y, P, groups)
    torch.testing.assert_close(x, tqw.least_squares_wavefront_reference(A, y), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_distributed_order_matches_jax_pallas_interpret(dtype):
    from nlsolver_tpu.ops.qr_wavefront import least_squares_wavefront_pallas

    A, y = _system(10, 11, 9, 16, dtype)
    A[np.arange(9), np.arange(9)] += np.asarray(18, dtype)
    x = distributed_emulation(torch.from_numpy(A), torch.from_numpy(y), 5)
    jx = np.asarray(least_squares_wavefront_pallas(A, y, interpret=True))
    if dtype == np.float32:
        np.testing.assert_allclose(x.numpy(), jx, atol=1e-5)
    else:
        np.testing.assert_allclose(x.numpy(), jx, rtol=1e-12, atol=1e-13)


def test_distributed_limits():
    """K2b-d's range, worked out from 232448 bytes a CTA: (2 n + 1)
    ceil((n + 1) / P) words of ring and 3 n + 2 of coefficients (or the
    back-substitution's), P up to the card's 132 SMs: from the end of
    K2b-c's range to n = 1847 in f32 and 1262 in f64; the plan takes the
    fewest CTAs that hold the ring, spread over the card's SMs where few
    lanes leave them idle; about 256 threads a CTA, at least two warps."""
    f32, f64 = torch.float32, torch.float64
    assert tqw.distributed_bytes(330, f64, 66) == (661 * 6 + 992) * 8
    for dtype, (first, last) in ((f32, (472, 1847)), (f64, (330, 1262))):
        assert not tqw.cluster_fits(first, dtype) and tqw.cluster_fits(first - 1, dtype)
        assert tqw.distributed_fits(first, dtype) and tqw.distributed_fits(last, dtype)
        assert not tqw.distributed_fits(last + 1, dtype)
        assert tqw.distributed_least(last + 1, dtype) == 0
        assert tqw.distributed_bytes(last, dtype, 132) <= 232448 < \
            tqw.distributed_bytes(last + 1, dtype, 132)
        for n in range(1, last + 1, 13):
            P = tqw.distributed_least(n, dtype)
            assert tqw.distributed_bytes(n, dtype, P) <= 232448
            assert P == 1 or tqw.distributed_bytes(n, dtype, P - 1) > 232448
            G = tqw.distributed_groups(n, P)
            columns = -(-(n + 1) // P)
            assert 64 <= columns * G <= 1024 and (columns * G <= 256 or columns * G < 64 + columns)
        assert not tqw.distributed_fits(last, dtype, sms=100)
    # the path's [330, 330, 2] in f64: 66 CTAs of 6 columns and 42 groups
    assert tqw.distributed_least(330, f64) == 8 and tqw.distributed_least(472, f32) == 9
    assert [tqw.distributed_plan(330, f64, lanes) for lanes in (1, 2, 3, 16, 17, 64)] == \
        [132, 66, 44, 8, 8, 8]
    assert tqw.distributed_groups(330, 66) == 42 and tqw.distributed_groups(1, 2) == 256
    assert tqw.distributed_plan(2, f64, 1) == 3 and tqw.distributed_plan(1263, f64, 2) == 0
    assert tqw.distributed_plan(4, torch.float16) == 0 and tqw.distributed_plan(0, f32) == 0


def test_window_order_edges():
    # m = n = 1 has no stage; m = n + 1 and square m = n end where the
    # window's last rows are the system's first
    for m, n in ((1, 1), (2, 1), (4, 3), (6, 6)):
        A, y = (torch.from_numpy(a) for a in _system(5, m, n, 17))
        assert torch.equal(window_emulation(A, y), tqw.least_squares_wavefront_reference(A, y))


def test_form_limits():
    f32, f64 = torch.float32, torch.float64
    assert [n for n in range(1, 40) if tqw.registers_fit(n, f32)] == list(range(1, 9))
    assert [n for n in range(1, 40) if tqw.registers_fit(n, f64)] == list(range(1, 6))
    assert [n for n in range(1, 40) if tqw.shared_fits(n, f32)] == list(range(1, 30))
    assert [n for n in range(1, 40) if tqw.shared_fits(n, f64)] == list(range(1, 21))
    assert not tqw.registers_fit(2, torch.float16) and not tqw.shared_fits(2, torch.float16)
    assert tqw.shared_bytes(29, f32) <= 232448 < tqw.shared_bytes(30, f32)
    # the warp form: one warp's ring of (2 n + 1)(n + 1) words and its 2 n
    # coefficients in a block; 8 lanes a block, halved where they do not fit
    assert [n for n in range(1, 300) if tqw.warp_fits(n, f32)] == list(range(1, 170))
    assert [n for n in range(1, 300) if tqw.warp_fits(n, f64)] == list(range(1, 120))
    assert tqw.warp_bytes(169, f32) == (339 * 170 + 338) * 4 <= 232448 < tqw.warp_bytes(170, f32)
    assert tqw.warp_bytes(119, f64) == (239 * 120 + 238) * 8 <= 232448 < tqw.warp_bytes(120, f64)
    assert not tqw.warp_fits(2, torch.float16) and not tqw.warp_fits(0, f32)
    for dtype, edges in ((f32, (59, 60, 83, 84, 119, 120)), (f64, (41, 42, 59, 60, 83, 84))):
        assert [tqw.warp_lanes(n, dtype) for n in edges] == [8, 4, 4, 2, 2, 1]
        assert all(tqw.warp_lanes(n, dtype) * tqw.warp_bytes(n, dtype) <= 232448
                   for n in range(1, 170) if tqw.warp_fits(n, dtype))
    # the dispatcher's ranges on square systems: five by n and dtype alone,
    # then K2b-p as far as a CTA holds a column (tests/test_torch_lstsq_panel.py)
    for dtype, ends in ((f32, (8, 29, 169, 471, 1847)), (f64, (5, 20, 119, 329, 1262))):
        forms = [tqw.least_squares_form(n, n, dtype) for n in range(1, 2000)]
        want = ["registers"] * ends[0] + ["shared"] * (ends[1] - ends[0]) + \
            ["warp"] * (ends[2] - ends[1]) + ["cluster"] * (ends[3] - ends[2]) + \
            ["distributed"] * (ends[4] - ends[3]) + ["panel"] * (1999 - ends[4])
        assert forms == want
        # the edges: the last n of K2b-w, the first and last of K2b-c and of
        # K2b-d, the first of K2b-p
        assert [tqw.least_squares_form(n, n, dtype) for n in (ends[2], ends[2] + 1, ends[3],
                                                               ends[3] + 1, ends[4],
                                                               ends[4] + 1)] == \
            ["warp", "cluster", "cluster", "distributed", "distributed", "panel"]


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


def _form_cases():
    """(form, m, n, dtype): each K2b form at the first and last n it takes
    (the distributed form at the first n past the cluster one's; the global
    form there too, by direct call), at square m = n and at m = n + 1, and
    at the NLLS fleet's [34, 2]."""
    cases = []
    for dtype, reg, shared, warp, cluster in ((torch.float32, 8, 29, 169, 471),
                                              (torch.float64, 5, 20, 119, 329)):
        for form, ns in (("registers", (1, reg)), ("shared", (reg + 1, shared)),
                         ("warp", (shared + 1, warp)), ("cluster", (warp + 1, cluster)),
                         ("distributed", (cluster + 1,))):
            cases += [(form, m, n, dtype) for n in ns for m in (n, n + 1)]
        cases.append(("registers", 34, 2, dtype))
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("form,m,n,dtype", _form_cases())
def test_each_form_bit_equal_to_twin_on_card(form, m, n, dtype):
    dev = _on_card()
    A, y = (torch.from_numpy(a).to(dev, dtype) for a in _system(6, m, n, 300))
    kernel = getattr(tqw, f"least_squares_wavefront_{form}")
    before = kernel.launches
    x = tqw.least_squares_wavefront_kernel(A, y)  # the dispatcher's choice
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(x, tqw.least_squares_wavefront_reference(A, y))
    # every form that takes n gives the same bits
    takes = {tqw.least_squares_wavefront_registers: tqw.registers_fit,
             tqw.least_squares_wavefront_shared: tqw.shared_fits,
             tqw.least_squares_wavefront_warp: tqw.warp_fits,
             tqw.least_squares_wavefront_cluster: tqw.cluster_fits,
             tqw.least_squares_wavefront_distributed: tqw.distributed_fits}
    for other in LSTSQ_FORMS:
        if takes.get(other, lambda n, dtype: True)(n, dtype):
            assert torch.equal(other(A, y), x)


@pytest.mark.gpu
def test_forms_refuse_what_they_do_not_take_on_card():
    dev = _on_card()
    A, y = torch.randn(12, 9, 64, device=dev), torch.randn(12, 64, device=dev)
    with pytest.raises(ValueError, match="registers"):
        tqw.least_squares_wavefront_registers(A, y)
    A, y = torch.randn(32, 30, 64, device=dev), torch.randn(32, 64, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        tqw.least_squares_wavefront_shared(A, y)
    x = tqw.least_squares_wavefront_kernel(A[:, :, :0].contiguous(), y[:, :0].contiguous())
    assert x.shape == (30, 0)
    A, y = torch.randn(170, 170, 4, device=dev), torch.randn(170, 4, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        tqw.least_squares_wavefront_warp(A, y)
    A, y = torch.randn(472, 472, 2, device=dev), torch.randn(472, 2, device=dev)
    with pytest.raises(ValueError, match="cluster"):
        tqw.least_squares_wavefront_cluster(A, y)
    with pytest.raises(ValueError, match="cluster"):
        tqw.least_squares_wavefront_cluster(A[:400, :400].contiguous(), y[:400].contiguous(),
                                            size=4)
    with pytest.raises(ValueError, match="CTAs' shared memory"):
        tqw.least_squares_wavefront_distributed(A, y, size=tqw.distributed_least(472, A.dtype) - 1)
    # past K2b-d's range the dispatcher names K2b-p and K2b-d refuses
    A, y = torch.zeros(1263, 1263, 2, device=dev, dtype=torch.float64), torch.zeros(
        1263, 2, device=dev, dtype=torch.float64)
    assert tqw.least_squares_form(1263, 1263, torch.float64) == "panel"
    with pytest.raises(ValueError, match="CTAs' shared memory"):
        tqw.least_squares_wavefront_distributed(A, y)


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,B", [(78, 30, 4096), (40, 35, 333), (9, 9, 5), (21, 21, 70)])
def test_warp_form_bit_equal_with_every_block_on_card(dtype, m, n, B):
    """K2b-w on the Chebyshev fleet's [78, 30, 4096], at two words a thread
    (n = 35), inside the shared form's range and at f64's first n, with 1,
    2, 4 and 8 lanes a block and a ragged last block: the twin's bits."""
    dev = _on_card()
    A, y = (torch.from_numpy(a).to(dev, dtype) for a in _system(8, m, n, B))
    twin = tqw.least_squares_wavefront_reference(A, y)
    for lanes in (1, 2, 4, 8):
        before = tqw.least_squares_wavefront_warp.launches
        x = tqw.least_squares_wavefront_warp(A, y, lanes=lanes)
        torch.cuda.synchronize()
        assert tqw.least_squares_wavefront_warp.launches == before + 1
        assert torch.equal(x, twin), lanes


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,n,B", [(248, 120, 256), (170, 170, 33), (9, 9, 5), (40, 35, 70)])
def test_cluster_form_bit_equal_with_every_plan_on_card(dtype, m, n, B):
    """K2b-c on the f64 Chebyshev fleet's [248, 120, 256], at f32's first n,
    and inside the warp form's range, with every cluster size that holds the
    ring and 1, 2, 4 and 8 groups of threads: the twin's bits."""
    dev = _on_card()
    A, y = (torch.from_numpy(a).to(dev, dtype) for a in _system(14, m, n, B))
    twin = tqw.least_squares_wavefront_reference(A, y)
    for size in (2, 4, 8):
        if tqw.cluster_bytes(n, dtype, size) > 232448:
            continue
        for groups in (1, 2, 4, 8):
            if tqw.cluster_columns(n, size) * groups < 64:
                continue  # the back-substitution takes two warps
            before = tqw.least_squares_wavefront_cluster.launches
            x = tqw.least_squares_wavefront_cluster(A, y, size=size, _groups=groups)
            torch.cuda.synchronize()
            assert tqw.least_squares_wavefront_cluster.launches == before + 1
            assert torch.equal(x, twin), (size, groups)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,n,B", [(330, 330, 2), (473, 472, 2), (400, 400, 64), (20, 17, 5),
                                   (40, 35, 70)])
def test_distributed_form_bit_equal_with_every_plan_on_card(dtype, m, n, B):
    """K2b-d at f64's path [330, 330, 2], at f32's first n with one row
    more, on 64 lanes (several waves of teams) and below its range, a zero
    column in the last two, with 3, 5, 12, 66 and 132 CTAs a lane where they
    hold the ring, and half, the plan's and twice the plan's groups of
    threads at the plan's P: the twin's bits."""
    dev = _on_card()
    A, y = (torch.from_numpy(a).to(dev, dtype) for a in _system(15, m, n, B))
    if n < 64:
        A[:, n // 2] = 0.0
    twin = tqw.least_squares_wavefront_reference(A, y)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    least, plan = tqw.distributed_least(n, dtype, sms), tqw.distributed_plan(n, dtype, B, sms)
    if not least:
        pytest.skip(f"n={n} does not fit {sms} CTAs in {dtype}")
    for size in sorted({least, plan, 3, 5, 12, 66, 132}):
        if size < least or size > sms:
            continue
        G, columns = tqw.distributed_groups(n, size), -(-(n + 1) // size)
        for groups in ({G // 2, G, 2 * G} if size == plan else {G}):
            if not 64 <= groups * columns <= 1024:
                continue
            before = tqw.least_squares_wavefront_distributed.launches
            x = tqw.least_squares_wavefront_distributed(A, y, size=size, _groups=groups)
            torch.cuda.synchronize()
            assert tqw.least_squares_wavefront_distributed.launches == before + 1
            torch.testing.assert_close(x, twin, rtol=0, atol=0, equal_nan=True,
                                       msg=f"P={size}, G={groups}")


def test_backward_branches_find_nested_loops():
    """The loops that K2b-w's issue floor tells apart (``chip_smoke.py``): a
    stage loop holding a barrier and, inside it, a loop that stores to
    shared memory; a branch forward and one past the body are no loops."""
    from nlsolver_torch.benches import backward_branches, branch_targets, issue_instructions

    sass = ["S2R R0, SR_TID.X", "@P0 BRA 0xa0", "LDS R1, [R0]", "FMUL R1, R1, R1",
            "STS [R0], R1", "@P1 BRA 0x20", "BAR.SYNC.DEFER_BLOCKING 0x0", "@P2 BRA 0x10",
            "BRA 0x400", "EXIT", "STG.E [R2.64], R1", "EXIT"]
    ins = [(16 * i, op) for i, op in enumerate(sass)]
    assert branch_targets(ins) == [None, 10, None, None, None, 2, None, 1, None, None, None, None]
    assert backward_branches(ins) == [(2, 5), (1, 7)]
    way, bodies = issue_instructions(ins)
    # the way jumps past both loops; a pass of the inner loop is its 4
    # instructions, of the outer its guard, one pass of the inner loop, the
    # barrier and its own branch
    assert (way, bodies) == (4, [4, 7])


def _qr_warp_cases():
    """(m, n, B, dtype, compute_q): the timed [16, 16, 4096] and [32, 8,
    4096], and K2a-w's last square shape and last shape with one row more
    in float32 and float64, with and without Q."""
    cases = [(16, 16, 4096, torch.float32, True), (32, 8, 4096, torch.float32, True),
             (16, 16, 1001, torch.float64, False)]
    for dtype, q, square, tall in ((torch.float32, True, 169, 169), (torch.float64, True, 120, 119),
                                   (torch.float32, False, 240, 239),
                                   (torch.float64, False, 169, 168)):
        cases += [(square, square, 33, dtype, q), (tall + 1, tall, 33, dtype, q)]
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,B,dtype,compute_q", _qr_warp_cases())
def test_qr_warp_form_bit_equal_to_twin_on_card(m, n, B, dtype, compute_q):
    """K2a-w, the dispatcher's choice up to its edges, with a zero column:
    the twin's R and Q bit for bit."""
    dev = _on_card()
    A = torch.from_numpy(_system(11, m, n, B)[0]).to(dev, dtype)
    A[:, n // 2] = 0.0
    before = tqw.qr_wavefront_warp.launches
    R, Q = tqw.qr_wavefront_kernel(A, compute_q=compute_q)
    torch.cuda.synchronize()
    assert tqw.qr_wavefront_warp.launches == before + 1
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
    assert torch.equal(R, tR) and (not compute_q or torch.equal(Q, tQ))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,dtype", [(170, 170, torch.float32), (171, 170, torch.float32),
                                       (121, 121, torch.float64), (121, 120, torch.float64)])
def test_qr_global_form_past_the_warp_form_on_card(m, n, dtype):
    """K2a in device memory, by a direct call, where K2a-w's array no longer
    fits (with Q) and the dispatcher hands the shape to K2a-c: the twin's
    bits."""
    dev = _on_card()
    A = torch.from_numpy(_system(12, m, n, 32)[0]).to(dev, dtype)
    assert tqw.qr_form(m, n, dtype, True) == "cluster"
    before = tqw.qr_wavefront_global.launches
    R, Q = tqw.qr_wavefront_global(A, compute_q=True)
    torch.cuda.synchronize()
    assert tqw.qr_wavefront_global.launches == before + 1
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q=True)
    assert torch.equal(R, tR) and torch.equal(Q, tQ)


def _qr_form_edges(form, dtype, compute_q):
    """(m, n): the first and last square shapes that the dispatcher gives
    K2a's ``form``, and its first and last with one row more."""
    hi = QR_DISTRIBUTED_END[dtype, compute_q] + 2
    square = [n for n in range(1, hi) if tqw.qr_form(n, n, dtype, compute_q) == form]
    tall = [n for n in range(1, hi) if tqw.qr_form(n + 1, n, dtype, compute_q) == form]
    return [(square[0], square[0]), (square[-1], square[-1]), (tall[0] + 1, tall[0]),
            (tall[-1] + 1, tall[-1])]


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["cluster", "distributed"])
@pytest.mark.parametrize("dtype,compute_q", list(QR_DISTRIBUTED_END))
def test_qr_spread_forms_at_their_edges_on_card(form, dtype, compute_q):
    """K2a-c on 32 lanes and K2a-d on 2, through the dispatcher, at the
    first and last square shapes of their ranges and with one row more, a
    zero column among the random ones: one launch each, the twin's R and Q
    bit for bit."""
    dev = _on_card()
    kernel = getattr(tqw, f"qr_wavefront_{form}")
    B = 32 if form == "cluster" else 2
    for m, n in _qr_form_edges(form, dtype, compute_q):
        A = torch.from_numpy(_system(21, m, n, B)[0]).to(dev, dtype)
        A[:, n // 2] = 0.0
        before = kernel.launches
        R, Q = tqw.qr_wavefront_kernel(A, compute_q=compute_q)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, (m, n)
        tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
        assert torch.equal(R, tR) and (not compute_q or torch.equal(Q, tQ)), (m, n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,B,compute_q", [(170, 170, 32, True), (171, 170, 33, True),
                                             (9, 9, 5, True), (40, 35, 70, False),
                                             (121, 121, 7, True)])
def test_qr_cluster_form_bit_equal_with_every_plan_on_card(m, n, B, compute_q, dtype):
    """K2a-c at linalg.qr's [170, 170, 32], with one row more on a ragged
    B, below the warp form's edge and at float64's first shape, a zero
    column below n = 64, with every cluster size that holds the array and
    1, 2, 4 and 8 groups of threads: the twin's bits."""
    dev = _on_card()
    A = torch.from_numpy(_system(22, m, n, B)[0]).to(dev, dtype)
    if n < 64:
        A[:, n // 2] = 0.0
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
    for size in (2, 4, 8):
        if tqw.qr_cluster_bytes(m, n, dtype, compute_q, size) > 232448:
            continue
        for groups in (1, 2, 4, 8):
            if tqw.qr_cluster_columns(m, n, compute_q, size) * groups > 1024:
                continue
            before = tqw.qr_wavefront_cluster.launches
            R, Q = tqw.qr_wavefront_cluster(A, compute_q, size=size, _groups=groups)
            torch.cuda.synchronize()
            assert tqw.qr_wavefront_cluster.launches == before + 1
            assert torch.equal(R, tR) and (not compute_q or torch.equal(Q, tQ)), (size, groups)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,n,B,compute_q", [(333, 333, 2, True), (473, 472, 2, True),
                                             (200, 180, 64, True), (20, 17, 5, False),
                                             (40, 35, 70, True)])
def test_qr_distributed_form_bit_equal_with_every_plan_on_card(m, n, B, compute_q, dtype):
    """K2a-d at float64's path [333, 333, 2], at float32's first shape with
    one row more, on 64 lanes (several lanes a team) and below its range, a
    zero column below n = 64, with 3, 5, 12, 66 and 132 CTAs a lane where
    they hold the array, and half, the plan's and twice the plan's groups of
    threads at the plan's P: the twin's bits."""
    dev = _on_card()
    A = torch.from_numpy(_system(23, m, n, B)[0]).to(dev, dtype)
    if n < 64:
        A[:, n // 2] = 0.0
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    least = tqw.qr_distributed_least(m, n, dtype, compute_q, sms)
    plan = tqw.qr_distributed_plan(m, n, dtype, compute_q, B, sms)
    for size in sorted({least, plan, 3, 5, 12, 66, 132}):
        if size < least or size > sms:
            continue
        G = tqw.qr_distributed_groups(m, n, compute_q, size)
        columns = -(-tqw.qr_columns(m, n, compute_q) // size)
        for groups in ({max(1, G // 2), G, 2 * G} if size == plan else {G}):
            if groups * columns > 1024:
                continue
            before = tqw.qr_wavefront_distributed.launches
            R, Q = tqw.qr_wavefront_distributed(A, compute_q, size=size, _groups=groups)
            torch.cuda.synchronize()
            assert tqw.qr_wavefront_distributed.launches == before + 1
            assert torch.equal(R, tR) and (not compute_q or torch.equal(Q, tQ)), (size, groups)


@pytest.mark.gpu
def test_qr_spread_forms_refuse_what_they_do_not_take_on_card():
    dev = _on_card()
    A = torch.zeros(473, 473, 2, device=dev)
    with pytest.raises(ValueError, match="cluster"):
        tqw.qr_wavefront_cluster(A, compute_q=True)
    with pytest.raises(ValueError, match="cluster of 2"):
        tqw.qr_wavefront_cluster(A[:240, :240].contiguous(), compute_q=True, size=2)
    with pytest.raises(ValueError, match="CTAs' shared memory"):
        tqw.qr_wavefront_distributed(A, compute_q=True,
                                     size=tqw.qr_distributed_least(473, 473, A.dtype, True) - 1)
    # past K2a-d's range the dispatcher names K2a-p and K2a-d refuses
    A = torch.zeros(1321, 1321, 1, device=dev, dtype=torch.float64)
    assert tqw.qr_form(1321, 1321, torch.float64, True) == "panel"
    with pytest.raises(ValueError, match="qr_wavefront_panel takes it"):
        tqw.qr_wavefront_distributed(A, compute_q=True)
    R, Q = tqw.qr_wavefront_cluster(torch.zeros(200, 200, 0, device=dev), compute_q=True)
    assert R.shape == (200, 200, 0) and Q.shape == (200, 200, 0)


@pytest.mark.gpu
def test_qr_warp_form_refuses_what_it_does_not_take_on_card():
    dev = _on_card()
    A = torch.randn(16, 16, 64, device=dev)
    with pytest.raises(ValueError, match="float32 or float64"):
        tqw.qr_wavefront_warp(A.half(), compute_q=True)
    with pytest.raises(ValueError, match="contiguous"):
        tqw.qr_wavefront_warp(A.transpose(0, 1), compute_q=True)
    with pytest.raises(ValueError, match="shared memory"):
        tqw.qr_wavefront_warp(torch.zeros(170, 170, 4, device=dev), compute_q=True)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,B,dtype,compute_q", [
    (1875, 1875, 2, torch.float32, True), (1321, 1321, 2, torch.float64, True),
    (2641, 2641, 1, torch.float32, False), (1817, 1817, 1, torch.float64, False),
    (1849, 1849, 1, torch.float64, True)])
def test_qr_panel_form_at_its_first_shapes_on_card(m, n, B, dtype, compute_q):
    """K2a-p through the dispatcher at the first square shapes of its range
    with and without Q, and at the first of two panels in float64: each of
    its kernels counted (``qr_panel_launches``), no other form's, the twin's
    R and Q bit for bit."""
    dev = _on_card()
    A = torch.from_numpy(_system(26, m, n, B)[0]).to(dev, dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    before = _counts()
    R, Q = tqw.qr_wavefront_kernel(A, compute_q=compute_q)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    want = tqw.qr_panel_launches(m, n, dtype, compute_q, sms)
    assert launched == [want * (f is tqw.qr_wavefront_panel) for f in QR_FORMS + LSTSQ_FORMS]
    tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
    assert torch.equal(R, tR) and (not compute_q or torch.equal(Q, tQ))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,n,B,width", [(12, 12, 4, 4), (20, 13, 3, 5), (333, 333, 2, 100),
                                         (300, 200, 5, 64), (40, 33, 70, 7), (7, 5, 9, 1)])
def test_qr_panel_form_with_small_panels_on_card(m, n, B, width, dtype):
    """K2a-p with forced small panels (the earlier panels' replay of the log
    at every stage before their first pivot, and their second phase), on
    more lanes than a team, a zero column below n = 64, with and without Q,
    and with a CTA a column where the card holds that many: the twin's
    bits."""
    dev = _on_card()
    A = torch.from_numpy(_system(27, m, n, B)[0]).to(dev, dtype)
    if n < 64:
        A[:, n // 2] = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for compute_q in (True, False):
        tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
        want = tqw.qr_panel_launches(m, n, dtype, compute_q, sms, width)
        for size in (None, min(width, 132)):
            before = tqw.qr_wavefront_panel.launches
            R, Q = tqw.qr_wavefront_panel(A, compute_q, size=size, _width=width)
            torch.cuda.synchronize()
            assert tqw.qr_wavefront_panel.launches == before + want
            assert torch.equal(R, tR) and (not compute_q or torch.equal(Q, tQ)), (compute_q, size)


@pytest.mark.gpu
def test_qr_panel_form_refuses_what_it_does_not_take_on_card():
    dev = _on_card()
    with pytest.raises(ValueError, match="qr_wavefront_global takes it"):
        tqw.qr_wavefront_panel(torch.zeros(29100, 1, 1, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="CTAs' shared memory"):
        tqw.qr_wavefront_panel(torch.zeros(1875, 1875, 1, device=dev), size=60)
    R, Q = tqw.qr_wavefront_panel(torch.zeros(200, 200, 0, device=dev), compute_q=True)
    assert R.shape == (200, 200, 0) and Q.shape == (200, 200, 0)
