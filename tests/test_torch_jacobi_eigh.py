"""The parallel-order Jacobi eigensolver of nlsolver_torch (``linalg.jacobi``,
``linalg.eigh_qr``, ``ops.eigh_jacobi``) against nlsolver_tpu: the schedule,
the rotation, ``eigh_jacobi`` against the jnp Jacobi and against the Pallas
kernel in interpret mode (f64), the ``eigh`` dispatcher, the seating plan of
the kernel's register form and an emulation of its data movement, the
kernel's shared-memory plan, the cluster form's plan and an emulation of its
ownership of rows, the device-memory form's plan over the whole card and an
emulation of its phases, the shapes refused, and the four forms of kernel
K5 against their twin (on a card only).

Tolerances: eigenvalues rtol 1e-12 (relative to the largest), eigenvectors
atol 1e-10: the two packages run the same operations in the same order, and
differ where PyTorch's CPU sqrt is an ulp off XLA's, over 10 sweeps.

JAX is imported only inside the tests that compare with it, so that the
card's tests run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_jacobi_eigh.py
"""
import numpy as np
import pytest
import torch

from nlsolver_torch import linalg as tl
from nlsolver_torch.linalg import jacobi as tj
from nlsolver_torch.ops import eigh_jacobi as te

torch.set_num_threads(1)


def sym(rng, n, b=None, dtype=np.float64):
    """Symmetric matrices, batch-minor [n, n, b] (or one [n, n])."""
    shape = (n, n) if b is None else (b, n, n)
    A = rng.standard_normal(shape).astype(dtype)
    A = (A + np.swapaxes(A, -1, -2)) / 2
    return A if b is None else np.ascontiguousarray(np.moveaxis(A, 0, -1))


def _close(got, want, w_scale=None):
    """(w, V) against the reference's: w rtol 1e-12 of the largest
    eigenvalue, V atol 1e-10."""
    w, V = got
    jw, jV = (np.asarray(x) for x in want)
    scale = float(np.abs(jw).max()) if w_scale is None else w_scale
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(V.numpy(), jV, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [2, 3, 8, 15, 16, 17])
def test_schedule_equals_jax(n):
    from nlsolver_tpu.linalg.jacobi import round_robin_schedule

    ours, theirs = tj.round_robin_schedule(n), round_robin_schedule(n)
    assert len(ours) == len(theirs) == (n - 1 if n % 2 == 0 else n)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    # the kernel's table is the same schedule: the pairs, then the bye row
    units = tj.schedule_tables(n)
    assert units.dtype == np.int32 and units.shape == (len(ours), (n + 1) // 2, 2)
    for r, (ps, qs, perm, _) in enumerate(ours):
        k = len(ps)
        assert np.array_equal(units[r, :k, 0], ps) and np.array_equal(units[r, :k, 1], qs)
        rows = sorted(units[r].reshape(-1).tolist())
        assert sorted(set(rows)) == list(range(n))         # every row once (the bye twice)
        for p, q in units[r, k:]:
            assert p == q and perm[p] == p


def test_rotation_matches_jax_and_is_the_identity_at_zero():
    import jax.numpy as jnp
    from nlsolver_tpu.linalg.jacobi import _rotation

    rng = np.random.default_rng(1)
    app, aqq, apq = (rng.standard_normal(4000) for _ in range(3))
    apq[::7] = 0.0                       # the identity branch
    app[3::7] = aqq[3::7]                # theta == 0
    apq[5::7] *= 1e-200                  # a huge theta
    c, s = tj._rotation(*(torch.from_numpy(x) for x in (app, aqq, apq)))
    jc, js = _rotation(jnp.asarray(app), jnp.asarray(aqq), jnp.asarray(apq), jnp.float64)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-14, atol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-14, atol=1e-300)
    assert torch.isfinite(c).all() and torch.isfinite(s).all()
    assert torch.equal(c[::7], torch.ones_like(c[::7])) and not s[::7].any()
    # the rotation zeroes apq: (c, s) diagonalize [[app, apq], [apq, aqq]]
    off = (c * c - s * s) * torch.from_numpy(apq) + c * s * torch.from_numpy(app - aqq)
    assert float(off.abs().max()) < 1e-12


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_eigh_jacobi_matches_jax_single_and_batchminor(n, sort):
    import jax
    import jax.numpy as jnp
    from nlsolver_tpu.linalg.jacobi import eigh_jacobi

    rng = np.random.default_rng(n)
    A, Abm = sym(rng, n), sym(rng, n, 24)
    jfn = jax.jit(lambda X: eigh_jacobi(X, sort=sort))
    _close(tj.eigh_jacobi(torch.from_numpy(A), sort=sort), jfn(jnp.asarray(A)))
    got = tj.eigh_jacobi(torch.from_numpy(Abm), sort=sort)
    _close(got, jfn(jnp.asarray(Abm)))
    assert got.eigenvalues.shape == (n, 24) and got.eigenvectors.shape == (n, n, 24)
    if sort:
        w0 = np.linalg.eigh(np.moveaxis(Abm, -1, 0))[0].T
        np.testing.assert_allclose(got.eigenvalues.numpy(), w0, rtol=0, atol=1e-10)


def test_eigh_jacobi_under_vmap_equals_batchminor():
    """``torch.func.vmap`` over a leading axis runs the same operations as
    the trailing-batch form: equal to it, and to JAX's vmap."""
    import jax
    import jax.numpy as jnp
    from nlsolver_tpu.linalg.jacobi import eigh_jacobi

    n, B = 6, 16
    Abm = sym(np.random.default_rng(0), n, B)
    lead = torch.from_numpy(np.ascontiguousarray(np.moveaxis(Abm, -1, 0)))
    wv, Vv = torch.func.vmap(tj.eigh_jacobi)(lead)
    w, V = tj.eigh_jacobi(torch.from_numpy(Abm))
    np.testing.assert_allclose(wv.numpy(), w.numpy().T, rtol=0, atol=1e-13)
    np.testing.assert_allclose(Vv.numpy(), np.moveaxis(V.numpy(), -1, 0), rtol=0, atol=1e-13)
    _close((wv, Vv), jax.jit(jax.vmap(eigh_jacobi))(jnp.asarray(lead.numpy())))


@pytest.mark.parametrize("n,B", [(4, 32), (8, 16), (5, 24)])
def test_twin_matches_the_pallas_kernel_in_interpret_mode(n, B):
    """K5's twin, through the entry point that keeps the JAX name, against
    the TPU kernel as the JAX package's own tests run it on the CPU."""
    import jax.numpy as jnp
    from nlsolver_tpu.ops.eigh_jacobi import eigh_jacobi_pallas

    Abm = sym(np.random.default_rng(n), n, B)
    for sort in (True, False):
        got = te.eigh_jacobi_pallas(torch.from_numpy(Abm), sort=sort, tile=B, interpret=True)
        _close(got, eigh_jacobi_pallas(jnp.asarray(Abm), sort=sort, tile=B, interpret=True))
    # reconstruction on a few instances
    w, V = (x.numpy() for x in got)
    for b in (0, B // 2, B - 1):
        assert np.abs((V[..., b] * w[:, b][None]) @ V[..., b].T - Abm[..., b]).max() < 1e-10


def test_f32_meets_the_1e_5_bar_against_lapack():
    """The JAX package's bar in the fleet's dtype: eigenvalues within 1e-5
    of the largest against an f64 LAPACK decomposition."""
    B, n = 64, 16
    Abm = sym(np.random.default_rng(7), n, B, dtype=np.float32)
    w, V = tj.eigh_jacobi(torch.from_numpy(Abm))
    w0 = np.linalg.eigh(np.moveaxis(Abm, -1, 0).astype(np.float64))[0].T
    assert np.abs(w.numpy() - w0).max() / np.abs(w0).max() < 1e-5
    VtV = torch.einsum("ikb,ilb->klb", V, V)
    assert float((VtV - torch.eye(n)[:, :, None]).abs().max()) < 1e-5


def test_eigh_dispatcher_methods():
    import jax.numpy as jnp
    from nlsolver_tpu.linalg import eigh

    rng = np.random.default_rng(3)
    A, Abm = sym(rng, 6), sym(rng, 6, 16)
    tA = torch.from_numpy(A)
    w_x = tl.eigh(tA, method="xla").eigenvalues
    w_j = tl.eigh(tA, method="jacobi").eigenvalues
    np.testing.assert_allclose(w_x.numpy(), w_j.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(w_x.numpy(), np.asarray(eigh(jnp.asarray(A), method="xla")[0]),
                               rtol=0, atol=1e-10)
    w_p = tl.eigh(torch.from_numpy(Abm), method="pallas", interpret=True, tile=16)
    w_jb = tl.eigh(torch.from_numpy(Abm), method="jacobi")
    assert torch.equal(w_p.eigenvalues, w_jb.eigenvalues)      # on the CPU: the twin itself
    assert torch.equal(w_p.eigenvectors, w_jb.eigenvectors)
    _close(w_p, eigh(jnp.asarray(Abm), method="pallas", interpret=True, tile=16))
    # the parity path: iterated QR finds the same spectrum, in its own order
    S = A @ A.T + np.eye(6)
    got = tl.eigh(torch.from_numpy(S), method="qr", max_iter=200)
    want = eigh(jnp.asarray(S), method="qr", max_iter=200)
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.asarray(want.eigenvalues),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(np.sort(got.eigenvalues.numpy()), np.linalg.eigvalsh(S), rtol=1e-6)
    with pytest.raises(ValueError, match="eigh method"):
        tl.eigh(tA, method="nope")
    with pytest.raises(ValueError, match=r"expected \[n, n, \*batch\]"):
        tj.eigh_jacobi(torch.zeros(3, 4))


def test_eigh_qr_stops_early_on_a_diagonal_matrix():
    d = torch.tensor([3.0, 1.0, 2.0], dtype=torch.float64)
    w, V = tl.eigh_qr(torch.diag(d))
    assert torch.equal(w, d) and torch.equal(V, torch.eye(3, dtype=torch.float64))


def test_resident_plan_fits_a_block():
    """K5a's tile of lanes: 32 while A, V, c and s fit the 232448 bytes a
    block may opt in to, halved down to one lane, and nothing beyond
    n = 169 (119 in f64); under 32 lanes the slabs' leading dimension is
    odd; small n get more lanes, up to 256 threads."""
    f32, f64 = torch.float32, torch.float64
    ns = (4, 16, 29, 30, 41, 42, 59, 60, 64, 84, 85, 119, 120, 169, 170)
    assert [te.resident_tile(n, f32) for n in ns] == \
        [32, 32, 32, 16, 16, 8, 8, 4, 4, 4, 2, 2, 1, 1, 0]
    assert [te.resident_tile(n, f64) for n in (4, 16, 20, 21, 29, 30, 41, 42, 59, 60, 84, 85,
                                               119, 120)] == \
        [32, 32, 32, 16, 16, 8, 8, 4, 4, 2, 2, 1, 1, 0]
    assert te.resident_tile(2, f32) == 128 and te.resident_tile(1, f64) == 256
    assert [te.leading_dim(n, 32) for n in (16, 29)] == [16, 29]
    assert [te.leading_dim(n, lanes) for n, lanes in ((30, 16), (56, 8), (59, 8), (64, 4),
                                                      (119, 2), (120, 1))] == \
        [31, 57, 59, 65, 119, 121]
    for dtype, edge in ((f32, 169), (f64, 119)):
        size = torch.empty((), dtype=dtype).element_size()
        for n in range(1, 200):
            lanes = te.resident_tile(n, dtype)
            assert te.resident_fits(n, dtype) == (lanes > 0) == (n <= edge)
            if lanes:
                ld = te.leading_dim(n, lanes)
                assert ld in (n, n + 1) and (lanes >= 32 or ld % 2 == 1)
                assert te._slab_bytes(n, lanes, size) == (2 * n * ld + 2 * n) * lanes * size
                assert te._slab_bytes(n, lanes, size) <= te.MAX_DYNAMIC_SMEM
                # one lane more a block would not fit, unless a warp is full
                assert lanes >= 32 or te._slab_bytes(n, 2 * lanes, size) > te.MAX_DYNAMIC_SMEM
                tb, rj, ru = te.block_shape(n, lanes)
                assert tb == lanes and 1 <= rj <= n and 1 <= ru <= min((n + 1) // 2, 64)
                assert tb * rj * ru <= te.MAX_THREADS
                # under 32 lanes a warp is whole rows of one pair
                span = 32 // lanes if lanes < 32 else 1
                assert rj % span == 0 or rj == n
    assert te.block_shape(16, 32) == (32, 4, 8) and te.block_shape(64, 8) == (8, 4, 32)
    assert te.block_shape(64, 4) == (4, 8, 32) and te.block_shape(169, 1) == (1, 32, 32)


@pytest.mark.parametrize("n,dtype,fits", [(1, torch.float32, True), (16, torch.float32, True),
                                          (31, torch.float32, True), (32, torch.float32, True),
                                          (33, torch.float32, False), (15, torch.float64, True),
                                          (16, torch.float64, True), (17, torch.float64, False),
                                          (8, torch.float16, False)])
def test_registers_fit(n, dtype, fits):
    """The register form takes n <= 32 in f32 and n <= 16 in f64: four
    columns of n (or n + 1) entries are at most 128 registers a thread."""
    assert te.registers_fit(n, dtype) is fits
    words = torch.empty((), dtype=dtype).element_size() // 4
    assert fits == (dtype in te.REGISTER_MAX_PLAYERS and 4 * (n + n % 2) * words <= 128)


@pytest.mark.parametrize("n", range(2, 34))
def test_register_seating_plays_the_schedule(n):
    """The register form moves the players, not the indices: in every round
    the slots of ``register_seating`` hold the ordered pairs of
    ``schedule_tables`` (the bye of an odd n beside the dummy player n),
    the seats change hands as the docstring says, the masks name the lower
    player and the bye, and after a sweep every player is home."""
    seats, units = te.register_seating(n), tj.schedule_tables(n)
    m = n + n % 2
    assert seats.shape == (len(units), m // 2, 2)
    assert seats[0].tolist() == [[i, m - 1 - i] for i in range(m // 2)]
    for r, slots in enumerate(seats):
        assert sorted(slots.reshape(-1).tolist()) == list(range(m))       # every player once
        pairs = {(min(t, b), max(t, b)) if max(t, b) < n else (min(t, b),) * 2 for t, b in slots}
        assert pairs == {(int(p), int(q)) for p, q in units[r]}
        nxt = seats[(r + 1) % len(seats)]                                 # a sweep comes home
        top, bottom = slots[:, 0].tolist(), slots[:, 1].tolist()
        if m > 2:
            assert nxt[:, 0].tolist() == [top[0], bottom[0]] + top[1:-1]
            assert nxt[:, 1].tolist() == bottom[1:] + [top[-1]]
    if n <= 32:
        masks = te.register_masks(n)
        assert masks.dtype == np.uint32 and masks.shape == (len(units),)
        for r, slots in enumerate(seats):
            for j, (t, b) in enumerate(slots):
                assert bool(masks[r] >> j & 1) == (t < b)
                assert bool(masks[r] >> (16 + j) & 1) == (max(t, b) >= n)
        assert int(masks.max()) >> 16 == 0 or n % 2 == 1                  # a bye only for odd n
    else:
        with pytest.raises(ValueError, match="more than 16 slots"):
            te.register_masks(n)


def emulate_registers(A, sweeps):
    """The register form's data movement in plain tensors: slot s keeps the
    columns of its two players (``at[s]``, ``ab[s]`` of A with the rows in
    the order of the positions, tops then bottoms; ``vt[s]``, ``vb[s]`` of V
    with the rows in their own order), a round rotates rows and columns in
    place from ``register_masks``, then the players' data moves one seat
    on; the dummy player of an odd n is a zero row and column."""
    n, B = A.shape[0], A.shape[2]
    m = n + n % 2
    h = m // 2
    masks = te.register_masks(n)
    A = (A + A.transpose(0, 1)) / 2
    pos = list(range(h)) + list(range(m - 1, h - 1, -1))     # register e holds position pos[e]
    P = torch.zeros((m, m, B), dtype=A.dtype)
    P[:n, :n] = A
    at = [[P[pos[e], s].clone() for e in range(m)] for s in range(h)]
    ab = [[P[pos[e], m - 1 - s].clone() for e in range(m)] for s in range(h)]
    one, zero = torch.ones(B, dtype=A.dtype), torch.zeros(B, dtype=A.dtype)
    vt = [[one if r == s else zero for r in range(n)] for s in range(h)]
    vb = [[one if r == m - 1 - s else zero for r in range(n)] for s in range(h)]

    def rot(x, y, c, st, sb, bye):
        px, py = (x, y) if bye else (y, x)
        return c * x + st * px, c * y + sb * py

    for _ in range(sweeps):
        for rd in range(m - 1):
            mask = int(masks[rd])
            coef = []
            for s in range(h):
                top_lo, bye = bool(mask >> s & 1), bool(mask >> (16 + s) & 1)
                tt, bt, tb, bb = at[s][s], at[s][h + s], ab[s][s], ab[s][h + s]
                c, sn = tj._rotation(*((tt, bb, tb) if top_lo else (bb, tt, bt)))
                if bye:
                    coef.append((one, zero, zero, True))
                else:
                    coef.append((c, -sn if top_lo else sn, sn if top_lo else -sn, False))
            for j in range(h):                                # rows: slot j's pair, everywhere
                for s in range(h):
                    for col in (at[s], ab[s]):
                        col[j], col[h + j] = rot(col[j], col[h + j], *coef[j])
            for s in range(h):                                # columns: the slot's own pair
                for e in range(m):
                    at[s][e], ab[s][e] = rot(at[s][e], ab[s][e], *coef[s])
                for r in range(n):
                    vt[s][r], vb[s][r] = rot(vt[s][r], vb[s][r], *coef[s])
            if h == 1:
                continue
            for s in range(h):                                # A's rows follow the players
                for col in (at[s], ab[s]):
                    col[:] = ([col[0], col[h]] + col[1:h - 1]
                              + [col[h + j + 1] for j in range(h - 1)] + [col[h - 1]])
            for tops, bots in ((at, ab), (vt, vb)):           # and so do the columns
                tops[:], bots[:] = [tops[0], bots[0]] + tops[1:h - 1], bots[1:] + [tops[h - 1]]
    w, V = torch.zeros((n, B), dtype=A.dtype), torch.zeros((n, n, B), dtype=A.dtype)
    for s in range(h):
        for p, d, col in ((s, at[s][s], vt[s]), (m - 1 - s, ab[s][h + s], vb[s])):
            if p < n:
                w[p], V[:, p] = d, torch.stack(col)
    return w, V


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 3, 8, 15, 16, 17, 32])
def test_register_data_movement_equals_twin(n, dtype):
    """Moving the players' data between fixed slots, as the register form
    does, is the twin's computation bit for bit; a diagonal lane keeps
    c = 1, s = 0 throughout."""
    A = torch.from_numpy(sym(np.random.default_rng(n), n, 6)).to(dtype)
    A[:, :, 2] = torch.diag(torch.arange(1.0, n + 1)).to(dtype)
    for sweeps in (0, 1, 3):
        w, V = emulate_registers(A, sweeps)
        tw, tV = tj.eigh_jacobi(A, sweeps=sweeps, sort=False)
        assert torch.equal(w, tw) and torch.equal(V, tV)
    assert torch.equal(V[:, :, 2], torch.eye(n, dtype=dtype))


def test_cluster_plan_fits_a_cluster():
    """K5c's plan: the least C of 2, 4, 8 whose CTAs hold R = ceil(n / C)
    rows of A and V [R, n | 1] and 4 n words in the 232448 bytes a block may
    opt in to; C = 2 up to n = 238 in f32 (167 in f64), 4 to 336 (236), 8
    to 472 (329), nothing beyond; at the end of each C's range one more row
    a CTA would not fit, and the next smaller C never does."""
    for dtype, ends in ((torch.float32, (238, 336, 472)), (torch.float64, (167, 236, 329))):
        size = torch.empty((), dtype=dtype).element_size()
        for n in range(1, 601):
            C, R, ld = te.cluster_plan(n, dtype)
            want = next((c for c, end in zip(te.CLUSTER_SIZES, ends) if n <= end), 0)
            assert C == want and te.cluster_fits(n, dtype) == (C > 0), (n, dtype)
            if not C:
                assert (R, ld) == (0, 0)
                assert te._cluster_bytes(n, -(-n // 8), size) > te.MAX_DYNAMIC_SMEM
                continue
            assert R == -(-n // C) and ld == n | 1 and ld % 2 == 1
            assert te._cluster_bytes(n, R, size) == (2 * R * ld + 4 * n) * size
            assert te._cluster_bytes(n, R, size) <= te.MAX_DYNAMIC_SMEM
            if C > 2:
                assert te._cluster_bytes(n, -(-n // (C // 2)), size) > te.MAX_DYNAMIC_SMEM
            if n in ends:
                assert te._cluster_bytes(n, R + 1, size) > te.MAX_DYNAMIC_SMEM
    # K5c's range starts where K5a's ends: no n between them falls to K5b
    for dtype, first in ((torch.float32, 170), (torch.float64, 120)):
        assert te.resident_fits(first - 1, dtype) and not te.resident_fits(first, dtype)
        assert te.cluster_fits(first - 1, dtype) and te.cluster_fits(first, dtype)


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("n", [2, 3, 8, 17, 33, 170, 171])
def test_cluster_schedule_splits_every_round(n, C):
    """Every round of ``cluster_schedule`` is the round of ``schedule_tables``
    reordered by the CTA that rotates each unit; a CTA rotates only units
    one of whose rows it owns, and every unit whose rows it owns both."""
    units, starts = te.cluster_schedule(n, C)
    table = tj.schedule_tables(n)
    R = -(-n // C)
    assert units.dtype == starts.dtype == np.int32
    assert units.shape == table.shape and starts.shape == (len(table), C + 1)
    for r in range(len(table)):
        assert sorted(map(tuple, units[r].tolist())) == sorted(map(tuple, table[r].tolist()))
        assert starts[r, 0] == 0 and starts[r, -1] == len(table[r])
        assert (np.diff(starts[r]) >= 0).all()
        for k in range(C):
            for p, q in units[r, starts[r, k]:starts[r, k + 1]]:
                assert k in (p // R, q // R)
                if p // R == q // R:
                    assert k == p // R


def emulate_cluster(A, sweeps, C):
    """K5c's ownership in plain tensors: CTA k holds rows [k R, k R + R) of A
    and V as ``a[k], v[k]`` [R, n | 1, B] (row i of A is ``a[i // R][i %
    R]``) and c, s of every player as ``cv[k], sv[k]`` [n, B].  A round: each
    CTA forms (c, s) of the units ``cluster_schedule`` gives it and writes
    them into every CTA; it turns both rows of those units, reading both
    before writing either; then every CTA turns the columns of its own rows
    of A and V with its own coefficients."""
    n, B = A.shape[0], A.shape[2]
    R, ld = -(-n // C), n | 1
    units, starts = te.cluster_schedule(n, C)
    a = [torch.zeros((R, ld, B), dtype=A.dtype) for _ in range(C)]
    v = [torch.zeros((R, ld, B), dtype=A.dtype) for _ in range(C)]
    cv = [torch.zeros((n, B), dtype=A.dtype) for _ in range(C)]
    sv = [torch.zeros((n, B), dtype=A.dtype) for _ in range(C)]
    rows = [max(0, min(R, n - k * R)) for k in range(C)]
    for k in range(C):
        for i in range(rows[k]):
            gi = k * R + i
            a[k][i, :n] = (A[gi] + A[:, gi]) * 0.5
            v[k][i, gi] = 1.0
    one, zero = torch.ones(B, dtype=A.dtype), torch.zeros(B, dtype=A.dtype)

    def row(i):
        return a[i // R][i % R]

    for _ in range(sweeps):
        for rd in range(units.shape[0]):
            mine = [units[rd, starts[rd, k]:starts[rd, k + 1]].tolist() for k in range(C)]
            for k in range(C):
                for p, q in mine[k]:
                    c, s = tj._rotation(row(p)[p], row(q)[q], row(p)[q]) if p != q else (one, zero)
                    for m in range(C):
                        cv[m][p], sv[m][p] = c, (-s if p != q else s)
                        if p != q:
                            cv[m][q], sv[m][q] = c, s
            for k in range(C):
                for p, q in mine[k]:
                    x, y = row(p)[:n].clone(), row(q)[:n].clone()
                    row(p)[:n] = cv[k][p] * x + sv[k][p] * y
                    if p != q:
                        row(q)[:n] = cv[k][q] * y + sv[k][q] * x
            for k in range(C):
                for p, q in units[rd].tolist():
                    for M in (a[k], v[k]):
                        x, y = M[:rows[k], p].clone(), M[:rows[k], q].clone()
                        M[:rows[k], p] = cv[k][p] * x + sv[k][p] * y
                        if p != q:
                            M[:rows[k], q] = cv[k][q] * y + sv[k][q] * x
    w, V = torch.zeros((n, B), dtype=A.dtype), torch.zeros((n, n, B), dtype=A.dtype)
    for k in range(C):
        for i in range(rows[k]):
            w[k * R + i], V[k * R + i] = a[k][i, k * R + i], v[k][i, :n]
    return w, V


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("n", [3, 8, 17, 33])
def test_cluster_ownership_equals_twin(n, C, dtype):
    """Splitting a lane's rows over the CTAs of a cluster, as K5c does, is
    the twin's computation bit for bit (a CTA may own no row: n = 3 with C
    = 4 or 8); a diagonal lane keeps c = 1, s = 0 throughout."""
    A = torch.from_numpy(sym(np.random.default_rng(n + C), n, 6)).to(dtype)
    A[:, :, 2] = torch.diag(torch.arange(1.0, n + 1)).to(dtype)
    for sweeps in (0, 1, 3):
        w, V = emulate_cluster(A, sweeps, C)
        tw, tV = tj.eigh_jacobi(A, sweeps=sweeps, sort=False)
        assert torch.equal(w, tw) and torch.equal(V, tV)
    assert torch.equal(V[:, :, 2], torch.eye(n, dtype=dtype))


@pytest.mark.parametrize("B", [3, 16])
@pytest.mark.parametrize("n", [2, 9, 33, 64])
def test_global_plan_touches_each_entry_once_a_phase(n, B):
    """K5b's plan: in each phase of each round the threads' walks cover
    every item (lane, pair, column) exactly once, and no two items of a
    phase touch one entry, so that no entry is read after its partner was
    rewritten within the phase; on the whole card (132 SMs, 3 blocks an
    SM) and on a grid of two blocks, where every thread walks many items."""
    table = tj.schedule_tables(n).astype(np.int64)
    for sms, per_sm in ((132, 3), (2, 1)):
        plan = te.global_plan(n, B, sms, per_sm)
        assert 1 <= plan.blocks <= sms * per_sm and plan.threads == te.GLOBAL_THREADS
        items = te.global_items(n, B)
        for kind, (outer, mid) in items.items():
            walk = te.global_walk(plan, n, B, kind)
            f = walk[walk >= 0]
            assert walk.shape[1] == plan.blocks * plan.threads
            assert np.array_equal(np.sort(f), np.arange(outer * mid * B))
        for kind in ("rows", "cols"):
            f = te.global_walk(plan, n, B, kind)
            f = f[f >= 0]
            b, j, u = f % B, f // B % n, f // B // n
            for units in table:
                p, q = units[u, 0], units[u, 1]
                pair = p != q
                if kind == "rows":
                    touched = [(p * n + j) * B + b, ((q * n + j) * B + b)[pair]]
                else:
                    touched = [(j * n + p) * B + b, ((j * n + q) * B + b)[pair]]
                touched = np.concatenate(touched)
                assert len(np.unique(touched)) == len(touched)
        f = te.global_walk(plan, n, B, "coef")
        f = f[f >= 0]
        b, u = f % B, f // B
        for units in table:
            p, q = units[u, 0], units[u, 1]
            written = np.concatenate([p * B + b, (q * B + b)[p != q]])
            assert len(np.unique(written)) == len(written)


def emulate_global(A, sweeps, plan):
    """K5b in plain tensors: the working copy ``a``, V ``v`` and the
    coefficients flat, entry (i, j) of lane b at (i n + j) B + b; every
    phase runs its threads' walks (``global_walk``) step by step, a step's
    items at once (no two touch one entry), with the kernel's operations:
    A symmetrized and V = I; per round (c, s) of every (unit, lane), the
    rows p and q at each (column, lane), then the columns p and q of A and
    V at each (row, lane); w from the diagonal."""
    n, B = A.shape[0], A.shape[2]
    table = torch.from_numpy(tj.schedule_tables(n).astype(np.int64))
    src = A.reshape(-1)
    a, v = torch.empty(n * n * B, dtype=A.dtype), torch.empty(n * n * B, dtype=A.dtype)
    cv, sv = torch.empty(n * B, dtype=A.dtype), torch.empty(n * B, dtype=A.dtype)

    def steps(kind, mid):
        for f in te.global_walk(plan, n, B, kind):
            f = torch.from_numpy(f[f >= 0])
            yield f % B, f // B % mid, f // B // mid

    def at(i, j, b):
        return (i * n + j) * B + b

    for b, j, i in steps("init", n):
        a[at(i, j, b)] = (src[at(i, j, b)] + src[at(j, i, b)]) * 0.5
        v[at(i, j, b)] = (i == j).to(A.dtype)
    for r in range(sweeps * len(table)):
        units = table[r % len(table)]
        for b, _, u in steps("coef", 1):
            p, q = units[u, 0], units[u, 1]
            pair = p != q
            c, s = tj._rotation(a[at(p, p, b)], a[at(q, q, b)], a[at(p, q, b)])
            c, s = torch.where(pair, c, 1.0).to(A.dtype), torch.where(pair, s, 0.0).to(A.dtype)
            cv[p * B + b], sv[p * B + b] = c, torch.where(pair, -s, s)
            cv[(q * B + b)[pair]], sv[(q * B + b)[pair]] = c[pair], s[pair]
        for kind in ("rows", "cols"):
            for b, j, u in steps(kind, n):
                p, q = units[u, 0], units[u, 1]
                pair = p != q
                cp, sp, cq, sq = cv[p * B + b], sv[p * B + b], cv[q * B + b], sv[q * B + b]
                rows = kind == "rows"
                for M in (a,) if rows else (a, v):
                    ep, eq = (at(p, j, b), at(q, j, b)) if rows else (at(j, p, b), at(j, q, b))
                    x, y = M[ep], M[eq]
                    M[ep] = cp * x + sp * y
                    M[eq[pair]] = (cq * y + sq * x)[pair]
    w = torch.empty(n * B, dtype=A.dtype)
    for b, _, i in steps("w", 1):
        w[i * B + b] = a[at(i, i, b)]
    return w.reshape(n, B), v.reshape(n, n, B)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [3, 16])
@pytest.mark.parametrize("n", [9, 33, 64])
def test_global_phases_equal_twin(n, B, dtype):
    """Running K5b's phases in its plan's order, step by step, on a grid
    of two blocks of 512 threads (so that a thread walks several items a
    phase) is the twin's computation bit for bit; a diagonal lane keeps c
    = 1, s = 0 throughout."""
    A = torch.from_numpy(sym(np.random.default_rng(n + B), n, B)).to(dtype)
    A[:, :, 1] = torch.diag(torch.arange(1.0, n + 1)).to(dtype)
    plan = te.global_plan(n, B, 2, 1)
    for sweeps in (0, 1, 2):
        w, V = emulate_global(A, sweeps, plan)
        tw, tV = tj.eigh_jacobi(A, sweeps=sweeps, sort=False)
        assert torch.equal(w, tw) and torch.equal(V, tV)
    assert torch.equal(V[:, :, 1], torch.eye(n, dtype=dtype))


def test_cluster_range_on_the_cpu_matches_jax():
    """At n = 171, K5c's range, the port's entry point on a CPU tensor (the
    twin) against the JAX package's, which takes its jnp Jacobi there (8
    lanes: its planner finds no VMEM tile), in f64.  Eight sweeps, so that
    both have converged: after one, an ulp of difference in a sqrt has grown
    to 3e-12 of the largest eigenvalue over the 171 rounds; after eight the
    two agree to 8e-14 (w) and 6e-13 (V)."""
    import jax.numpy as jnp
    from nlsolver_tpu.ops.eigh_jacobi import eigh_jacobi_pallas, plan_tiles

    n, B, sweeps = 171, 8, 8
    assert not plan_tiles(n, B, 128, 8)[2]
    Abm = sym(np.random.default_rng(n), n, B)
    got = te.eigh_jacobi_pallas(torch.from_numpy(Abm), sweeps=sweeps)
    _close(got, eigh_jacobi_pallas(jnp.asarray(Abm), sweeps=sweeps))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=r"expected \[n, n, B\]"):
        te.eigh_jacobi_pallas(torch.zeros(3, 4, 5))
    with pytest.raises(ValueError, match=r"expected \[n, n, B\]"):
        te.eigh_jacobi_pallas(torch.zeros(3, 3))
    with pytest.raises(ValueError, match="sweeps"):
        te.eigh_jacobi_pallas(torch.zeros(3, 3, 2), sweeps=-1)
    # the kernel's own wrappers never run on a CPU tensor
    kernels = (te.eigh_jacobi_kernel, te.eigh_jacobi_registers, te.eigh_jacobi_resident,
               te.eigh_jacobi_global, te.eigh_jacobi_cluster)
    for kernel in kernels:
        with pytest.raises(ValueError, match="unsupported device"):
            kernel(torch.zeros(3, 3, 2))
    # K5c refuses an n that 8 CTAs cannot hold, before it looks at the device
    for n, dtype in ((473, torch.float32), (330, torch.float64)):
        with pytest.raises(ValueError, match="does not fit the shared memory of a cluster"):
            te.eigh_jacobi_cluster(torch.zeros(n, n, 1, dtype=dtype))
    assert all(kernel.launches == 0 for kernel in kernels[1:])


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_jacobi_eigh.py)")
    return torch.device("cuda")


def _taken(n, dtype):
    """The form the dispatcher gives n: K5r, K5a, K5c, K5b, each where the
    ones before it refuse n."""
    if te.registers_fit(n, dtype):
        return te.eigh_jacobi_registers
    if te.resident_fits(n, dtype):
        return te.eigh_jacobi_resident
    return te.eigh_jacobi_cluster if te.cluster_fits(n, dtype) else te.eigh_jacobi_global


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B", [(2, 1000), (3, 257), (8, 4096), (16, 4099), (17, 333),
                                 (31, 70), (32, 70), (33, 130), (56, 64), (64, 40), (84, 16),
                                 (120, 5), (168, 2), (170, 3), (238, 2), (239, 2), (336, 2),
                                 (337, 1), (472, 1), (330, 1), (473, 1), (330, 16), (473, 16)])
def test_kernel_equals_twin_on_card(n, B, dtype):
    """The four forms against the twin, bit for bit, each where it takes n
    (K5c also with every larger cluster), and through the dispatcher that
    keeps the JAX name; the
    edges of K5c's clusters in f32 (238 / 239, 336 / 337, 472 / 473) and
    f64 (167 / 168, 236 / 237, 329 / 330); K5b alone beyond, also on
    the 16 lanes of the CMA-ES fleet at n = 473 (and at f64's 330)."""
    dev = _on_card()
    sweeps = 6 if n <= 170 else 2
    A = torch.from_numpy(sym(np.random.default_rng(n), n, B)).to(dev, dtype)
    tw, tV = tj.eigh_jacobi(A, sweeps=sweeps, sort=False)
    forms = [(te.eigh_jacobi_registers, te.registers_fit(n, dtype), "does not fit the registers"),
             (te.eigh_jacobi_resident, te.resident_fits(n, dtype),
              "does not fit the shared memory of a block"),
             (te.eigh_jacobi_cluster, te.cluster_fits(n, dtype),
              "does not fit the shared memory of a cluster"),
             (te.eigh_jacobi_global, True, None)]
    taken = _taken(n, dtype)
    for kernel, fits, refusal in forms:
        before = kernel.launches
        if not fits:
            with pytest.raises(ValueError, match=refusal):
                kernel(A, sweeps=sweeps)
            continue
        w, V = kernel(A, sweeps=sweeps)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert torch.equal(w, tw) and torch.equal(V, tV)
    C = te.cluster_plan(n, dtype)[0]
    for larger in (c for c in te.CLUSTER_SIZES if c > C > 0):
        w, V = te._launch_cluster("probe", A, sweeps, larger)
        torch.cuda.synchronize()
        assert torch.equal(w, tw) and torch.equal(V, tV), larger
    before = taken.launches
    got = te.eigh_jacobi_pallas(A, sweeps=sweeps, sort=False)
    torch.cuda.synchronize()
    assert taken.launches == before + 1
    assert torch.equal(got.eigenvalues, tw) and torch.equal(got.eigenvectors, tV)


@pytest.mark.gpu
def test_kernel_sorted_spectrum_and_refusals_on_card():
    dev = _on_card()
    n, B = 12, 500
    A64 = torch.from_numpy(sym(np.random.default_rng(5), n, B)).to(dev)
    got = te.eigh_jacobi_pallas(A64)
    w0 = torch.linalg.eigh(A64.permute(2, 0, 1))[0].t()
    assert float((got.eigenvalues - w0).abs().max()) < 1e-10
    recon = torch.einsum("ikb,kb,jkb->ijb", got.eigenvectors, got.eigenvalues, got.eigenvectors)
    assert float((recon - A64).abs().max()) < 1e-10
    # a diagonal matrix takes the identity rotation everywhere: no NaN
    D = torch.diag_embed(torch.rand(B, n, device=dev)).permute(1, 2, 0).contiguous()
    for kernel in (te.eigh_jacobi_registers, te.eigh_jacobi_resident, te.eigh_jacobi_cluster,
                   te.eigh_jacobi_global):
        w, V = kernel(D, sweeps=3)
        assert torch.equal(w, torch.diagonal(D, dim1=0, dim2=1).t())
        assert torch.equal(V, torch.eye(n, device=dev)[:, :, None].expand(n, n, B))
    with pytest.raises(ValueError, match="contiguous"):
        te.eigh_jacobi_pallas(A64.transpose(0, 1))
    with pytest.raises(ValueError, match="float32 or float64"):
        te.eigh_jacobi_pallas(A64.half())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B", [(9, 3), (64, 4096), (473, 16)])
def test_global_launch_plans_equal_twin_on_card(n, B, dtype):
    """K5b's grid of blocks of 256, 512 and 1024 threads, as one
    cooperative launch and as one launch a phase (the benches' probe), the
    twin's bits every time."""
    dev = _on_card()
    A = torch.from_numpy(sym(np.random.default_rng(n), n, B)).to(dev, dtype)
    tw, tV = tj.eigh_jacobi(A, sweeps=2, sort=False)
    for threads in (256, 512, 1024):
        for cooperative in (True, False):
            w, V = te._launch_global("probe", A, 2, threads, cooperative)
            torch.cuda.synchronize()
            assert torch.equal(w, tw) and torch.equal(V, tV), (threads, cooperative)
