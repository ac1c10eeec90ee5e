"""Kernel K3 of nlsolver_torch (``ops.smallchol``): the batch-minor
Cholesky twin against the JAX package's ``solve_spd_batchminor`` and its
Pallas kernel in interpret mode, the standard-layout solves, plain-tensor
emulations of K3-w's order (right-looking, the forward solve as one more
row, the back solve row by row), of K3-c's (the rows split over a
cluster's CTAs) and of K3-d's (the rows split over any number of CTAs, the
columns through a store in device memory) bit-equal to the twin, K3-b's
plain version (the twin's L and z, the back solve by columns) and its
order, held to the twin's factors and to the JAX solve, the dispatcher's
plan, the shapes refused, and each CUDA form against the twin (K3-b against
its plain version) and ``fit_fleet``'s default backend given numpy start
points (on a card only).

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


@pytest.mark.parametrize("n", [1, 2, 4, 8, 12])
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


FORMS = {"registers": tsc.solve_spd_registers, "warp": tsc.solve_spd_warp,
         "cluster": tsc.solve_spd_cluster, "distributed": tsc.solve_spd_distributed,
         "global": tsc.solve_spd_batchminor_global}


def _launches():
    return {name: f.launches for name, f in FORMS.items()}


def test_cpu_route_is_the_twin_and_errors():
    A, b = (torch.from_numpy(a) for a in _spd_batchminor(12, 3, 5))
    before = _launches()
    assert torch.equal(tsc.solve_spd_batchminor(A, b), tsc._chol_solve_batchminor(A, b))
    for form in FORMS.values():
        assert torch.equal(form(A, b), tsc._chol_solve_batchminor(A, b))
    assert _launches() == before
    with pytest.raises(ValueError, match=r"A must be \[n, n, B\]"):
        tsc.solve_spd_batchminor(A[:2], b)
    with pytest.raises(ValueError, match=r"b must be \[n, B\]"):
        tsc.solve_spd_batchminor(A, b[:, :4])
    with pytest.raises(ValueError, match="unsupported device"):
        tsc.solve_spd_batchminor(A.to("meta"), b)
    with pytest.raises(ValueError, match="need A"):
        tsc.solve_spd_batched_kernel(A, b.T[0])
    for form in FORMS.values():
        with pytest.raises(ValueError, match="unsupported device"):
            form(A.to("meta"), b)


def emulate_warp(A, b):
    """K3-w's order on plain tensors: rows 0 .. n of a triangle, b in row n;
    at step j the square root of S[j][j], column j below it divided by it,
    then the trailing update S[i][l] -= L[i][j] L[l][j] for j < l <= i, l <
    n, all of it at once (each entry's operations are the kernel's; its
    upper entries are never read); then the back solve row by row,
    ascending k."""
    n, _, B = A.shape
    S = A.new_zeros((n + 1, n + 1, B))
    S[:n, :n] = A
    S[n, :n] = b
    for j in range(n):
        d = torch.sqrt(S[j, j])
        S[j + 1:, j] = S[j + 1:, j] / d
        S[j, j] = d
        col = S[j + 1:, j]
        S[j + 1:, j + 1:] = S[j + 1:, j + 1:] - col[:, None] * col[None, :]
    x = [None] * n
    for i in reversed(range(n)):
        acc = S[n, i]
        for k in range(i + 1, n):
            acc = acc - S[k, i] * x[k]
        x[i] = acc / S[i, i]
    return torch.stack(x, dim=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 8, 12, 30])
def test_warp_order_bit_equal_to_twin(n, dtype):
    A, b = (torch.from_numpy(a).to(dtype) for a in _spd_batchminor(20 + n, n, 33))
    got = emulate_warp(A, b)
    assert torch.equal(got, tsc._chol_solve_batchminor(A, b))
    assert float((torch.einsum("ijb,jb->ib", A, got) - b).abs().max()) < (
        1e-3 if dtype == torch.float32 else 1e-10)


def emulate_cluster(A, b, C):
    """K3-c's order on plain tensors: rows 0 .. n of the triangle (b as row
    n), row i held by CTA i % C alone (every other CTA's copy of it is NaN,
    so a read of a row a CTA does not hold shows), each CTA with its own
    copy of the diagonal and its own three column rows.  Column 0 is
    divided first; at step j every CTA forms column j + 1 a step ahead
    (step j's product off the column-(j + 1) entries of its rows past j +
    1, the square root of its diagonal's entry less its own product, the
    quotients stored into column row (j + 1) % 3 of every CTA), then
    subtracts col[i] col[l] of step j from the rest of its rows, j + 1 < l
    <= min(i, n - 1), and from its diagonal past j + 1.  The back solve
    gathers L[k][i] and z[i] from the CTAs that hold them, forms the
    products with x, and subtracts them in ascending k."""
    n, _, B = A.shape
    S = [A.new_full((n + 1, n + 1, B), float("nan")) for _ in range(C)]
    for i in range(n + 1):
        S[i % C][i, :n] = A[i] if i < n else b
    diag = [A[torch.arange(n), torch.arange(n)].clone() for _ in range(C)]
    col = [A.new_full((3, n + 1, B), float("nan")) for _ in range(C)]

    def push(j, i, v):
        for buf in col:
            buf[j % 3, i] = v

    for k in range(C):
        d = torch.sqrt(diag[k][0])
        for i in range(k, n + 1, C):
            if i > 0:
                S[k][i, 0] = S[k][i, 0] / d
                push(0, i, S[k][i, 0])
        if k == 0:
            S[k][0, 0] = d
    for j in range(n):
        for k in range(C):
            cj = col[k][j % 3]
            if j + 1 < n:
                d = torch.sqrt(diag[k][j + 1] - cj[j + 1] * cj[j + 1])
                for i in range(k, n + 1, C):
                    if i > j + 1:
                        S[k][i, j + 1] = (S[k][i, j + 1] - cj[i] * cj[j + 1]) / d
                        push(j + 1, i, S[k][i, j + 1])
                if (j + 1) % C == k:
                    S[k][j + 1, j + 1] = d
        for k in range(C):
            cj = col[k][j % 3]
            for i in range(k, n + 1, C):
                if i > j + 1:
                    end = min(i, n - 1)
                    S[k][i, j + 2:end + 1] = S[k][i, j + 2:end + 1] - cj[i] * cj[j + 2:end + 1]
            diag[k][j + 2:] = diag[k][j + 2:] - cj[j + 2:n] * cj[j + 2:n]
    x = [None] * n
    for i in reversed(range(n)):
        g = {k: S[k % C][k, i] for k in range(i, n + 1)}
        acc = g[n]
        for k in range(i + 1, n):
            acc = acc - g[k] * x[k]
        x[i] = acc / g[i]
    return torch.stack(x, dim=0)


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 30])
def test_cluster_order_bit_equal_to_twin(n, dtype, C):
    """K3-c's order with clusters of 2 and 4 (n < C leaves CTAs without a
    row) is the twin's bit for bit, and it solves the systems."""
    A, b = (torch.from_numpy(a).to(dtype) for a in _spd_batchminor(40 + n, n, 17))
    got = emulate_cluster(A, b, C)
    assert torch.equal(got, tsc._chol_solve_batchminor(A, b))
    assert float((torch.einsum("ijb,jb->ib", A, got) - b).abs().max()) < (
        1e-3 if dtype == torch.float32 else 1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 9, 30])
def test_right_looking_reference_bit_equal_to_twin(n, dtype):
    """The reference that holds the large forms on the card where the
    twin's eager ops would take minutes: the twin's bits."""
    A, b = (torch.from_numpy(a).to(dtype) for a in _spd_batchminor(60 + n, n, 9))
    assert torch.equal(tsc.chol_solve_right_looking(A, b), tsc._chol_solve_batchminor(A, b))


@pytest.mark.parametrize("C", [2, 4])
def test_cluster_order_matches_jax_pallas_interpret(C):
    from nlsolver_tpu.ops.smallchol import solve_spd_batched_pallas

    A, b = _spd_batchminor(15, 6, 128, np.float32)
    A_std, b_std = np.ascontiguousarray(A.transpose(2, 0, 1)), np.ascontiguousarray(b.T)
    want = np.asarray(solve_spd_batched_pallas(A_std, b_std, tile=128, interpret=True))
    got = emulate_cluster(torch.from_numpy(A), torch.from_numpy(b), C)
    np.testing.assert_allclose(got.numpy().T, want, atol=1e-4)


def test_cluster_form_range():
    """K3-c's CTA holds its packed rows, the diagonal and three column rows
    within a block's shared memory: 2, 4 or 8 CTAs, n <= 927 in f32 and 645
    in f64; the plan takes the size that runs the most lanes at once, and
    with few lanes the cluster grows while twice as many CTAs still find an
    SM each."""
    f32, f64 = torch.float32, torch.float64
    assert tsc.cluster_words(240, 2) == sum(range(1, 241, 2)) + 240
    assert tsc.cluster_words(3, 4) == 3 and tsc.cluster_words(1, 8) == 1
    for dtype, ends in ((f32, (472, 663, 927)), (f64, (331, 463, 645))):
        for size, last in zip((2, 4, 8), ends):
            assert tsc.cluster_bytes(last, dtype, size) <= tsc.MAX_DYNAMIC_SMEM < \
                tsc.cluster_bytes(last + 1, dtype, size)
        assert not tsc.cluster_fits(ends[-1] + 1, dtype) and tsc.cluster_fits(ends[-1], dtype)
        for n in range(1, ends[-1] + 1, 7):
            C = tsc.cluster_plan(n, dtype)
            assert tsc.cluster_bytes(n, dtype, C) <= tsc.MAX_DYNAMIC_SMEM
            assert all(tsc.cluster_lanes(n, dtype, C) >= tsc.cluster_lanes(n, dtype, c)
                       for c in (2, 4, 8) if tsc.cluster_bytes(n, dtype, c) <= tsc.MAX_DYNAMIC_SMEM)
    # 256 lanes at n = 239 and 337 in f64: 66, 99, 99 lanes at once and 0, 33, 49
    assert [tsc.cluster_lanes(239, f64, c) for c in (2, 4, 8)] == [66, 99, 99]
    assert [tsc.cluster_lanes(337, f64, c) for c in (4, 8)] == [33, 49]
    assert tsc.cluster_plan(239, f64, 256) == 4 and tsc.cluster_plan(337, f64, 256) == 8
    # the path's [240, 240, 16] in f64: 16 clusters of 8 on 132 SMs
    assert [tsc.cluster_plan(240, f64, lanes) for lanes in (16, 17, 33, 66, 67, 4096)] == \
        [8, 4, 4, 2, 4, 4]
    assert tsc.cluster_plan(500, f64, 16) == 8 and tsc.cluster_plan(650, f64, 16) == 0
    assert tsc.cluster_plan(4, torch.float16) == 0 and tsc.cluster_plan(0, f32) == 0


def emulate_distributed(A, b, P):
    """K3-d's order on plain tensors: row i of rows 0 .. n (b as row n) in
    CTA i % P, every CTA a copy of the diagonal; the columns of L through a
    store in device memory that holds NaN until a CTA writes an entry once.
    Right past the barrier of step j - 1 each CTA copies column j's rows j +
    1 .. n from the store into its own column buffer (NaN elsewhere, so a
    read of a word never copied shows), forms column j + 1 of its own rows
    into the store (step j's product off, the division by the square root
    of its diagonal), then subtracts step j's products from the rest of its
    rows and its diagonal; the back solve reads the store in the twin's
    order."""
    n, _, B = A.shape
    nan = float("nan")
    S = [A.new_full((n + 1, n, B), nan) for _ in range(P)]
    for i in range(n + 1):
        S[i % P][i, :min(i + 1, n)] = A[i, :i + 1] if i < n else b
    diag = [A[torch.arange(n), torch.arange(n)].clone() for _ in range(P)]
    store = A.new_full((n + 1, n, B), nan)  # L[i][j], z[j] in row n

    def put(i, j, v):
        assert torch.isnan(store[i, j]).all(), f"L[{i}][{j}] stored twice"
        store[i, j] = v

    for k in range(P):
        d = torch.sqrt(diag[k][0])
        for i in range(k, n + 1, P):
            if i > 0:
                S[k][i, 0] = S[k][i, 0] / d
                put(i, 0, S[k][i, 0])
        if k == 0:
            S[k][0, 0] = d
            put(0, 0, d)
    for j in range(n):
        cols = []
        for k in range(P):
            col = A.new_full((n + 1, B), nan)
            col[j + 1:] = store[j + 1:, j]
            cols.append(col)
        for k, col in enumerate(cols):
            if j + 1 < n:
                c1 = col[j + 1]
                d = torch.sqrt(diag[k][j + 1] - c1 * c1)
                for i in range(k, n + 1, P):
                    if i > j + 1:
                        S[k][i, j + 1] = (S[k][i, j + 1] - col[i] * c1) / d
                        put(i, j + 1, S[k][i, j + 1])
                if (j + 1) % P == k:
                    S[k][j + 1, j + 1] = d
                    put(j + 1, j + 1, d)
        for k, col in enumerate(cols):
            for i in range(k, n + 1, P):
                if i > j + 1:
                    end = min(i, n - 1)
                    S[k][i, j + 2:end + 1] = S[k][i, j + 2:end + 1] - col[i] * col[j + 2:end + 1]
            diag[k][j + 2:] = diag[k][j + 2:] - col[j + 2:n] * col[j + 2:n]
    x = [None] * n
    for i in reversed(range(n)):
        acc = store[n, i]
        for k in range(i + 1, n):
            acc = acc - store[k, i] * x[k]
        x[i] = acc / store[i, i]
    return torch.stack(x, dim=0)


@pytest.mark.parametrize("P", [3, 5, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 4, 13, 30])
def test_distributed_order_bit_equal_to_twin(n, dtype, P):
    """K3-d's order over 3, 5 and 12 CTAs (more than a cluster holds, and
    not a power of two; n < P leaves CTAs without a row) is the twin's bit
    for bit, and it solves the systems."""
    A, b = (torch.from_numpy(a).to(dtype) for a in _spd_batchminor(70 + n, n, 11))
    got = emulate_distributed(A, b, P)
    assert torch.equal(got, tsc._chol_solve_batchminor(A, b))
    assert float((torch.einsum("ijb,jb->ib", A, got) - b).abs().max()) < (
        1e-3 if dtype == torch.float32 else 1e-10)


def test_distributed_order_matches_jax_pallas_interpret():
    from nlsolver_tpu.ops.smallchol import solve_spd_batched_pallas

    A, b = _spd_batchminor(16, 7, 128, np.float32)
    A_std, b_std = np.ascontiguousarray(A.transpose(2, 0, 1)), np.ascontiguousarray(b.T)
    want = np.asarray(solve_spd_batched_pallas(A_std, b_std, tile=128, interpret=True))
    got = emulate_distributed(torch.from_numpy(A), torch.from_numpy(b), 5)
    np.testing.assert_allclose(got.numpy().T, want, atol=1e-4)


# K3-d's range on an H100's 132 SMs: (first, last) n by dtype, past K3-c's
DISTRIBUTED_RANGE = {torch.float32: (928, 3599), torch.float64: (646, 2457)}


def test_distributed_form_range():
    """K3-d's CTA holds its packed rows (K3-c's layout over P CTAs), the
    diagonal and a column, at least the back solve's 3 n + 2 words, within
    a block's shared memory; its range, a direct call's, runs from K3-c's
    end to the last n that 132 CTAs hold, and the dispatcher gives K3-b
    all of it; the plan takes the fewest CTAs that hold the rows, spread
    over the card's SMs where few lanes leave them idle."""
    f32, f64 = torch.float32, torch.float64
    assert tsc.distributed_bytes(646, f64, 66) == (tsc.cluster_words(646, 66) + 1293) * 8
    assert tsc.distributed_bytes(3, f32, 12) == 11 * 4  # the back solve's words
    for dtype, (first, last) in DISTRIBUTED_RANGE.items():
        assert not tsc.cluster_fits(first, dtype) and tsc.cluster_fits(first - 1, dtype)
        assert tsc.distributed_fits(first, dtype) and tsc.distributed_fits(last, dtype)
        assert tsc.plan(first - 1, dtype) == "cluster"
        assert {tsc.plan(n, dtype) for n in (first, first + 1, 1000, last, last + 1)} == \
            {"blocked"}
        assert not tsc.distributed_fits(last + 1, dtype)
        assert tsc.distributed_least(last, dtype) == 132
        assert tsc.distributed_bytes(last, dtype, 132) <= tsc.MAX_DYNAMIC_SMEM < \
            tsc.distributed_bytes(last + 1, dtype, 132)
        for n in (1, 30, first, 1000, last):
            P = tsc.distributed_least(n, dtype)
            assert tsc.distributed_bytes(n, dtype, P) <= tsc.MAX_DYNAMIC_SMEM
            assert P == 1 or tsc.distributed_bytes(n, dtype, P - 1) > tsc.MAX_DYNAMIC_SMEM
        # fewer SMs hold less
        assert not tsc.distributed_fits(last, dtype, sms=131)
    # the path's [646, 646, 2] in f64: 66 CTAs a lane; many lanes: the fewest
    assert tsc.distributed_least(646, f64) == 8 and tsc.distributed_least(928, f32) == 8
    assert [tsc.distributed_plan(646, f64, lanes) for lanes in (1, 2, 3, 16, 17, 64)] == \
        [132, 66, 44, 8, 8, 8]
    assert tsc.distributed_plan(700, f64, 64) == 9 and tsc.distributed_plan(5, f64, 1) == 6
    assert tsc.distributed_plan(2458, f64, 2) == 0 and tsc.distributed_plan(4, torch.float16) == 0
    assert tsc.distributed_plan(0, f32) == 0


def test_kernel_ranges_match_the_source():
    """The register form's most n in csrc/smallchol.cu is the module's."""
    import re
    from pathlib import Path

    src = (Path(tsc.__file__).parent.parent / "csrc" / "smallchol.cu").read_text()
    consts = dict(re.findall(r"(k\w+MaxN\w*) = (\d+)", src))
    assert int(consts["kRegisterMaxN32"]) == tsc.REGISTER_MAX_N[torch.float32]
    assert int(consts["kRegisterMaxN64"]) == tsc.REGISTER_MAX_N[torch.float64]


def test_warp_form_range():
    """A warp's triangle, b and column in an odd count of words within a
    block's shared memory beside the block's table: n <= 337 in f32, 238
    in f64; lanes a block halve to fit."""
    for dtype, last in ((torch.float32, 337), (torch.float64, 238)):
        assert tsc.warp_fits(last, dtype) and not tsc.warp_fits(last + 1, dtype)
        assert (tsc.warp_bytes(last, dtype) // torch.empty((), dtype=dtype).element_size()) % 2
        assert tsc.warp_lanes(30, dtype) == tsc.WARP_LANES
        assert tsc.warp_lanes(last, dtype) == 1
        for n in (1, 30, 100, last):
            lanes = tsc.warp_lanes(n, dtype)
            assert tsc.warp_block_bytes(n, dtype, lanes) <= tsc.MAX_DYNAMIC_SMEM
    assert not tsc.warp_fits(0, torch.float32) and not tsc.warp_fits(8, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_takes_each_form_in_its_range(dtype):
    """The first form that takes n: K3-r, then K3-w, then K3-c, then K3-b,
    which takes every n past K3-c's range, K3-d's included (K3-d and K3-g
    are direct calls' alone)."""
    reg = tsc.REGISTER_MAX_N[dtype]
    warp = max(n for n in range(1, 400) if tsc.warp_fits(n, dtype))
    cluster = max(n for n in range(1, 1000) if tsc.cluster_fits(n, dtype))
    last = DISTRIBUTED_RANGE[dtype][1]
    want = {1: "registers", 2: "registers", reg: "registers", reg + 1: "warp", 30: "warp",
            warp: "warp", warp + 1: "cluster", cluster: "cluster", cluster + 1: "blocked",
            1200: "blocked", last: "blocked", last + 1: "blocked", 5000: "blocked",
            100000: "blocked"}
    assert {n: tsc.plan(n, dtype) for n in want} == want
    assert all(tsc.plan(n, dtype) == ("registers" if tsc.registers_fit(n, dtype) else "warp")
               for n in range(1, warp + 1))


@pytest.mark.parametrize("n, dtype", [(0, torch.float32), (-1, torch.float64),
                                      (4, torch.float16), (4, torch.int32)])
def test_plan_refuses_what_no_form_takes(n, dtype):
    with pytest.raises(ValueError):
        tsc.plan(n, dtype)


def twin_factors(A, b):
    """The twin's L and z: the loops of ``linalg.solve._solve_spd_unrolled``
    up to its back solve, as they stand there."""
    n = A.shape[0]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = A[i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(acc) if i == j else acc / L[j][j]
    z = [None] * n
    for i in range(n):
        acc = b[i]
        for k in range(i):
            acc = acc - L[i][k] * z[k]
        z[i] = acc / L[i][i]
    zero = torch.zeros_like(b[0])
    return (torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(n)])
                         for i in range(n)]), torch.stack(z))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 9, 17, 30])
def test_blocked_reference_factors_bit_equal_to_twin(n, dtype):
    """K3-b's plain version forms the twin's L and z bit for bit (its
    factor as whole trailing blocks, b as row n), and the twin's back solve
    from them, ascending in k, gives the twin's x: only K3-b's back solve,
    descending in k, differs."""
    A, b = (torch.from_numpy(a).to(dtype) for a in _spd_batchminor(80 + n, n, 7))
    L, z = tsc.solve_spd_blocked_reference(A, b, _factors=True)
    tL, tz = twin_factors(A, b)
    assert torch.equal(L, tL) and torch.equal(z, tz)
    x = [None] * n
    for i in reversed(range(n)):
        acc = z[i]
        for k in range(i + 1, n):
            acc = acc - L[k, i] * x[k]
        x[i] = acc / L[i, i]
    assert torch.equal(torch.stack(x), tsc._chol_solve_batchminor(A, b))


def _kappa(A):
    """kappa_2 of each lane of A [n, n, B], the largest over the lanes."""
    s = np.linalg.svd(np.moveaxis(A, -1, 0), compute_uv=False)
    return float((s[:, 0] / s[:, -1]).max())


@pytest.mark.parametrize("n", [1, 2, 8, 17, 24])
def test_blocked_reference_matches_jax_f64(n):
    """K3-b's plain version (and, on the CPU, K3-b) against the JAX
    package's Pallas kernel in interpret mode and its batch-minor solve in
    f64: |x - x_jax|_inf / |x_jax|_inf <= n eps kappa_2(A), kappa computed
    here from the singular values.  Both are backward-stable Cholesky
    solves of the same systems, each within some n eps kappa of the exact x
    by the usual bound; here they share L and z to the last bit and differ
    only in the order of the back solve's n (n - 1) / 2 terms, a smaller
    perturbation, so n eps kappa holds them with room (at n = 8 to 40 the
    readings lie some 30x below eps kappa)."""
    import jax
    from nlsolver_tpu.ops.smallchol import solve_spd_batched_pallas, solve_spd_batchminor

    A, b = _spd_batchminor(90 + n, n, 64)
    tol = n * np.finfo(np.float64).eps * _kappa(A)
    want_bm = np.asarray(jax.jit(solve_spd_batchminor)(A, b))
    A_std, b_std = np.ascontiguousarray(A.transpose(2, 0, 1)), np.ascontiguousarray(b.T)
    want_pallas = np.asarray(solve_spd_batched_pallas(A_std, b_std, tile=128, interpret=True)).T
    x = tsc.solve_spd_blocked_reference(torch.from_numpy(A), torch.from_numpy(b))
    assert torch.equal(tsc.solve_spd_blocked(torch.from_numpy(A), torch.from_numpy(b)), x)
    twin = tsc._chol_solve_batchminor(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    for want in (want_bm, want_pallas, twin):
        err = np.abs(x.numpy() - want).max() / np.abs(want).max()
        assert err <= tol, (err, tol)


def _left_looking_factors(A, b, cols):
    """The twin's L and z in its first ``cols`` columns, arranged by
    columns, in numpy: column j of [A; b^T] (rows j .. n) less L[.][k]
    L[j][k] for k = 0 .. j - 1 in ascending k, each product and difference
    rounded on its own, then its square root (torch's, as the twin takes
    it) and its quotients by it.  Another arrangement of the twin's
    operations in its order than ``_blocked_factor``'s whole trailing
    blocks.  Returns (L [n, cols, B] below its diagonal, z [cols, B])."""
    n, _, B = A.shape
    S = np.zeros((n + 1, cols, B), A.dtype)
    S[:n], S[n] = A[:, :cols], b[:cols]
    for j in range(cols):
        c = S[j:, j]
        for k in range(j):
            c = c - S[j:, k] * S[j, k]
        d = torch.sqrt(torch.from_numpy(c[0])).numpy()
        S[j, j], S[j + 1:, j] = d, c[1:] / d
        S[:j, j] = 0
    return S[:n], S[n]


@pytest.mark.parametrize("n, dtype", [(646, torch.float64), (928, torch.float32)])
def test_blocked_reference_at_the_first_n_past_cluster(n, dtype):
    """At the first n past K3-c's range on 2 lanes, where the dispatcher
    gives K3-b what K3-d took before: K3-b's plain version has the twin's
    L and z bit for bit (``_blocked_factor``'s, whose first 256 columns a
    left-looking arrangement of the twin's operations gives too), and its x
    lies within n eps kappa_2(A) of the twin's order's
    (``chol_solve_right_looking``, bit-equal to the twin), kappa from the
    eigenvalues.  The JAX solve unrolls some n^3 / 6 operations, so it is
    held at small n alone (``test_blocked_reference_matches_jax_f64``)."""
    A, b = (torch.from_numpy(a).to(dtype) for a in _spd_batchminor(n, n, 2))
    L, z = tsc.solve_spd_blocked_reference(A, b, _factors=True)
    S = tsc._blocked_factor(A, b)
    assert torch.equal(L, torch.tril(S[:n, :n].movedim(-1, 0)).movedim(0, -1))
    assert torch.equal(z, S[n, :n])
    tL, tz = _left_looking_factors(A.numpy(), b.numpy(), 256)
    assert np.array_equal(L[:, :256].numpy(), tL) and np.array_equal(z[:256].numpy(), tz)
    w = np.linalg.eigvalsh(np.moveaxis(A.double().numpy(), -1, 0))
    tol = n * np.finfo(A.numpy().dtype).eps * float((w[:, -1] / w[:, 0]).max())
    x = tsc.solve_spd_blocked_reference(A, b)
    twin = tsc.chol_solve_right_looking(A, b)
    err = float((x - twin).abs().max() / twin.abs().max())
    assert err <= tol, (err, tol)
    assert not torch.equal(x, twin)  # the back solve's order is not the twin's
    # kappa_2(A) near 2 n leaves the bound above loose in f32: hold each
    # back solve also to the triangular solve's componentwise backward error,
    # |L^T x - z| <= n eps |L^T| |x|, which a dropped or doubled term breaks
    Ld, zd = L.double().numpy(), z.double().numpy()
    for xs in (x, twin):
        xd = xs.double().numpy()
        r = np.abs(np.einsum("kil,kl->il", Ld, xd) - zd)
        scale = np.einsum("kil,kl->il", np.abs(Ld), np.abs(xd))
        assert (r <= n * np.finfo(A.numpy().dtype).eps * scale).all(), float((r / scale).max())


def emulate_blocked(A, b, nb, back=32):
    """K3-b in plain torch ops, in the kernel's order, one step at a time:
    the panels of nb columns, b as row n; the next panel's columns take the
    current panel's terms (ascending k) before it is factored column by
    column (its square root, its quotients, their products off its later
    columns), the trailing columns past the next panel take them after;
    then the back solve by blocks of ``back`` rows from the last, each
    solved from its diagonal block in descending k, and its terms taken off
    the rows before it, descending in k, the next block's first."""
    n, _, B = A.shape
    S = torch.zeros((n + 1, n + 1, B), dtype=A.dtype)
    S[:n, :n] = A
    S[n, :n] = b

    def factor(k0, k1):
        for kc in range(k0, k1):
            d = torch.sqrt(S[kc, kc])
            S[kc + 1:, kc] = S[kc + 1:, kc] / d
            S[kc, kc] = d
            for c2 in range(kc + 1, k1):
                S[c2:, c2] = S[c2:, c2] - S[c2:, kc] * S[c2, kc]

    def take(k0, k1, cols):
        for j in cols:
            for k in range(k0, k1):
                S[j:, j] = S[j:, j] - S[j:, k] * S[j, k]

    np_ = -(-n // nb)
    factor(0, min(nb, n))
    for p in range(np_ - 1):
        k0, k1 = p * nb, (p + 1) * nb
        k2 = min(k1 + nb, n)
        take(k0, k1, range(k1, k2))
        factor(k1, k2)
        take(k0, k1, range(k2, n))
    acc, x = S[n, :n].clone(), torch.empty((n, B), dtype=A.dtype)
    for q in reversed(range(-(-n // back))):
        kb, ke = q * back, min(q * back + back, n)
        for k in reversed(range(kb, ke)):
            x[k] = acc[k] / S[k, k]
            acc[kb:k] = acc[kb:k] - S[k, kb:k] * x[k]
        for k in reversed(range(kb, ke)):
            acc[:kb] = acc[:kb] - S[k, :kb] * x[k]
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,nb,back", [(1, 8, 32), (9, 8, 32), (40, 4, 32), (33, 8, 32),
                                       (70, 1, 32), (37, 3, 5), (12, 8, 4)])
def test_blocked_order_bit_equal_to_its_reference(n, nb, back, dtype):
    """K3-b's order (panels with the next one taken first, the back solve in
    blocks whose diagonal block is solved before its terms leave the rows
    before it) is its plain version's bit for bit, whatever the panel's
    width and the back solve's block."""
    A, b = (torch.from_numpy(a).to(dtype) for a in _spd_batchminor(60 + n, n, 5))
    assert torch.equal(emulate_blocked(A, b, nb, back), tsc.solve_spd_blocked_reference(A, b))


def test_blocked_form_range():
    """K3-b takes every n >= 1 in f32 and f64; its panel of 8 columns of n +
    1 words stays in shared memory to n = 7119 in f32 and 3487 in f64, in
    device memory past them; a lane gets the card's SMs shared out over the
    lanes, at least 4 CTAs; its store packs the triangle by columns."""
    f32, f64 = torch.float32, torch.float64
    for dtype, last in ((f32, 7119), (f64, 3487)):
        assert tsc.blocked_fits(1, dtype) and tsc.blocked_fits(100000, dtype)
        assert not tsc.blocked_spills(last, dtype) and tsc.blocked_spills(last + 1, dtype)
        assert tsc.blocked_bytes(last, dtype) <= tsc.MAX_DYNAMIC_SMEM
        assert tsc.blocked_bytes(last + 1, dtype, spill=True) <= tsc.MAX_DYNAMIC_SMEM
    assert not tsc.blocked_fits(0, f32) and not tsc.blocked_fits(5, torch.float16)
    assert [tsc.blocked_plan(2458, f64, lanes) for lanes in (None, 1, 2, 3, 33, 34, 64, 1000)] \
        == [132, 132, 66, 44, 4, 4, 4, 4]
    assert tsc.blocked_plan(646, f64, 16) == 8 and tsc.blocked_plan(646, f64, 64, sms=8) == 4
    assert tsc.blocked_plan(0, f64) == 0
    assert [tsc.blocked_store_words(n) for n in (1, 2, 2458)] == [3, 7, 2458 * 2461 // 2 + 2458]


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_smallchol.py)")
    return torch.device("cuda")


# each form at the n it takes among these, in both dtypes
FORM_CASES = [(form, n, dtype) for form in FORMS for dtype in (torch.float32, torch.float64)
              for n in (1, 2, 4, 8, 12, 13, 14, 16, 19, 20, 30, 33, 64)
              if form != "registers" or tsc.registers_fit(n, dtype)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 8, 12, 16, 30, 33])
def test_kernel_bit_equal_to_twin_on_card(n, dtype):
    """The dispatcher launches the form that plan names, once, and its x is
    the twin's bit for bit."""
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(n, n, 1000))
    before = _launches()
    x = tsc.solve_spd_batchminor(A, b)
    torch.cuda.synchronize()
    form = tsc.plan(n, dtype)
    assert _launches() == {k: v + (k == form) for k, v in before.items()}
    assert torch.equal(x, tsc._chol_solve_batchminor(A, b))


@pytest.mark.gpu
@pytest.mark.parametrize("form, n, dtype", FORM_CASES)
def test_each_form_bit_equal_to_twin_on_card(form, n, dtype):
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(n + 100, n, 999))
    before = FORMS[form].launches
    x = FORMS[form](A, b)
    torch.cuda.synchronize()
    assert FORMS[form].launches == before + 1
    assert torch.equal(x, tsc._chol_solve_batchminor(A, b))


@pytest.mark.gpu
@pytest.mark.parametrize("warps", [1, 2, 4, 8, 16, 32])
def test_warp_form_lanes_a_block_on_card(warps):
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, torch.float32) for a in _spd_batchminor(300, 30, 1001))
    assert torch.equal(tsc.solve_spd_warp(A, b, lanes=warps), tsc._chol_solve_batchminor(A, b))


@pytest.mark.gpu
def test_forms_refuse_what_they_do_not_take_on_card():
    dev = _on_card()
    for dtype in (torch.float32, torch.float64):
        n = tsc.REGISTER_MAX_N[dtype] + 1
        A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(14, n, 64))
        with pytest.raises(ValueError, match="does not fit a thread's registers"):
            tsc.solve_spd_registers(A, b)
        n = max(k for k in range(1, 400) if tsc.warp_fits(k, dtype)) + 1
        A, b = torch.eye(n, device=dev, dtype=dtype)[:, :, None], torch.ones(n, 1, device=dev,
                                                                              dtype=dtype)
        with pytest.raises(ValueError, match="does not fit a block's shared memory"):
            tsc.solve_spd_warp(A, b)
        before = _launches()
        x = tsc.solve_spd_batchminor(A, b)
        assert _launches()["cluster"] == before["cluster"] + 1
        assert torch.equal(x, b)
        n = max(k for k in range(1, 1000) if tsc.cluster_fits(k, dtype)) + 1
        A, b = torch.eye(n, device=dev, dtype=dtype)[:, :, None], torch.ones(n, 1, device=dev,
                                                                              dtype=dtype)
        with pytest.raises(ValueError, match="cluster"):
            tsc.solve_spd_cluster(A, b)
        before, blocked = _launches(), tsc.solve_spd_blocked.launches
        x = tsc.solve_spd_batchminor(A, b)
        assert _launches() == before and tsc.solve_spd_blocked.launches == blocked + 1
        assert torch.equal(x, b)
        with pytest.raises(ValueError, match="CTAs' shared memory"):
            tsc.solve_spd_distributed(A, b, size=tsc.distributed_least(n, dtype) - 1)
        # past K3-d's range the plan names K3-b and K3-d refuses
        n = DISTRIBUTED_RANGE[dtype][1] + 1
        A, b = torch.eye(n, device=dev, dtype=dtype)[:, :, None], torch.ones(n, 1, device=dev,
                                                                              dtype=dtype)
        assert tsc.plan(n, dtype) == "blocked"
        with pytest.raises(ValueError, match="solve_spd_blocked takes it"):
            tsc.solve_spd_distributed(A, b)


@pytest.mark.gpu
@pytest.mark.parametrize("n, B, dtype", [(240, 16, torch.float64), (239, 33, torch.float64),
                                         (338, 5, torch.float32), (40, 70, torch.float32),
                                         (3, 9, torch.float64)])
def test_cluster_form_bit_equal_with_every_size_on_card(n, B, dtype):
    """K3-c at its path's [240, 240, 16] f64, at the first n of its range in
    both dtypes and below it, with every cluster size that holds the rows and
    64, 256 and 512 threads a CTA: the twin's bits."""
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(n + 7, n, B))
    twin = tsc._chol_solve_batchminor(A, b)
    for size in tsc.CLUSTER_SIZES:
        if tsc.cluster_bytes(n, dtype, size) > tsc.MAX_DYNAMIC_SMEM:
            continue
        for threads in (64, 256, 512):
            before = tsc.solve_spd_cluster.launches
            x = tsc.solve_spd_cluster(A, b, size=size, _threads=threads)
            torch.cuda.synchronize()
            assert tsc.solve_spd_cluster.launches == before + 1
            assert torch.equal(x, twin), (size, threads)


@pytest.mark.gpu
@pytest.mark.parametrize("n, B, dtype", [(646, 2, torch.float64), (928, 2, torch.float32),
                                         (700, 64, torch.float64), (40, 5, torch.float64),
                                         (13, 70, torch.float32)])
def test_distributed_form_bit_equal_with_every_size_on_card(n, B, dtype):
    """K3-d at its path's [646, 646, 2] f64, at the first n of its range in
    f32, on 64 lanes (several waves of teams), and below its range, with 3,
    5, 12, 66 and 132 CTAs a lane where they hold the rows and 64, 256 and
    512 threads a CTA at the plan's: the twin's bits (past n = 64 as
    ``chol_solve_right_looking`` gives them)."""
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(n + 9, n, B))
    twin = (tsc._chol_solve_batchminor if n <= 64 else tsc.chol_solve_right_looking)(A, b)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    least, plan = tsc.distributed_least(n, dtype, sms), tsc.distributed_plan(n, dtype, B, sms)
    for size in sorted({least, plan, 3, 5, 12, 66, 132}):
        if size < least or size > sms:
            continue
        for threads in ((64, 256, 512) if size == plan else (256,)):
            before = tsc.solve_spd_distributed.launches
            x = tsc.solve_spd_distributed(A, b, size=size, _threads=threads)
            torch.cuda.synchronize()
            assert tsc.solve_spd_distributed.launches == before + 1
            assert torch.equal(x, twin), (size, threads)


@pytest.mark.gpu
def test_right_looking_reference_bit_equal_to_twin_on_card():
    """At K3-c's path, [240, 240, 16] in f64, the reference that holds it in
    the smoke run gives the twin's bits on the card too (the twin's eager
    ops take most of a minute there)."""
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev) for a in _spd_batchminor(247, 240, 16))
    assert torch.equal(tsc.chol_solve_right_looking(A, b), tsc._chol_solve_batchminor(A, b))


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


@pytest.mark.gpu
def test_fit_fleet_numpy_start_points_land_on_the_card():
    """fit_fleet through its default backend (K3) given numpy X0 and data,
    bare or as a leaf of a dict: both go to the card, as minimize's start
    points do."""
    import nlsolver_torch as nt

    dev = _on_card()
    t = torch.linspace(0.0, 2.0, 32, dtype=torch.float64, device=dev)
    rng = np.random.default_rng(1)
    amps, rates = rng.uniform(1.0, 3.0, 64), rng.uniform(0.5, 2.0, 64)
    ys = amps[:, None] * np.exp(-rates[:, None] * np.linspace(0.0, 2.0, 32)[None, :])
    before = _launches()
    out = nt.fit_fleet(lambda p, y: p[0] * torch.exp(-p[1] * t) - y, np.ones((2, 64)),
                       nt.NLLSFleetConfig(max_iter=30), data=ys)
    assert out.x.device.type == "cuda" and out.x.dtype == torch.float64
    assert _launches()["registers"] > before["registers"]
    np.testing.assert_allclose(out.x.cpu().numpy(), np.stack([amps, rates]), atol=1e-6)
    in_dict = nt.fit_fleet(lambda p, d: p[0] * torch.exp(-p[1] * t) - d["y"], np.ones((2, 64)),
                           nt.NLLSFleetConfig(max_iter=30), data={"y": ys})
    assert torch.equal(in_dict.x, out.x)


@pytest.mark.gpu
@pytest.mark.parametrize("n, B, dtype", [(2458, 2, torch.float64), (3600, 2, torch.float32),
                                         (3488, 1, torch.float64)])
def test_blocked_form_at_its_first_n_on_card(n, B, dtype):
    """K3-b through the dispatcher at the first n of its range in both
    dtypes and at the first n whose panel lies in device memory in f64: one
    launch, no other form's, x bit-equal to its plain version on the card."""
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(n, n, B))
    before = _launches()
    blocked = tsc.solve_spd_blocked.launches
    x = tsc.solve_spd_batchminor(A, b)
    torch.cuda.synchronize()
    assert _launches() == before and tsc.solve_spd_blocked.launches == blocked + 1
    assert torch.equal(x, tsc.solve_spd_blocked_reference(A, b))


@pytest.mark.gpu
@pytest.mark.parametrize("n, B, dtype", [(646, 2, torch.float64), (646, 64, torch.float64),
                                         (928, 2, torch.float32), (928, 64, torch.float32)])
def test_blocked_form_at_the_first_n_past_cluster_on_card(n, B, dtype):
    """K3-b through the dispatcher at the first n past K3-c's range in both
    dtypes (K3-d's before), on 2 lanes and on 64: one launch, no other
    form's, x bit-equal to its plain version on the card."""
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(n + 3, n, B))
    before = _launches()
    blocked = tsc.solve_spd_blocked.launches
    x = tsc.solve_spd_batchminor(A, b)
    torch.cuda.synchronize()
    assert _launches() == before and tsc.solve_spd_blocked.launches == blocked + 1
    assert torch.equal(x, tsc.solve_spd_blocked_reference(A, b))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [1, 2])
def test_cluster_form_probe_modes_on_card(mode):
    """K3-c's probe instantiation at its path's [240, 240, 16] f64: it
    launches and is counted; without its back solve (1) or with its
    barriers alone (2) x holds no solution, and the main path's kernel
    afterwards still gives the twin's bits."""
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev) for a in _spd_batchminor(247, 240, 16))
    before = tsc.solve_spd_cluster.launches
    tsc.solve_spd_cluster(A, b, _mode=mode)
    torch.cuda.synchronize()
    assert tsc.solve_spd_cluster.launches == before + 1
    assert torch.equal(tsc.solve_spd_cluster(A, b), tsc.chol_solve_right_looking(A, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n, B", [(646, 2), (100, 3), (40, 70), (33, 5), (1, 4), (300, 1)])
def test_blocked_form_with_small_panels_on_card(n, B, dtype):
    """K3-b by a direct call below its range with every panel width 1 to 8,
    on 2, 3, 66 CTAs a lane and the plan's, on more lanes than the card's
    teams: its plain version's bits."""
    dev = _on_card()
    A, b = (torch.from_numpy(a).to(dev, dtype) for a in _spd_batchminor(n + 11, n, B))
    want = tsc.solve_spd_blocked_reference(A, b)
    for nb in range(1, tsc.BLOCKED_NB + 1):
        for size in (None, 2, 3, 66):
            before = tsc.solve_spd_blocked.launches
            x = tsc.solve_spd_blocked(A, b, size=size, _nb=nb)
            torch.cuda.synchronize()
            assert tsc.solve_spd_blocked.launches == before + 1
            assert torch.equal(x, want), (nb, size)


@pytest.mark.gpu
def test_blocked_form_refuses_what_it_does_not_take_on_card():
    dev = _on_card()
    A, b = torch.eye(8, device=dev)[:, :, None], torch.ones(8, 1, device=dev)
    with pytest.raises(ValueError, match="panels of 9 columns"):
        tsc.solve_spd_blocked(A, b, _nb=9)
    with pytest.raises(ValueError, match="1 CTAs a lane"):
        tsc.solve_spd_blocked(A, b, size=1)
    with pytest.raises(ValueError, match="contiguous"):
        tsc.solve_spd_blocked(A.transpose(0, 1), b)
    assert tsc.solve_spd_blocked(A[:, :, :0].contiguous(), b[:, :0].contiguous()).shape == (8, 0)
