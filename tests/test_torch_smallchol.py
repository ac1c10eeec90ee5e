"""Kernel K3 of nlsolver_torch (``ops.smallchol``): the batch-minor
Cholesky twin against the JAX package's ``solve_spd_batchminor`` and its
Pallas kernel in interpret mode, the standard-layout solves, a plain-tensor
emulation of K3-w's order (right-looking, the forward solve as one more
row, the back solve row by row) bit-equal to the twin, the dispatcher's
plan, the shapes refused, and each CUDA form against the twin and
``fit_fleet``'s default backend given numpy start points (on a card
only).

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
    """The first form that takes n: K3-r, then K3-w, then K3-g."""
    reg = tsc.REGISTER_MAX_N[dtype]
    warp = max(n for n in range(1, 400) if tsc.warp_fits(n, dtype))
    want = {1: "registers", 2: "registers", reg: "registers", reg + 1: "warp", 30: "warp",
            warp: "warp", warp + 1: "global", 600: "global"}
    assert {n: tsc.plan(n, dtype) for n in want} == want
    assert all(tsc.plan(n, dtype) == ("registers" if tsc.registers_fit(n, dtype) else "warp")
               for n in range(1, warp + 1))


@pytest.mark.parametrize("n, dtype", [(0, torch.float32), (-1, torch.float64),
                                      (4, torch.float16), (4, torch.int32)])
def test_plan_refuses_what_no_form_takes(n, dtype):
    with pytest.raises(ValueError):
        tsc.plan(n, dtype)


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
        assert _launches()["global"] == before["global"] + 1
        assert torch.equal(x, b)


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
