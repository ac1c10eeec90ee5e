"""K2b-p, the panel form of K2b (``ops.qr_wavefront.least_squares_wavefront_panel``):
a plain-tensor emulation of its order held bit for bit against the twin
and against the JAX package, its plan and launches, the dispatcher's
hand-over at each end of its range, and the CUDA kernels against the twin
(on a card only).

JAX is imported only inside the tests that compare with it, so that the
card's tests run where JAX is not installed:

    python -m pytest tests/test_torch_lstsq_panel.py -q
    python -m pytest --noconftest -m gpu tests/test_torch_lstsq_panel.py
"""
import numpy as np
import pytest
import torch

from nlsolver_torch.ops import qr_wavefront as tqw

torch.set_num_threads(1)


def _system(seed, m, n, B, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n, B)).astype(dtype), rng.standard_normal((m, B)).astype(dtype)


def lstsq_panel_emulation(A, y, width):
    """K2b-p in plain torch ops, in the kernel's order.  Phase 1, panel by
    panel (``qr_panel_bounds`` of [A | y]'s n + 1 columns, at most ``width``
    a panel; y is column n): at each stage up to the last with a pivot below
    the panel's end j1, the panel's pivots form (c, s) from their own
    columns into the rotation log (poisoned with NaN first: no pair is read
    before it is written) at ``qr_log_offset(k) + j - j_lo``, then the
    stage's pivots below j1, earlier panels' and its own, turn the panel's
    columns from pivot j on, read from the log (the stages before 2 j0
    replay the log alone); each panel stores its columns' rows 0 .. n - 1
    on and above the diagonal (the store poisoned with NaN first).  No
    earlier panel takes the later pivots.  The back solve reads the store in
    the twin's order, the products R[i][col] x[col] past col = i + 1 formed
    ahead of the chain of subtractions.  Within a stage the row pairs are
    disjoint, so how the kernel shares them out over CTAs and groups of
    threads leaves these values as they are."""
    from nlsolver_torch.linalg.givens import givens_rotation

    m, n, B = A.shape
    nan = float("nan")
    log = torch.full((2, tqw.qr_log_pairs(m, n), B), nan, dtype=A.dtype)
    store = torch.full((n, n + 1, B), nan, dtype=A.dtype)
    Ay = torch.cat([A, y[:, None]], dim=1)
    for j0, j1 in tqw.qr_panel_bounds(n + 1, width):
        X = Ay[:, j0:j1].clone()
        for k in range(min(m + n - 3, m - 3 + j1) + 1):
            j_lo, j_hi = max(0, k - m + 2), min(n - 1, k // 2)
            hi, off, p0 = min(j_hi, j1 - 1), tqw.qr_log_offset(k, m, n), m - 2 - k
            for j in range(max(j_lo, j0), hi + 1):
                p = p0 + 2 * j
                log[:, off + j - j_lo] = torch.stack(
                    givens_rotation(X[p, j - j0], X[p + 1, j - j0]))
            for j in range(j_lo, hi + 1):
                c, s = log[0, off + j - j_lo], log[1, off + j - j_lo]
                p, cols = p0 + 2 * j, slice(max(0, j - j0), None)
                vp, vq = X[p, cols].clone(), X[p + 1, cols].clone()
                X[p, cols], X[p + 1, cols] = c * vp + s * vq, c * vq + (-s) * vp
        for col in range(j0, j1):
            for i in range(min(col, n - 1) + 1):
                store[i, col] = X[i, col - j0]
    x = torch.full((n, B), nan, dtype=A.dtype)
    for i in range(n - 1, -1, -1):
        r = store[i]
        acc = r[n]
        if i + 1 < n:
            acc = acc - r[i + 1] * x[i + 1]
        for term in r[i + 2:n] * x[i + 2:n]:
            acc = acc - term
        x[i] = acc / r[i]
    return x


# (m, n, the most columns a panel of [A | y]): 13 columns in panels of 4,
# 3, 3 and 3, tall with panels of 5, panels of 2 and of 1 (y alone in the
# last), one panel, m = n = 1 (no stage, y alone in the second panel), m =
# 2 (one stage), a tall [5, 3] in two panels, a square [6, 6] in one
LSTSQ_PANEL_CASES = [(12, 12, 4), (20, 13, 5), (9, 9, 2), (7, 5, 1), (12, 11, 12), (1, 1, 1),
                     (2, 1, 1), (5, 3, 2), (6, 6, 7)]


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,width", LSTSQ_PANEL_CASES)
def test_lstsq_panel_order_equals_twin(m, n, width, dtype, deficient):
    """K2b-p's order (R by panels with every rotation logged, y carried
    through the last panel, no replay of the earlier panels, the back solve
    from the store) is the twin's x bit for bit; a zero column makes a = b =
    0, the identity select, and x inf or NaN where the twin's is."""
    A, y = (torch.from_numpy(a) for a in _system(26, m, n, 4, dtype))
    if deficient:
        A[:, n // 2] = 0.0
    x = lstsq_panel_emulation(A, y, width)
    torch.testing.assert_close(x, tqw.least_squares_wavefront_reference(A, y), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lstsq_panel_order_matches_jax(dtype):
    """K2b-p's order against the JAX package's Pallas kernel in interpret
    mode and, in float64, its jitted wavefront: f32 within 1e-5 absolute,
    f64 within rtol 1e-12 (the diagonal raised by 2 n keeps every x away
    from zero), at [12, 12, 16] in four panels (4, 3, 3 and 3 columns) and
    [13, 9, 16] in four (3, 3, 2 and 2)."""
    import jax
    from nlsolver_tpu.linalg.qr_parallel import least_squares_parallel
    from nlsolver_tpu.ops.qr_wavefront import least_squares_wavefront_pallas

    for m, n, width in ((12, 12, 4), (13, 9, 3)):
        A, y = _system(27, m, n, 16, dtype)
        A[np.arange(n), np.arange(n)] += np.asarray(2 * n, dtype)
        x = lstsq_panel_emulation(torch.from_numpy(A), torch.from_numpy(y), width).numpy()
        jx = np.asarray(least_squares_wavefront_pallas(A, y, interpret=True))
        if dtype == np.float32:
            np.testing.assert_allclose(x, jx, atol=1e-5)
        else:
            np.testing.assert_allclose(x, jx, rtol=1e-12)
            np.testing.assert_allclose(x, np.asarray(jax.jit(least_squares_parallel)(A, y)),
                                       rtol=1e-12)


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,B", [(1, 1, 3), (2, 1, 2), (12, 12, 4), (20, 13, 5), (40, 33, 3)])
def test_twin_order_equals_twin(m, n, B, dtype, deficient):
    """``least_squares_twin_order`` (the twin's stages, then its back solve
    on the host in its order), the reference ``chip_smoke.py`` holds K2b-p
    to at shapes where the twin's eager back solve takes a minute, is the
    twin's x bit for bit, inf and NaN of a zero column included."""
    from nlsolver_torch.benches import least_squares_twin_order

    A, y = (torch.from_numpy(a) for a in _system(31, m, n, B, dtype))
    if deficient:
        A[:, n // 2] = 0.0
    torch.testing.assert_close(least_squares_twin_order(A, y),
                               tqw.least_squares_wavefront_reference(A, y), rtol=0, atol=0,
                               equal_nan=True)


def test_cpu_route_of_the_panel_form_is_the_twin():
    """On CPU tensors K2b-p and the dispatcher run the twin and launch
    nothing, past K2b-d's range too."""
    before = tqw.least_squares_wavefront_panel.launches
    for m, n in ((9, 4), (40, 33)):
        A, y = (torch.from_numpy(a) for a in _system(28, m, n, 3))
        twin = tqw.least_squares_wavefront_reference(A, y)
        assert torch.equal(tqw.least_squares_wavefront_panel(A, y), twin)
        assert torch.equal(tqw.least_squares_wavefront_panel(A, y, _width=4), twin)
        assert torch.equal(tqw.least_squares_wavefront_kernel(A, y), twin)
    assert tqw.least_squares_wavefront_panel.launches == before


# K2b-d's last n and K2b-p's last square m = n, by dtype
K2BD_END = {torch.float32: 1847, torch.float64: 1262}
K2BP_END = {torch.float32: 29055, torch.float64: 14527}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_least_squares_form_hands_over_at_each_end(dtype):
    """The dispatcher ends K2b-d at its last n, square or tall, and gives
    K2b-p every [m, n] past it whose column of m words fits a CTA beside a
    stage's coefficients, as K2a-p's range; past that, K2b-g; below K2b-d's
    end the forms are chosen by n alone, whatever m."""
    d, p = K2BD_END[dtype], K2BP_END[dtype]
    for m in (d, d + 1, 2 * d):
        assert tqw.least_squares_form(m, d, dtype) == "distributed"
    for m in (d + 1, d + 2, 2 * d + 17):
        assert tqw.least_squares_form(m, d + 1, dtype) == "panel"
    assert tqw.least_squares_form(p, p, dtype) == "panel"
    assert tqw.least_squares_form(p + 1, p + 1, dtype) == "global"
    assert [tqw.qr_panel_fits(q, q, dtype, False) for q in (p, p + 1)] == [True, False]
    # the tallest m that a CTA holds beside d + 1 pivots' coefficients
    itemsize = torch.empty((), dtype=dtype).element_size()
    tall = max(m for m in range(d + 1, 60000)
               if m + 2 * min(d + 1, m // 2 + 1) <= 232448 // itemsize)
    assert tqw.least_squares_form(tall, d + 1, dtype) == "panel"
    assert tqw.least_squares_form(tall + 1, d + 1, dtype) == "global"
    assert tqw.least_squares_form(10 * tall, 30, dtype) == "warp"
    assert tqw.least_squares_form(10 * tall, d, dtype) == "distributed"
    assert not tqw.qr_panel_fits(4, 4, torch.float16, False)
    assert not tqw.qr_panel_fits(3, 4, dtype, False)


def test_lstsq_panel_plans():
    """K2b-p's plans at its paths: [A | y]'s n + 1 columns in K2a-p's panels
    (K2a-p's P rule), y the last column of the last panel; [1263, 1263, 2]
    f64 one panel over 66 CTAs a lane, two lanes at once; [1848, 1848, 2]
    f32 the same; [2543, 1263, 2] f64 (a Chebyshev fit's augmented system)
    one panel over 132 CTAs (127 the fewest: 10 columns a CTA), a lane at a
    time; [1848, 1848] f64 the first square of two panels (K2a-p's one up to
    1848), [1849, 1849, 1] f64 two, y in the second; in f32 one panel up to
    2641, as K2a-p."""
    f32, f64 = torch.float32, torch.float64
    assert tqw.lstsq_panel_plan(1263, 1263, f64, 2) == [(0, 1264, 66)]
    assert tqw.lstsq_panel_plan(1848, 1848, f32, 2) == [(0, 1849, 66)]
    assert tqw.qr_panel_columns(2543, 1263, f64) == 10
    assert tqw.lstsq_panel_plan(2543, 1263, f64, 2) == [(0, 1264, 132)]
    assert tqw.lstsq_panel_plan(1847, 1847, f64, 1) == [(0, 1848, 132)]
    assert tqw.lstsq_panel_plan(1848, 1848, f64, 1) == [(0, 925, 132), (925, 1849, 132)]
    assert tqw.qr_panel_plan(1848, 1848, f64, 1) == [(0, 1848, 132)]
    assert tqw.lstsq_panel_plan(1849, 1849, f64, 1) == [(0, 925, 132), (925, 1850, 132)]
    assert tqw.lstsq_panel_plan(2641, 2641, f32, 1) == [(0, 2642, 132)]
    assert len(tqw.lstsq_panel_plan(2642, 2642, f32, 1)) == 2
    assert tqw.lstsq_panel_plan(12, 12, f64, 4, width=4) == [(0, 4, 4), (4, 7, 3), (7, 10, 3),
                                                             (10, 13, 3)]
    for m, n, dtype, lanes in ((1263, 1263, f64, 2), (1849, 1849, f64, 1), (2543, 1263, f64, 2),
                               (1848, 1848, f32, 2), (5000, 5000, f64, 3), (40, 33, f32, 64)):
        plan = tqw.lstsq_panel_plan(m, n, dtype, lanes)
        assert plan[0][0] == 0 and plan[-1][1] == n + 1
        assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
        for j0, j1, P in plan:
            assert tqw.qr_panel_bytes(m, n, dtype, j1 - j0, P) <= 232448 and 1 <= P <= 132
            assert 1 <= -(-(j1 - j0) // P) * tqw.qr_panel_groups(j1 - j0, P) <= 1024


@pytest.mark.parametrize("m,n,dtype,width", [
    (1263, 1263, torch.float64, None), (1848, 1848, torch.float32, None),
    (2543, 1263, torch.float64, None), (1847, 1847, torch.float64, None),
    (1849, 1849, torch.float64, None), (2642, 2642, torch.float32, None),
    (12, 12, torch.float64, 4), (7, 5, torch.float32, 1), (1, 1, torch.float64, 1)])
def test_lstsq_panel_launches(m, n, dtype, width):
    """The kernels that one call of K2b-p launches, each counted: one a
    panel of ``lstsq_panel_plan``, which has K2a-p's panels where y still
    fits the last (one where ``qr_panel_plan`` has one, at [1263, 1263] f64
    and [1848, 1848] f32), and the back solve; none where K2b-p does not
    take the shape."""
    panels = tqw.qr_panel_bounds(n + 1, width or 132 * min(tqw.qr_panel_columns(m, n, dtype),
                                                           1024))
    want = len(panels) + 1
    assert tqw.lstsq_panel_launches(m, n, dtype, width=width) == want
    if (m, n) in ((1263, 1263), (1848, 1848)) and width is None:
        assert len(tqw.qr_panel_plan(m, n, dtype)) == 1 and want == 2
    if (m, n) == (1849, 1849):
        assert len(tqw.qr_panel_plan(m, n, dtype)) == 2 and want == 3
    assert tqw.lstsq_panel_launches(3, 4, dtype) == 0
    assert tqw.lstsq_panel_launches(14528, 14528, torch.float64) == 0
    assert tqw.lstsq_panel_plan(29056, 29056, torch.float32) == []


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_lstsq_panel.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,width,B", [(12, 12, 4, 3), (20, 13, 5, 5), (9, 9, 2, 2),
                                         (7, 5, 1, 3), (12, 11, 12, 4), (1, 1, 1, 2),
                                         (2, 1, 1, 3), (40, 33, None, 64), (330, 330, None, 2)])
def test_panel_form_bit_equal_to_twin_on_card(m, n, width, B, dtype):
    """K2b-p by a direct call at small panel widths (y alone in the last
    panel at widths of 1), over the plan's CTAs and a CTA a column, on many
    lanes, and at K2b-d's [330, 330, 2], a zero column in the small systems:
    the twin's bits, its launches counted one a kernel."""
    dev = _on_card()
    A, y = (torch.from_numpy(a).to(dev, dtype) for a in _system(29, m, n, B))
    if n < 64:
        A[:, n // 2] = 0.0
    twin = tqw.least_squares_wavefront_reference(A, y)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = tqw.lstsq_panel_launches(m, n, dtype, sms, width)
    for size in (None, min(width, sms)) if width else (None,):
        before = tqw.least_squares_wavefront_panel.launches
        x = tqw.least_squares_wavefront_panel(A, y, size=size, _width=width)
        torch.cuda.synchronize()
        assert tqw.least_squares_wavefront_panel.launches == before + want
        torch.testing.assert_close(x, twin, rtol=0, atol=0, equal_nan=True, msg=f"P={size}")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,B,dtype", [(1263, 1263, 1, torch.float64),
                                         (1848, 1848, 1, torch.float32)])
def test_panel_form_at_its_first_shapes_on_card(m, n, B, dtype):
    """The dispatcher at the first n past K2b-d's range: K2b-p and no other
    form, its kernels counted, x the twin's bits (the twin run on the card;
    its back solve alone is some n^2 eager launches, seconds)."""
    dev = _on_card()
    A, y = (torch.from_numpy(a).to(dev, dtype) for a in _system(30, m, n, B))
    forms = (tqw.least_squares_wavefront_distributed, tqw.least_squares_wavefront_panel,
             tqw.least_squares_wavefront_global)
    before = [f.launches for f in forms]
    x = tqw.least_squares_wavefront_kernel(A, y)
    torch.cuda.synchronize()
    want = tqw.lstsq_panel_launches(m, n, dtype,
                                    torch.cuda.get_device_properties(dev).multi_processor_count)
    assert [f.launches - b for f, b in zip(forms, before)] == [0, want, 0]
    assert torch.equal(x, tqw.least_squares_wavefront_reference(A, y))


@pytest.mark.gpu
def test_panel_form_refuses_what_it_does_not_take_on_card():
    """K2b-p refuses a column of m words that no CTA holds beside a stage's
    coefficients, a panel that P CTAs do not hold, and half precision; the
    dispatcher names K2b-g past its range."""
    dev = _on_card()
    A, y = (torch.zeros((30000, 2, 1), device=dev, dtype=torch.float64),
            torch.zeros((30000, 1), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="does not fit a block's shared memory"):
        tqw.least_squares_wavefront_panel(A, y)
    assert tqw.least_squares_form(30000, 1300, torch.float64) == "global"
    A, y = torch.randn((400, 300, 2), device=dev), torch.randn((400, 2), device=dev)
    with pytest.raises(ValueError, match="CTAs' shared memory"):
        tqw.least_squares_wavefront_panel(A, y, size=1)
    with pytest.raises(ValueError, match="float32 or float64"):
        tqw.least_squares_wavefront_panel(A.half(), y.half())
