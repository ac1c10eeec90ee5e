"""nlsolver_torch.linesearch against nlsolver_tpu.linesearch (f64 on the
CPU): ``cstep`` on a grid of injected cases, the scalar and the fleet
More-Thuente searches, and the speculative grid search; alpha at rtol
1e-12, ``nfev`` and ``info`` equal.  Inputs are drawn with numpy and fed
to both packages.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolver_torch.linesearch import speculative as tsp
from nlsolver_torch.solvers.bfgs_fleet import grad_colwise as t_grad_colwise
from nlsolver_tpu.linesearch import speculative as jsp
from nlsolver_tpu.solvers.bfgs_fleet import grad_colwise as j_grad_colwise

# the packages export a function under the module's name: take the modules
tm = importlib.import_module("nlsolver_torch.linesearch.more_thuente")
jm = importlib.import_module("nlsolver_tpu.linesearch.more_thuente")
torch.set_num_threads(1)
CSTEP_OUT = ("stx", "fx", "dx", "sty", "fy", "dy", "stp", "brackt", "ok")


def _cstep_cases(seed, N, dtype=np.float64):
    """Injected cstep inputs: mostly valid (dx points from stx toward stp,
    stp inside a bracket), some that trip each clause of the input check."""
    rng = np.random.default_rng(seed)
    stx, sty = rng.uniform(0.0, 2.0, N), rng.uniform(0.0, 2.0, N)
    brackt = rng.random(N) < 0.5
    inside = np.minimum(stx, sty) + rng.uniform(0.05, 0.95, N) * np.abs(sty - stx)
    stp = np.where(brackt, inside, stx + rng.uniform(0.1, 2.0, N) * rng.choice([-1, 1], N))
    fx, fy, fp = (rng.standard_normal(N) for _ in range(3))
    dx = -np.sign(stp - stx) * rng.uniform(0.1, 2.0, N)
    dy, dp = rng.standard_normal(N), rng.standard_normal(N)
    dp[: N // 8] = np.sign(dx[: N // 8]) * np.abs(dx[: N // 8]) * rng.uniform(1.0, 2.0, N // 8)
    stpmin, stpmax = np.full(N, 1e-15), np.full(N, 1e15)
    bad = rng.random(N)
    dx = np.where(bad < 0.05, -dx, dx)                       # wrong slope sign
    stp = np.where((bad >= 0.05) & (bad < 0.1) & brackt, np.maximum(stx, sty) + 0.5, stp)
    flip = (bad >= 0.1) & (bad < 0.15)                       # stpmax < stpmin
    stpmin, stpmax = np.where(flip, 1.0, stpmin), np.where(flip, 0.5, stpmax)
    tight = (bad >= 0.15) & (bad < 0.25)                     # bounds that clip stpf
    stpmin = np.where(tight, np.minimum(stx, sty), stpmin)
    stpmax = np.where(tight, np.maximum(stx, sty), stpmax)
    floats = [a.astype(dtype) for a in (stx, fx, dx, sty, fy, dy, stp, fp, dp)]
    return (*floats, brackt, stpmin.astype(dtype), stpmax.astype(dtype))


def _cases_hit(args):
    stx, fx, dx, _, _, _, stp, fp, dp, brackt, stpmin, stpmax = args
    sgnd = dp * np.sign(dx)
    c1 = fp > fx
    c2 = ~c1 & (sgnd < 0)
    c3 = ~c1 & ~c2 & (np.abs(dp) < np.abs(dx))
    return c1, c2, c3, ~(c1 | c2 | c3)


@pytest.mark.parametrize("seed", [0, 1])
def test_cstep_matches_jax_on_injected_cases(seed):
    args = _cstep_cases(seed, 4000)
    want = jax.jit(jm.cstep)(*args)
    got = tm.cstep(*(torch.from_numpy(a) for a in args))
    ok = np.asarray(want[-1])
    for case in _cases_hit(args):  # all four cases, with valid and refused inputs
        assert (case & ok).sum() > 50 and (case & ~ok).sum() > 5
    assert (np.asarray(want[7]) != args[9]).any()            # some brackets closed
    for name, g, w in zip(CSTEP_OUT, got, want):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0, err_msg=name)
    # a refused input leaves everything untouched
    for i in (0, 1, 2, 3, 4, 5, 6, 9):
        out = got[i if i < 7 else 7].numpy()
        np.testing.assert_array_equal(out[~ok], args[i][~ok])


def test_cstep_semantics_sign_of_zero_and_inverted_clip():
    """sign(0) = 0 puts dx == 0 into case 3/4; min(max(x, lo), hi) with
    lo > hi gives hi.  Both as JAX."""
    one = np.ones(1)
    args = (0 * one, one, 0 * one, 0 * one, one, -one, 0.5 * one, 0.5 * one, -0.2 * one,
            np.zeros(1, bool), 2.0 * one, one)
    want = jax.jit(jm.cstep)(*args)
    got = tm.cstep(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(tm._clip(torch.tensor(5.0), torch.tensor(2.0), torch.tensor(1.0))) == 1.0
    assert float(jnp.clip(5.0, 2.0, 1.0)) == 1.0


def _assert_mt_equal(got, want, rtol=1e-12):
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), rtol=rtol, atol=0)
    np.testing.assert_array_equal(got.nfev.numpy(), np.asarray(want.nfev))
    np.testing.assert_array_equal(got.info.numpy(), np.asarray(want.info))
    assert got.nfev.dtype == torch.int32 and got.info.dtype == torch.int32


def _rosen_t(x):
    return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2


@pytest.mark.parametrize("x0,alpha0,alpha_max", [
    ([-0.5, -0.5], 1.0, tm.STPMAX), ([-1.2, 1.0], 1.0, tm.STPMAX),
    ([2.0, -3.0], 4.0, tm.STPMAX), ([-0.5, -0.5], 1.0, 1e-3), ([0.3, 0.9], 0.7, 0.01),
])
def test_more_thuente_scalar_matches_jax(x0, alpha0, alpha_max):
    x = np.asarray(x0)
    jg = jax.grad(_rosen_t)
    g = np.asarray(jg(x))
    want = jax.jit(lambda x, g: jm.more_thuente(_rosen_t, jg, x, _rosen_t(x), g, -g, alpha0,
                                                alpha_max))(x, g)
    tx = torch.from_numpy(x)
    tg = torch.func.grad(_rosen_t)
    got = tm.more_thuente(_rosen_t, tg, tx, _rosen_t(tx), tg(tx), -tg(tx), alpha0, alpha_max)
    _assert_mt_equal(got, want)
    assert int(got.info) >= 1 and float(_rosen_t(tx - got.alpha * tg(tx))) < float(_rosen_t(tx))


def test_more_thuente_scalar_nondescent_returns_initial_alpha():
    quad = lambda x: 0.5 * (x * x).sum()  # noqa: E731
    x = torch.tensor([1.0, 1.0], dtype=torch.float64)
    res = tm.more_thuente(quad, torch.func.grad(quad), x, quad(x), x, x, 0.7)
    assert float(res.alpha) == 0.7 and int(res.info) == -1 and int(res.nfev) == 0


def _quartic_fleet(seed, n, B):
    centers = np.random.default_rng(seed).standard_normal((n, B))
    tc = torch.from_numpy(centers)
    return (lambda X: ((X - tc) ** 2).sum(0) + 0.1 * (X ** 4).sum(0),
            lambda X: jnp.sum((X - centers) ** 2, axis=0) + 0.1 * jnp.sum(X ** 4, axis=0))


@pytest.mark.parametrize("alpha0", [1.0, 8.0, 1e-3])
def test_more_thuente_fleet_matches_jax(alpha0):
    n, B = 6, 32
    t_cols, j_cols = _quartic_fleet(3, n, B)
    X = np.zeros((n, B))
    jgc = j_grad_colwise(j_cols)
    G0 = np.array(jgc(X))
    want = jax.jit(lambda X, G: jm.more_thuente_fleet(j_cols, jgc, X, j_cols(X), G, -G, alpha0))(
        X, G0)
    tX, tG = torch.from_numpy(X), torch.from_numpy(G0)
    tgc = t_grad_colwise(t_cols)
    np.testing.assert_allclose(tgc(tX).numpy(), G0, rtol=1e-14)
    trips = []

    def counted(Xt):
        trips.append(1)
        return t_cols(Xt)

    got = tm.more_thuente_fleet(counted, tgc, tX, t_cols(tX), tG, -tG, alpha0)
    _assert_mt_equal(got, want)
    assert len(trips) == int(got.nfev.max())    # no trip after the last lane's code
    if alpha0 == 8.0:  # lanes finish on different trips, so some are frozen for a while
        assert len(set(got.nfev.tolist())) > 1


def test_more_thuente_fleet_alpha_per_lane_and_nondescent_lane_bails():
    n, B = 3, 4
    X = np.ones((n, B))
    G0 = 2.0 * X
    D = -G0.copy()
    D[:, 0] = G0[:, 0]                                       # lane 0 ascends
    alpha0 = np.array([1.0, 0.5, 2.0, 0.1])
    j_cols = lambda Xc: jnp.sum(Xc ** 2, axis=0)  # noqa: E731
    t_cols = lambda Xc: (Xc ** 2).sum(0)  # noqa: E731
    want = jm.more_thuente_fleet(j_cols, j_grad_colwise(j_cols), X, j_cols(X), G0, D, alpha0)
    got = tm.more_thuente_fleet(t_cols, t_grad_colwise(t_cols), *(torch.from_numpy(a) for a in (
        X, np.array(j_cols(X)), G0, D, alpha0)))
    _assert_mt_equal(got, want)
    assert int(got.info[0]) == -1 and int(got.nfev[0]) == 0 and float(got.alpha[0]) == 1.0
    assert got.info[1:].tolist() == [1, 1, 1]


def _bowls(seed, n, B):
    rng = np.random.default_rng(seed)
    centers, scales = rng.standard_normal((n, B)), rng.uniform(0.5, 3.0, (n, B))
    tc, ts = torch.from_numpy(centers), torch.from_numpy(scales)
    return (lambda X: (ts * (X - tc) ** 2).sum(0),
            lambda X: jnp.sum(scales * (X - centers) ** 2, axis=0))


@pytest.mark.parametrize("grid", [tsp.DEFAULT_GRID, (0.25, 1.0, 3.0)])
def test_speculative_fleet_matches_jax_on_per_lane_data(grid):
    """The bowls close over [n, B] data: the K trial fleets must each see
    lane-aligned columns (a [n, K*B] reshape would not)."""
    n, B = 5, 40
    t_cols, j_cols = _bowls(4, n, B)
    X = np.random.default_rng(5).standard_normal((n, B))
    jgc = j_grad_colwise(j_cols)
    G0 = np.array(jgc(X))
    D = -G0.copy()
    D[:, 3] = G0[:, 3]                                       # one ascending lane
    want = jax.jit(lambda X, G, D: jsp.speculative_fleet(j_cols, jgc, X, j_cols(X), G, D, 1.0,
                                                         grid=grid))(X, G0, D)
    tX, tG, tD = (torch.from_numpy(a) for a in (X, G0, D))
    got = tsp.speculative_fleet(t_cols, t_grad_colwise(t_cols), tX, t_cols(tX), tG, tD, 1.0,
                                grid=grid)
    _assert_mt_equal(got, want)
    assert got.nfev.tolist() == [0 if b == 3 else len(grid) for b in range(B)]
    assert int(got.info[3]) == -1 and len(set(got.info.tolist())) >= 2
    # the chosen step improves every descending lane
    better = t_cols(tX + got.alpha * tD) < t_cols(tX)
    assert bool(better[torch.arange(B) != 3].all())


def test_speculative_tiers_and_zero_step():
    """Acceptance tiers against JAX: Wolfe on a smooth bowl; alpha = 0
    (info 6) where no grid point improves; improvement-only (3); ties of
    the lowest value go to the first grid index."""
    quad_t = lambda X: (X * X).sum(0)  # noqa: E731
    quad_j = lambda X: jnp.sum(X * X, axis=0)  # noqa: E731
    grad_t, grad_j = (lambda X: 2.0 * X), (lambda X: 2.0 * X)

    def both(X, G, D, grid=tsp.DEFAULT_GRID):
        want = jsp.speculative_fleet(quad_j, grad_j, X, quad_j(X), G, D, 1.0, grid=grid)
        got = tsp.speculative_fleet(quad_t, grad_t, *(torch.from_numpy(a) for a in (
            X, np.array(quad_j(X)), G, D)), 1.0, grid=grid)
        _assert_mt_equal(got, want)
        return got

    X = np.array([[1.0], [1.0]])
    res = both(X, 2.0 * X, -2.0 * X)
    assert int(res.info[0]) == 1 and float(res.alpha[0]) == 0.5
    # at the minimum, with a slope flagged as descent: no step improves
    res0 = both(np.zeros((2, 1)), np.array([[-1e-30], [0.0]]), np.array([[1.0], [0.0]]))
    assert int(res0.info[0]) == 6 and float(res0.alpha[0]) == 0.0
    # a grid that only overshoots: Armijo alone, then improvement alone
    res2 = both(X, 2.0 * X, -2.0 * X, grid=(0.95,))
    assert int(res2.info[0]) == 2 and float(res2.alpha[0]) == 0.95
    res3 = both(X, 2.0 * X, -2.0 * X, grid=(0.99999,))
    assert int(res3.info[0]) == 3 and float(res3.alpha[0]) == 0.99999
    # 0.25 and 0.75 give the same f along -G from (1, 1): the first wins
    tie = both(X, 2.0 * X, -2.0 * X, grid=(0.75, 0.25))
    assert float(tie.alpha[0]) == 0.75
    assert int(both(X, 2.0 * X, 2.0 * X).info[0]) == -1      # ascent: bail-out
