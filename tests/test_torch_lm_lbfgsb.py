"""nlsolver_torch's LM (damped Hessian) and L-BFGS-B on lane tensors
against ``jax.vmap`` of the JAX solvers, lane by lane, in float64 on the
CPU, and against the JAX ``minimize`` on one point; LM's two solves; the
states carried across packages.

The lanes are those of tests/torch_lanes_common.py (bowls, Rosenbrock, a
Rastrigin start).  As read on the CPU (jax 0.9.0, torch 2.13.0+cpu), every
lane's counters and converged flag are equal in every case here, and x
agrees within ``XTOL``; LM's Rosenbrock lane 3 leaves the region where its
first damped Hessian is positive definite and ends in NaN in both packages
after two iterations.  L-BFGS-B runs unbounded and in the box [-0.5, 0.5],
which binds on most lanes (every Rosenbrock minimum lies outside it).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_lanes_common import (B, COUNTERS, N, fields, hold, j_objective, jax_batched, lanes,
                                t_objective, torch_data)

import nlsolver_torch as nt
from nlsolver_torch import interop
from nlsolver_torch.solvers import lbfgsb as tlb
from nlsolver_torch.solvers import lm as tlm
from nlsolver_tpu.core import Bounds as JBounds
from nlsolver_tpu.deriv import Deriv as JDeriv
from nlsolver_tpu.solvers import lbfgsb as jlb
from nlsolver_tpu.solvers import lm as jlm

torch.set_num_threads(1)

# case id -> (JAX module, port module, config kwargs, bounded)
CASES = {
    "lm": (jlm, tlm, {}, False),
    "lm_reference": (jlm, tlm, {"variant": "reference"}, False),
    "lm_fd": (jlm, tlm, {"deriv": "fd"}, False),
    "lm_factorize": (jlm, tlm, {"diagonal": False}, False),
    "lbfgsb": (jlb, tlb, {}, False),
    "lbfgsb_box": (jlb, tlb, {}, True),
}
# |x_port - x_jax|: a few ulps; the FD Hessian's 1 / eps^2 amplification
# of one ulp of f aside
XTOL = {"lm_fd": 1e-7}


def configs(jm, tm, kw):
    name = "LMConfig" if jm is jlm else "LBFGSBConfig"
    jkw = {a: (JDeriv(mode="fd") if v == "fd" else v) for a, v in kw.items()}
    tkw = {a: (nt.Deriv(mode="fd") if v == "fd" else v) for a, v in kw.items()}
    return getattr(jm, name)(**jkw), getattr(tm, name)(**tkw)


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_vmap_lane_by_lane(case):
    jm, tm, kw, bounded = CASES[case]
    jc, tc = configs(jm, tm, kw)
    x0, k, c, w = lanes()
    extra_j = {"bounds": JBounds(-0.5, 0.5)} if bounded else {}
    extra_t = {"bounds": nt.Bounds(-0.5, 0.5)} if bounded else {}
    want = fields(jax_batched(jm.minimize, jc, **extra_j)(x0, k, c, w))
    got = fields(tm.minimize_batched(t_objective, torch.from_numpy(x0), tc,
                                     data=torch_data(k, c, w), **extra_t))
    hold(got, want, 0, XTOL.get(case, 1e-9))
    if bounded:
        assert (np.abs(got["x"]) <= 0.5).all()
        assert (np.isclose(np.abs(got["x"]), 0.5)).sum() >= B


@pytest.mark.parametrize("case", ["lm", "lbfgsb_box"])
def test_single_point_matches_jax(case):
    """``minimize(fn, x0[n])`` against the JAX ``minimize`` on the
    Rosenbrock lane 4, and ``maximize`` of -f the same."""
    jm, tm, kw, bounded = CASES[case]
    jc, tc = configs(jm, tm, kw)
    x0, k, c, w = lanes()
    lane = 4
    jkw = {"bounds": JBounds(-0.5, 0.5)} if bounded else {}
    tkw = {"bounds": nt.Bounds(-0.5, 0.5)} if bounded else {}
    want = fields(jax.jit(lambda x: jm.minimize(
        lambda p: j_objective(p, k[lane], c[lane], w[lane]), x, jc, **jkw))(x0[lane]))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in (k[lane], c[lane], w[lane]))
    got = fields(tm.minimize(t_objective, torch.from_numpy(x0[lane]), tc, data=data, **tkw))
    up = fields(tm.maximize(lambda x, d: -t_objective(x, d), torch.from_numpy(x0[lane]), tc,
                            data=data, **tkw))
    for res in (got, up):
        assert res["x"].shape == (N,)
        for f in COUNTERS:
            assert res[f] == want[f], f
        np.testing.assert_allclose(res["x"], want["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(up["f_value"], -want["f_value"], rtol=1e-9, atol=1e-15)


def spd(seed, count, n, diagonal_shift=1.0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((count, n, n))
    return M @ M.transpose(0, 2, 1) + diagonal_shift * np.eye(n), rng.standard_normal((count, n)), \
        rng.uniform(0.01, 10.0, count)


@pytest.mark.parametrize("n", [2, 4, 12])
def test_damped_solves_match_jax(n):
    """(H + lam I) u = g in every lane: the default solve (the unrolled
    Cholesky up to n = 8, a factorization beyond, the per-lane diagonal
    test) and the reference's arithmetic, against ``vmap`` of the JAX
    solves; a Hessian with large negative off-diagonals takes the
    reference's elementwise path there."""
    H, g, lam = spd(n, 16, n)
    H[0] = np.diag(np.arange(1.0, n + 1))          # a diagonal lane
    H[1] = -5.0 * np.ones((n, n)) + 20.0 * np.eye(n)   # negative off-diagonals
    for diagonal in (None, True, False):
        want = np.asarray(jax.vmap(lambda a, b, c: jlm.damped_solve(a, b, c, diagonal=diagonal))(
            H, g, lam))
        got = tlm.damped_solve(*(torch.from_numpy(a) for a in (H, g, lam)),
                               diagonal=diagonal).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    want = np.asarray(jax.vmap(jlm._reference_damped_solve)(H, g, lam))
    got = tlm._reference_damped_solve(*(torch.from_numpy(a) for a in (H, g, lam))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got[1], g[1] / (np.diag(H[1]) + lam[1]), rtol=1e-15)


@pytest.mark.parametrize("cls", ["LMConfig", "LBFGSBConfig"])
def test_config_fields_match_jax(cls):
    jm, tm = (jlm, tlm) if cls == "LMConfig" else (jlb, tlb)

    def spec(c):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else dataclasses.asdict(f.default_factory())) for f in dataclasses.fields(c)]

    assert spec(getattr(jm, cls)) == spec(getattr(tm, cls))


@pytest.mark.parametrize("mod", ["lm", "lbfgsb"])
def test_states_cross_packages(mod):
    """A JAX state after one vmapped step, carried into the port by
    ``interop``, stepped once by each package: the same state."""
    jm, tm = (jlm, tlm) if mod == "lm" else (jlb, tlb)
    jc, tc = configs(jm, tm, {})
    x0, k, c, w = lanes()
    box = (-0.5 * jax.numpy.ones(N), 0.5 * jax.numpy.ones(N)) if mod == "lbfgsb" else ()

    def two(x, kk, cc, ww):
        f = lambda p: j_objective(p, kk, cc, ww)  # noqa: E731
        s = jm.step(f, jm.init(f, x, jc), jc, *box)
        return s, jm.step(f, s, jc, *box)

    s1, s2 = jax.jit(jax.vmap(two))(np.clip(x0, -0.5, 0.5) if box else x0, k, c, w)
    carried = {f: np.asarray(v) for f, v in s1._asdict().items()}
    ts = getattr(interop, f"{mod}_state_from_numpy")(carried, "cpu")
    tbox = tuple(torch.from_numpy(np.broadcast_to(np.asarray(b), (B, N)).copy()) for b in box)
    back = getattr(interop, f"{mod}_state_to_numpy")(
        tm.step(t_objective, ts, tc, *tbox, data=torch_data(k, c, w)))
    assert set(back) == set(carried)
    for f, v in back.items():
        want = np.asarray(getattr(s2, f))
        assert v.dtype == want.dtype, f
        np.testing.assert_allclose(v, want, rtol=1e-12, atol=1e-12, err_msg=f)


def test_lm_refuses_bounds():
    x0 = torch.zeros(2, N, dtype=torch.float64)
    with pytest.raises(ValueError, match="takes no bounds"):
        tlm.minimize_batched(t_objective, x0, bounds=nt.Bounds(-1.0, 1.0))
    with pytest.raises(ValueError, match="takes no bounds"):
        tlm.minimize(t_objective, x0[0], bounds=nt.Bounds(-1.0, 1.0))


def test_lbfgsb_stays_in_a_box_at_the_clipped_center():
    """Separable bowls in a box that binds: the minimum is the clipped
    center, reached in every lane."""
    rng = np.random.default_rng(9)
    c = rng.standard_normal((32, 4)) * 2.0
    got = tlb.minimize_batched(lambda x, cc: ((x - cc) ** 2).sum(),
                               torch.zeros(32, 4, dtype=torch.float64), tlb.LBFGSBConfig(),
                               bounds=nt.Bounds(-1.0, 1.0), data=torch.from_numpy(c))
    np.testing.assert_allclose(got.x.numpy(), np.clip(c, -1.0, 1.0), atol=1e-8)
    assert bool(got.converged.all())
