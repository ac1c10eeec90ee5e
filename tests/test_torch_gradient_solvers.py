"""nlsolver_torch's BFGS, L-BFGS, GD and CGD on lane tensors against
``jax.vmap`` of the JAX solvers, lane by lane, in float64 on the CPU, and
against the JAX ``minimize`` on one point; the Armijo search; the rank-2
update through ``ops.rank2_update_batched`` against the JAX formula.

The lanes (tests/torch_lanes_common.py): bowls with per-lane centers and
weights (the objective's data, ``data=`` in the port), Rosenbrock, and a
Rastrigin start.  ``x`` and ``f_value`` agree within ``XTOL`` on every lane
whose counters agree, and ``iterations``, ``function_calls``,
``gradient_calls`` and ``converged`` are equal lane by lane but on the lanes
``DIFFER`` counts.  Those lanes are rounding, not logic: XLA's CPU compiler
contracts ``a * b + c`` into fused multiply-adds in the jitted JAX program,
and on Rosenbrock's long runs one last bit tips a stopping test.
``test_differing_lanes_are_rounding`` runs the JAX solver op by op on such
a lane (``jax.disable_jit``: nothing fused) and finds the port's counters
there.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_lanes_common import (B, COUNTERS, N, counters_differ, fields, hold, j_objective,
                                jax_batched, lanes, t_objective, torch_data)

import nlsolver_torch as nt
from nlsolver_torch.core.lanes import Lanes
from nlsolver_torch.ops import rank2 as tr
from nlsolver_torch.solvers import bfgs as tb
from nlsolver_tpu.deriv import Deriv as JDeriv
from nlsolver_tpu.solvers import bfgs as jb

torch.set_num_threads(1)

FD = "fd"
# case id -> (module, config kwargs, lanes run); "noros" leaves out the
# Rosenbrock lanes (on them a step of 0.01 diverges), "bowls" keeps the
# bowls alone (on Rastrigin, whose gradient's Lipschitz constant is some
# 400, a fixed step of 0.01 and bigstep's long steps throw the lane from
# basin to basin, where the last bit picks the basin)
CASES = {
    "bfgs": ("bfgs", {}, "all"),
    "bfgs_reference_update": ("bfgs", {"reference_update": True}, "all"),
    "bfgs_fd": ("bfgs", {"deriv": FD}, "all"),
    "lbfgs": ("lbfgs", {}, "all"),
    "gd_fixed": ("gd", {"alpha": 0.01, "max_iter": 150}, "bowls"),
    "gd_fixed_reference": ("gd", {"alpha": 0.01, "max_iter": 60, "variant": "reference"}, "bowls"),
    "gd_linesearch": ("gd", {"step_type": "linesearch", "max_iter": 60}, "all"),
    "gd_bigstep": ("gd", {"step_type": "bigstep", "max_iter": 60}, "bowls"),
    "gd_anneal": ("gd", {"step_type": "anneal", "alpha": 0.01, "max_iter": 80}, "noros"),
    "gd_anneal_safeguarded": ("gd", {"step_type": "anneal", "alpha": 0.01, "max_iter": 80,
                                     "variant": "safeguarded"}, "all"),
    "cgd": ("cgd", {"max_iter": 100}, "all"),
}
# lanes whose counters differ, as read on the CPU (jax 0.9.0, torch
# 2.13.0+cpu): CGD's three Rosenbrock lanes, which run 49 to 100 Armijo
# iterations; the limit is twice the reading
DIFFER_READ = {"cgd": 3}
# |x_port - x_jax| on lanes whose counters agree: a few ulps, the FD
# stencils' 1 / (dd eps) amplification of one ulp of f aside
XTOL = {"bfgs_fd": 1e-7}
PAGE_T = 200   # PAGE draws a lane: max_iter of the PAGE cases


def subset(which):
    x0, k, c, w = lanes()
    keep = {"all": np.ones(B, bool), "noros": k != 1, "bowls": k == 0}[which]
    return x0[keep], k[keep], c[keep], w[keep]


def configs(mod, kw):
    jm = importlib.import_module(f"nlsolver_tpu.solvers.{mod}")
    tm = importlib.import_module(f"nlsolver_torch.solvers.{mod}")
    name = {"bfgs": "BFGSConfig", "lbfgs": "LBFGSConfig", "gd": "GDConfig", "cgd": "CGDConfig"}[mod]
    jkw = {a: (JDeriv(mode="fd") if v == FD else v) for a, v in kw.items()}
    tkw = {a: (nt.Deriv(mode="fd") if v == FD else v) for a, v in kw.items()}
    return jm, tm, getattr(jm, name)(**jkw), getattr(tm, name)(**tkw)


@pytest.fixture(scope="module")
def runs():
    """Each case run once by both packages: (inputs, port, jax)."""
    out = {}

    def get(case):
        if case not in out:
            mod, kw, which = CASES[case]
            jm, tm, jc, tc = configs(mod, kw)
            x0, k, c, w = subset(which)
            want = fields(jax_batched(jm.minimize, jc)(x0, k, c, w))
            got = fields(tm.minimize_batched(t_objective, torch.from_numpy(x0), tc,
                                             data=torch_data(k, c, w)))
            out[case] = ((x0, k, c, w), got, want)
        return out[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_vmap_lane_by_lane(case, runs):
    _, got, want = runs(case)
    hold(got, want, 2 * DIFFER_READ.get(case, 0), XTOL.get(case, 1e-9))


@pytest.mark.parametrize("case", [c for c in CASES if c in DIFFER_READ])
def test_differing_lanes_are_rounding(case, runs):
    """On the differing lane with the fewest iterations, the JAX solver run
    op by op (nothing fused) gives the port's counters."""
    (x0, k, c, w), got, want = runs(case)
    bad = np.nonzero(counters_differ(got, want))[0]
    lane = int(bad[np.argmin(want["iterations"][bad])])
    mod, kw, _ = CASES[case]
    jm, _, jc, _ = configs(mod, kw)
    with jax.disable_jit():
        one = fields(jm.minimize(lambda p: j_objective(p, k[lane], c[lane], w[lane]),
                                 jnp.asarray(x0[lane]), jc))
    for f in COUNTERS:
        assert one[f] == got[f][lane], (lane, f, one[f], got[f][lane], want[f][lane])


def jax_page_draws(keys, T, dtype):
    """JAX's PAGE uniforms a lane, [T, B]: the chain gd.step splits from
    each lane's key (nlsolver_tpu/solvers/gd.py:203-204)."""
    def chain(key):
        def body(key, _):
            key, k_u = jax.random.split(key)
            return key, jax.random.uniform(k_u, (), dtype=dtype)
        return jax.lax.scan(body, key, None, length=T)[1]
    return np.array(jax.vmap(chain)(keys)).T


@pytest.mark.parametrize("variant", ["default", "reference"])
def test_gd_page_with_jax_draws(variant):
    """PAGE against the JAX solver with its own per-lane keys, the port fed
    the uniforms those keys give."""
    from nlsolver_tpu.solvers import gd as jg
    from nlsolver_torch.solvers import gd as tg

    x0, k, c, w = subset("bowls")
    kw = {"step_type": "page", "alpha": 0.01, "max_iter": PAGE_T, "variant": variant}
    keys = jax.random.split(jax.random.key(3), x0.shape[0])
    want = fields(jax.jit(jax.vmap(lambda x, kk, cc, ww, key: jg.minimize(
        lambda p: j_objective(p, kk, cc, ww), x, jg.GDConfig(**kw), key=key)))(x0, k, c, w, keys))
    draws = torch.from_numpy(jax_page_draws(keys, PAGE_T, jnp.float64))
    got = fields(tg.minimize_batched(t_objective, torch.from_numpy(x0), tg.GDConfig(**kw),
                                     draws=draws, data=torch_data(k, c, w)))
    hold(got, want, 0, 1e-9)


@pytest.mark.parametrize("mod", ["bfgs", "lbfgs", "gd", "cgd"])
def test_single_point_matches_jax(mod):
    """``minimize(fn, x0[n])``, the lane engine at B = 1, against the JAX
    ``minimize`` on the Rosenbrock lane 4 (GD and CGD: the bowl lane 0; GD
    at a step that does not diverge there, and lane 4 is CGD's differing
    lane), and ``maximize`` of -f the same."""
    x0, k, c, w = lanes()
    lane = 0 if mod in ("gd", "cgd") else 4
    jm, tm, jc, tc = configs(mod, {"alpha": 0.01, "max_iter": 150} if mod == "gd" else {})
    want = fields(jax.jit(lambda x: jm.minimize(
        lambda p: j_objective(p, k[lane], c[lane], w[lane]), x, jc))(x0[lane]))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in (k[lane], c[lane], w[lane]))
    got = fields(tm.minimize(t_objective, torch.from_numpy(x0[lane]), tc, data=data))
    up = fields(tm.maximize(lambda x, d: -t_objective(x, d), torch.from_numpy(x0[lane]), tc,
                            data=data))
    for f in got:
        assert got[f].shape == want[f].shape == (() if f != "x" else (N,)), f
    for res in (got, up):
        for f in COUNTERS:
            assert res[f] == want[f], f
        np.testing.assert_allclose(res["x"], want["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(up["f_value"], -want["f_value"], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("cls", ["BFGSConfig", "LBFGSConfig", "GDConfig", "CGDConfig"])
def test_config_fields_match_jax(cls):
    mod = {"BFGSConfig": "bfgs", "LBFGSConfig": "lbfgs", "GDConfig": "gd", "CGDConfig": "cgd"}[cls]
    jc = getattr(importlib.import_module(f"nlsolver_tpu.solvers.{mod}"), cls)
    tc = getattr(importlib.import_module(f"nlsolver_torch.solvers.{mod}"), cls)

    def spec(c):
        return [(f.name, f.default if f.default is not dataclasses.MISSING
                 else dataclasses.asdict(f.default_factory())) for f in dataclasses.fields(c)]

    assert spec(jc) == spec(tc)


def test_bigstep_table_matches_jax():
    from nlsolver_tpu.solvers import gd as jg
    from nlsolver_torch.solvers import gd as tg

    assert tg.BIGSTEP_TABLE == jg.BIGSTEP_TABLE and tg.BIGSTEP_OFFSETS == jg.BIGSTEP_OFFSETS


def test_rank2_update_through_ops_matches_jax():
    """BFGS's update as ``bfgs.step`` applies it (``ops.rank2_update_batched``:
    K4c on a card, its twin here) against ``vmap`` of the JAX formula; the
    reference quirk against the JAX quirk."""
    rng = np.random.default_rng(5)
    Bn, n = 64, 5
    M = rng.standard_normal((Bn, n, n))
    H = M @ M.transpose(0, 2, 1) + np.eye(n)
    s, y = rng.standard_normal((2, Bn, n))
    rho = rng.uniform(0.1, 2.0, Bn)
    for quirk in (False, True):
        want = np.asarray(jax.vmap(lambda h, a, b, r: jb.rank2_update(h, a, b, r, quirk))(
            H, s, y, rho))
        plan = tb.update_plan(n, torch.float64, quirk)
        assert plan == ("reference" if quirk else "kernel")
        got = tb._apply_update(*(torch.from_numpy(a) for a in (H, s, y, rho)), plan).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    got = tr.rank2_update_batched(*(torch.from_numpy(a) for a in (H, s, y, rho))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.vmap(jb.rank2_update)(H, s, y, rho)),
                               rtol=1e-12, atol=1e-12)


def test_update_plan_names_the_kernel_range():
    """K4c at every n (``ops.rank2.batched_form`` names its form: K4c-r up
    to n = 32 in float32 and 15 in float64, K4c-w to 48, K4c-g beyond, past
    one instance's block at n = 240 in float32 and 169 in float64 too); the
    quirk formula is its own function at every n."""
    for n, dtype, form in ((16, torch.float32, "rows"), (48, torch.float32, "warp"),
                           (239, torch.float32, "global"), (240, torch.float32, "global"),
                           (16, torch.float64, "warp"), (168, torch.float64, "global"),
                           (169, torch.float64, "global")):
        assert tb.update_plan(n, dtype, False) == "kernel", (n, dtype)
        assert tb.update_plan(n, dtype, True) == "reference"
        assert tr.batched_form(n, dtype) == form, (n, dtype)
    rng = np.random.default_rng(6)
    H = torch.from_numpy(np.tile(np.eye(4), (3, 1, 1)))
    s, y = (torch.from_numpy(rng.standard_normal((3, 4))) for _ in range(2))
    rho = torch.full((3,), 0.5, dtype=torch.float64)
    assert torch.equal(tb._apply_update(H, s, y, rho, "kernel"),
                       tr.rank2_update_batched_reference(H, s, y, rho))


def test_bfgs_past_the_block_matches_jax_vmap():
    """Two 169-D bowls in float64, the first n past one instance's block
    (K4c-g on a card; the twin here): ``minimize_batched`` against
    ``jax.vmap`` of the JAX BFGS, counters equal lane by lane, x within
    1e-9."""
    rng = np.random.default_rng(169)
    n, lanes2 = 169, 2
    x0 = rng.uniform(-2.0, 2.0, (lanes2, n))
    k = np.zeros(lanes2, np.int64)
    c = rng.standard_normal((lanes2, n))
    w = rng.uniform(0.5, 3.0, (lanes2, n))
    cfg = dict(max_iter=30)
    want = fields(jax_batched(jb.minimize, jb.BFGSConfig(**cfg))(x0, k, c, w))
    got = fields(tb.minimize_batched(t_objective, torch.from_numpy(x0), tb.BFGSConfig(**cfg),
                                     data=torch_data(k, c, w)))
    assert tb.update_plan(n, torch.float64, False) == "kernel"
    assert tr.batched_form(n, torch.float64) == "global"
    for f in COUNTERS:
        assert np.array_equal(got[f], want[f]), (f, got[f], want[f])
    assert int(got["iterations"].min()) > 1
    hold(got, want, 0, 1e-9)


@pytest.mark.gpu
def test_bfgs_launches_k4c_once_a_step_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x0, k, c, w = lanes()
    dev = torch.device("cuda")
    data = tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in (k, c, w))
    before = tr.rank2_update_batched_kernel.launches
    res = tb.minimize_batched(t_objective, torch.from_numpy(x0).to(dev), tb.BFGSConfig(), data=data)
    torch.cuda.synchronize()
    assert tr.rank2_update_batched_kernel.launches - before == int(res.iterations.max()) + 1
    cpu = tb.minimize_batched(t_objective, torch.from_numpy(x0), tb.BFGSConfig(),
                              data=torch_data(k, c, w))
    np.testing.assert_allclose(res.x.cpu().numpy(), cpu.x.numpy(), rtol=0, atol=1e-9)


def test_armijo_matches_jax():
    """The lane-batched backtracking against ``vmap`` of the JAX search."""
    from nlsolver_torch.linesearch.armijo import armijo
    from nlsolver_tpu.linesearch.armijo import armijo as jarmijo

    x0, k, c, w = lanes()
    lanes_t = Lanes(t_objective, torch_data(k, c, w))
    g = lanes_t.map(torch.func.grad, torch.from_numpy(x0))
    f0 = lanes_t.values(torch.from_numpy(x0))
    for alpha0 in (1.0, 0.03):
        want = jax.vmap(lambda x, kk, cc, ww, gg: jarmijo(
            lambda p: j_objective(p, kk, cc, ww), x, j_objective(x, kk, cc, ww), gg, -gg,
            alpha0))(x0, k, c, w, g.numpy())
        got = armijo(lanes_t.values, torch.from_numpy(x0), f0, g, -g, alpha0)
        np.testing.assert_array_equal(got.nfev.numpy(), np.asarray(want.nfev))
        np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), rtol=1e-15)
    # a direction of ascent backtracks to the bound of 200 trips (on the
    # Rastrigin lane a long step may land in a lower basin)
    got = armijo(lanes_t.values, torch.from_numpy(x0), f0, g, g, 1.0)
    assert bool((got.nfev[torch.from_numpy(k != 2)] == 201).all())


@pytest.mark.parametrize("mod", ["bfgs", "gd", "cgd"])
def test_unconstrained_solvers_refuse_bounds(mod):
    """The JAX solvers take bounds= and ignore them; the port refuses."""
    tm = importlib.import_module(f"nlsolver_torch.solvers.{mod}")
    x0 = torch.zeros(2, 3, dtype=torch.float64)
    for run in (lambda: tm.minimize(t_objective, x0[0], bounds=nt.Bounds(-1.0, 1.0)),
                lambda: tm.minimize_batched(t_objective, x0, bounds=nt.Bounds(-1.0, 1.0))):
        with pytest.raises(ValueError, match="takes no bounds"):
            run()


def test_lbfgs_box_matches_jax():
    """L-BFGS's projected box mode with per-lane bounds: the bowls boxed
    in [-0.5, 0.5] (binding where a center lies outside), the other lanes
    in [-2, 2]."""
    from nlsolver_tpu.core import Bounds as JBounds
    from nlsolver_tpu.solvers import lbfgs as jl
    from nlsolver_torch.solvers import lbfgs as tl

    x0, k, c, w = lanes()
    lo = np.where((k == 0)[:, None], -0.5, -2.0) * np.ones((B, N))
    hi = -lo
    assert ((c < lo) | (c > hi))[k == 0].any()
    want = fields(jax.jit(jax.vmap(lambda x, kk, cc, ww, a, b: jl.minimize(
        lambda p: j_objective(p, kk, cc, ww), x, jl.LBFGSConfig(), bounds=JBounds(a, b))))(
            x0, k, c, w, lo, hi))
    got = fields(tl.minimize_batched(t_objective, torch.from_numpy(x0), tl.LBFGSConfig(),
                                     bounds=nt.Bounds(torch.from_numpy(lo), torch.from_numpy(hi)),
                                     data=torch_data(k, c, w)))
    hold(got, want, 0, 1e-9)
    assert ((got["x"] >= lo) & (got["x"] <= hi)).all()


@pytest.mark.parametrize("mod", ["bfgs", "lbfgs", "gd", "cgd"])
def test_states_cross_packages(mod):
    """A JAX state after one vmapped step, carried into the port by
    ``interop`` (GD's key dropped), stepped once by each package: the same
    state, back as numpy."""
    from nlsolver_torch import interop

    x0, k, c, w = lanes()
    jm, tm, jc, tc = configs(mod, {"alpha": 0.01} if mod == "gd" else {})
    keys = (jax.random.split(jax.random.key(0), B),) if mod == "gd" else ()

    def two(x, kk, cc, ww, *key):
        f = lambda p: j_objective(p, kk, cc, ww)  # noqa: E731
        s = jm.step(f, jm.init(f, x, jc, *key), jc)
        return s, jm.step(f, s, jc)

    s1, s2 = jax.jit(jax.vmap(two))(x0, k, c, w, *keys)
    carried = {f: np.asarray(v) for f, v in s1._asdict().items() if f != "key"}
    ts = getattr(interop, f"{mod}_state_from_numpy")(carried, "cpu")
    back = getattr(interop, f"{mod}_state_to_numpy")(tm.step(t_objective, ts, tc,
                                                             data=torch_data(k, c, w)))
    assert set(back) == set(carried)
    for f, v in back.items():
        want = np.asarray(getattr(s2, f))
        assert v.dtype == want.dtype, f
        np.testing.assert_allclose(v, want, rtol=1e-12, atol=1e-12, err_msg=f)
