"""nlsolver_torch's Nelder-Mead on lane tensors against ``jax.vmap`` of the
JAX solver, lane by lane, in float64 on the CPU: both variants at n = 2, 3
and 5, a fixed initial step, a box, restarts and a max_iter that cuts the
Rosenbrock lanes short; against the JAX ``minimize`` on one point; its
initial simplex, its "second worst" helpers, and a state carried across
the packages.

The lanes (tests/torch_free_common.py): bowls, Rosenbrock, a Rastrigin
start, and a flat lane that halts at its first step.  ``iterations``,
``function_calls`` and ``converged`` are equal lane by lane, and ``x`` and
``f_value`` agree within ``XTOL`` relative to max(|value|, 1): the jitted
JAX program contracts ``a * b + c`` into fused multiply-adds, which moves
the simplex's last bits (some 1e-12 at most was read here), and on these
lanes that changed no branch and no stop.  No lane's counters differ, so
no lane needs the op-by-op reading of ``jax.disable_jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_free_common import B, j_objective, jax_vmapped, lanes, t_objective, torch_data
from torch_lanes_common import COUNTERS, fields, hold

import nlsolver_torch as nt
from nlsolver_torch.solvers import nelder_mead as tn
from nlsolver_tpu.solvers import nelder_mead as jn

torch.set_num_threads(1)

XTOL = 1e-9
# case -> (n, config keyword arguments, bounds (lower, upper) or None)
CASES = {
    "textbook_n2": (2, {}, None),
    "textbook_n3": (3, {}, None),
    "textbook_n5": (5, {}, None),
    "reference_n2": (2, {"variant": "reference"}, None),
    "reference_n3": (3, {"variant": "reference"}, None),
    "reference_n5": (5, {"variant": "reference"}, None),
    "fixed_step": (3, {"step": 0.5}, None),
    "fixed_step_reference": (3, {"step": 0.5, "variant": "reference"}, None),
    "boxed": (3, {}, (-1.0, 0.8)),
    "restarts": (3, {"restarts": 2}, None),
    "max_iter": (3, {"max_iter": 60}, None),
}


@pytest.fixture(scope="module")
def runs():
    out = {}

    def get(case):
        if case not in out:
            n, kw, box = CASES[case]
            x0, k, c, w = lanes(n)
            args = (x0, k, c, w)
            tb = None
            if box is not None:
                lo, hi = (np.full_like(x0, v) for v in box)
                args += (lo, hi)
                tb = nt.Bounds(torch.from_numpy(lo), torch.from_numpy(hi))
            want = fields(jax_vmapped(jn.minimize, jn.NelderMeadConfig(**kw), keyed=False,
                                      bounded=box is not None)(*args))
            got = fields(tn.minimize_batched(t_objective, torch.from_numpy(x0),
                                             tn.NelderMeadConfig(**kw), tb,
                                             data=torch_data(k, c, w)))
            out[case] = (got, want)
        return out[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_vmap_lane_by_lane(case, runs):
    got, want = runs(case)
    hold(got, want, 0, XTOL)


def test_flat_lane_halts_at_once_and_max_iter_cuts_short(runs):
    """The flat lane stops on the spread test before its first step; with
    max_iter=60 the Rosenbrock lanes run to it, not converged, as in JAX."""
    got, _ = runs("textbook_n3")
    assert got["iterations"][5] == 0 and got["converged"][5]
    assert got["function_calls"][5] == 4
    cut, want = runs("max_iter")
    rosen = np.nonzero(np.array([0, 0, 1, 1, 2, 3, 0, 1]) == 1)[0]
    assert (cut["iterations"][rosen] == 60).all() and not cut["converged"][rosen].any()
    assert (want["iterations"][rosen] == 60).all()


def test_boxed_lanes_stay_in_their_box(runs):
    got, _ = runs("boxed")
    assert ((got["x"] >= -1.0) & (got["x"] <= 0.8)).all()


@pytest.mark.parametrize("variant", ["textbook", "reference"])
def test_single_point_matches_jax(variant):
    """``minimize(fn, x0[n])``, the lane engine at B = 1, against the JAX
    ``minimize`` on a Rosenbrock lane, and ``maximize`` of -f the same."""
    x0, k, c, w = lanes(3)
    lane = 3
    cfg = {"variant": variant}
    want = fields(jax.jit(lambda x: jn.minimize(
        lambda p: j_objective(p, k[lane], c[lane], w[lane]), x, jn.NelderMeadConfig(**cfg)))(
            x0[lane]))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in (k[lane], c[lane], w[lane]))
    got = fields(tn.minimize(t_objective, torch.from_numpy(x0[lane]), tn.NelderMeadConfig(**cfg),
                             data=data))
    up = fields(tn.maximize(lambda x, d: -t_objective(x, d), torch.from_numpy(x0[lane]),
                            tn.NelderMeadConfig(**cfg), data=data))
    for f in got:
        assert got[f].shape == want[f].shape, f
    for res in (got, up):
        for f in COUNTERS:
            assert res[f] == want[f], f
        np.testing.assert_allclose(res["x"], want["x"], rtol=0, atol=XTOL)
    np.testing.assert_allclose(got["f_value"], want["f_value"], rtol=0, atol=XTOL)
    np.testing.assert_allclose(up["f_value"], -want["f_value"], rtol=0, atol=XTOL)


def test_readme_example_through_the_default_method():
    """``minimize(rosen, [-0.5, -0.5])`` with no method named: Nelder-Mead,
    as in the JAX package's README example."""
    import nlsolver_tpu as nj

    def rosen_j(x):
        return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2

    def rosen_t(x):
        return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2

    want = fields(nj.minimize(rosen_j, np.array([-0.5, -0.5])))
    got = fields(nt.minimize(rosen_t, torch.tensor([-0.5, -0.5], dtype=torch.float64)))
    for f in COUNTERS:
        assert got[f] == want[f], f
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=XTOL)
    assert float(got["f_value"]) < 1e-8


def test_config_fields_match_jax():
    def spec(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert spec(jn.NelderMeadConfig) == spec(tn.NelderMeadConfig)


@pytest.mark.parametrize("variant", ["textbook", "reference"])
@pytest.mark.parametrize("step", [-1.0, 0.25])
def test_init_simplex_matches_jax(variant, step):
    """The Gao/Han simplex (scale clip(max |x0|, 1, 10)) and the fixed
    step, both variants, on starts whose largest entry lies below 1,
    between 1 and 10 and above 10."""
    rng = np.random.default_rng(1)
    for n in (1, 2, 4):
        x0 = rng.uniform(-1.0, 1.0, (3, n)) * np.array([0.5, 4.0, 30.0])[:, None]
        want = np.asarray(jax.vmap(lambda x: jn.init_simplex(x, step, variant))(x0))
        got = tn.init_simplex(torch.from_numpy(x0), step, variant).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_second_worst_helpers_match_jax():
    """Both "second worst" scores on scores with ties, the worst first,
    last and in between."""
    scores = np.array([[3.0, 1.0, 3.0, 2.0], [1.0, 2.0, 0.5, 2.0], [4.0, 4.0, 4.0, 4.0],
                       [0.0, 1.0, 2.0, 5.0], [5.0, 1.0, 2.0, 0.0]])
    worst = scores.argmax(axis=1)
    for jf, tf in ((jn._second_worst_score, tn._second_worst_score),
                   (jn._reference_second_worst_score, tn._reference_second_worst_score)):
        want = np.asarray(jax.vmap(jf)(scores, worst.astype(np.int32)))
        got = tf(torch.from_numpy(scores), torch.from_numpy(worst)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant,before", [("textbook", 0), ("reference", 6)])
def test_states_cross_packages(variant, before):
    """A JAX state after ``before`` vmapped steps, carried into the port by
    ``interop``, stepped once by each package: the same state, back as
    numpy.  A lane shrinks on the step taken (the first in the textbook
    variant, the seventh in the reference's)."""
    from nlsolver_torch import interop

    x0, k, c, w = lanes(3)
    cfg = jn.NelderMeadConfig(variant=variant)
    lo = jnp.full((3,), -jnp.inf)

    def steps(x, kk, cc, ww):
        f = lambda p: j_objective(p, kk, cc, ww)  # noqa: E731
        s = jn.init(f, x, cfg)
        for _ in range(before):
            s = jn.step(f, s, cfg, lo, -lo, False)
        return s, jn.step(f, s, cfg, lo, -lo, False)

    s1, s2 = jax.jit(jax.vmap(steps))(x0, k, c, w)
    carried = {f: np.asarray(v) for f, v in s1._asdict().items()}
    ts = interop.nm_state_from_numpy(carried, "cpu")
    inf = torch.full((B, 3), torch.inf, dtype=torch.float64)
    back = interop.nm_state_to_numpy(tn.step(t_objective, ts, tn.NelderMeadConfig(variant=variant),
                                             -inf, inf, False, data=torch_data(k, c, w)))
    assert set(back) == set(carried)
    assert np.asarray(s2.shrunk).any()
    for f, v in back.items():
        want = np.asarray(getattr(s2, f))
        assert v.dtype == want.dtype, f
        np.testing.assert_allclose(v, want, rtol=1e-12, atol=1e-12, err_msg=f)
