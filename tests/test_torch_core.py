"""nlsolver_torch.core against nlsolver_tpu.core on the same inputs (f64)."""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolver_torch import core as tc
from nlsolver_tpu import core as jc

torch.set_num_threads(1)
RTOL = 1e-12


class Toy(NamedTuple):
    x: object       # [B, 2]
    count: object   # [B]
    done: object    # [B]


def _toy_step(limit):
    # written once for both packages: only operators, no library calls
    def step(s):
        x = s.x + 1.0
        count = s.count + 1
        return Toy(x, count, count >= limit)
    return step


def _toy_state(rng, B=6):
    x = rng.standard_normal((B, 2))
    return x, np.zeros(B, np.int32), np.zeros(B, bool)


@pytest.mark.parametrize("shape,axis", [((7,), -1), ((4, 9), 1), ((5, 3), 0)])
def test_std_err(shape, axis):
    s = np.random.default_rng(0).standard_normal(shape)
    got = tc.std_err(torch.from_numpy(s), dim=axis).numpy()
    want = np.asarray(jc.std_err(jnp.asarray(s), axis=axis))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_where_lanes_matches_tree_where():
    rng = np.random.default_rng(1)
    a = [rng.standard_normal((5, 3, 2)), rng.integers(0, 9, 5).astype(np.int32)]
    b = [rng.standard_normal((5, 3, 2)), rng.integers(0, 9, 5).astype(np.int32)]
    pred = rng.random(5) < 0.5

    class Pair(NamedTuple):
        m: object
        k: object

    got = tc.where_lanes(
        torch.from_numpy(pred), Pair(*map(torch.from_numpy, a)), Pair(*map(torch.from_numpy, b))
    )
    want = jc.tree_where(jnp.asarray(pred), Pair(*map(jnp.asarray, a)), Pair(*map(jnp.asarray, b)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_where_lanes_takes_host_fields_from_advanced_state():
    class S(NamedTuple):
        v: object
        generation: int

    old, new = S(torch.zeros(3), 4), S(torch.ones(3), 5)
    out = tc.where_lanes(torch.tensor([True, False, True]), old, new)
    assert out.generation == 5
    assert out.v.tolist() == [0.0, 1.0, 0.0]


class _One(NamedTuple):
    v: object


@pytest.mark.parametrize("shape", [(1, 4), (3,), (2, 4)])
def test_where_lanes_refuses_fields_that_do_not_lead_with_the_lanes(shape):
    """A batch-minor field ([1, B] or [n, B]) would broadcast against the
    lanes or select along the wrong axis: it raises instead."""
    pred = torch.tensor([True, False, True, False])
    with pytest.raises(ValueError, match="does not lead with the lane axis"):
        tc.where_lanes(pred, _One(torch.zeros(shape)), _One(torch.ones(shape)))
    # one instance: a 0-d predicate selects whole fields of any shape
    out = tc.where_lanes(torch.tensor(True), _One(torch.zeros(shape)), _One(torch.ones(shape)))
    assert torch.equal(out.v, torch.zeros(shape))


def test_where_lanes_selects_rows_of_a_square_field():
    """[n, B] with n == B passes the shape check, and where_lanes takes its
    ROWS as lanes: a batch-minor fleet selects with its own trailing-lane
    helper (solvers/nlls_fleet.py:_lane_where), which takes the columns."""
    from nlsolver_torch.solvers.nlls_fleet import _lane_where

    pred = torch.tensor([True, False])
    a, b = torch.zeros(2, 2), torch.ones(2, 2)
    assert tc.where_lanes(pred, _One(a), _One(b)).v.tolist() == [[0.0, 0.0], [1.0, 1.0]]
    assert _lane_where(pred, _One(a), _One(b)).v.tolist() == [[0.0, 1.0], [0.0, 1.0]]


def test_drive_scan_freezes_finished_lanes():
    x, count, done = _toy_state(np.random.default_rng(2))
    limit = np.array([1, 2, 3, 5, 8, 13], np.int32)
    j = jc.drive_scan(_toy_step(jnp.asarray(limit)), Toy(*map(jnp.asarray, (x, count, done))), 6)
    t = tc.drive_scan(
        _toy_step(torch.from_numpy(limit)), Toy(*map(torch.from_numpy, (x, count, done))), 6
    )
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=RTOL)
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    np.testing.assert_array_equal(t.done.numpy(), np.asarray(j.done))
    # lanes stop at their own limit, capped by the trip count
    np.testing.assert_array_equal(t.count.numpy(), np.minimum(limit, 6))


def test_drive_fleet_scan_runs_fixed_trips():
    x, count, done = _toy_state(np.random.default_rng(3))
    s = tc.drive_fleet_scan(
        _toy_step(torch.tensor(2)), Toy(*map(torch.from_numpy, (x, count, done))), 4
    )
    assert s.count.tolist() == [4] * 6


@pytest.mark.parametrize("check_every", [1, 3, 16])
def test_drive_stops_when_every_lane_is_done(check_every):
    x, count, done = _toy_state(np.random.default_rng(4))
    limit = np.array([2, 4, 7, 7, 1, 5], np.int32)
    # the JAX driver runs one instance; vmap it over the lanes
    j = jax.vmap(lambda s, lim: jc.drive(_toy_step(lim), s))(
        Toy(*map(jnp.asarray, (x, count, done))), jnp.asarray(limit)
    )
    calls = []

    def step(s):
        calls.append(1)
        return _toy_step(torch.from_numpy(limit))(s)

    t = tc.drive(step, Toy(*map(torch.from_numpy, (x, count, done))), check_every=check_every)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=RTOL)
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    assert bool(t.done.all())
    # the host looks every check_every steps: at most check_every - 1 extra
    assert 7 <= len(calls) < 7 + check_every


def test_drive_max_steps_caps_the_run():
    x, count, done = _toy_state(np.random.default_rng(5))
    t = tc.drive(
        _toy_step(torch.tensor(100)), Toy(*map(torch.from_numpy, (x, count, done))),
        check_every=4, max_steps=10,
    )
    assert t.count.tolist() == [10] * 6


def test_make_result_matches_jax():
    rng = np.random.default_rng(6)
    x, f = rng.standard_normal((4, 3)), rng.standard_normal(4)
    it, nf = rng.integers(0, 50, 4), rng.integers(0, 500, 4)
    conv = rng.random(4) < 0.5
    j = jc.make_result(jnp.asarray(x), jnp.asarray(f), it, nf, converged=conv)
    t = tc.make_result(torch.from_numpy(x), torch.from_numpy(f), it, nf, converged=conv)
    assert t._fields == j._fields
    for name in j._fields:
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=RTOL)
    summed = t.add(t)
    assert summed.iterations.tolist() == (2 * it).tolist()


def test_objective_helpers():
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((5, 3))
    fn = lambda x: (x * x).sum(-1)  # noqa: E731
    t = torch.from_numpy(xs)
    np.testing.assert_allclose(tc.batch_eval(fn, t).numpy(), (xs * xs).sum(-1), rtol=RTOL)
    np.testing.assert_allclose(tc.signed(fn, False)(t).numpy(), -(xs * xs).sum(-1), rtol=RTOL)
    assert tc.with_eval_dtype(fn, torch.float32)(t).dtype == torch.float64
    with pytest.raises(ValueError, match="last axis"):
        tc.batch_eval(lambda x: x, t)
    lo, hi, bounded = tc.resolve_bounds(tc.Bounds(-1.0, 2.0), t)
    jlo, jhi, jb = jc.resolve_bounds(jc.Bounds(-1.0, 2.0), jnp.asarray(xs))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert bounded and jb
    lo, hi, bounded = tc.resolve_bounds(None, t)
    assert not bounded and bool(torch.isinf(lo).all()) and bool((hi > 0).all())
    np.testing.assert_array_equal(
        tc.clamp(t, -0.5, 0.5).numpy(), np.asarray(jc.clamp(jnp.asarray(xs), -0.5, 0.5))
    )
    assert float(tc.max_abs(t)) == float(jc.max_abs(jnp.asarray(xs)))


def test_jax_is_cpu():
    # the references run on the CPU in x64, the port in f64 beside them
    assert jax.default_backend() == "cpu"
    assert jnp.asarray(1.0).dtype == jnp.float64


def test_objective_contract_takes_what_jax_users_write():
    """``batch_eval`` scores a batch through vmap, so every single-point
    objective a JAX user writes works, each point seen alone: indexing
    (x[0], x[1]), slices, reductions with and without an axis, a dot, a
    norm, the shape, a where, and the problems' registry; at B = n too,
    where a whole-batch call of x[0] would return a row."""
    from nlsolver_torch import PROBLEMS

    objectives = {
        "index": (lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2,
                  lambda x: 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2),
        "slices": (lambda x: ((x[1:] - x[:-1] ** 2) ** 2).sum(),
                   lambda x: jnp.sum((x[1:] - x[:-1] ** 2) ** 2)),
        "sum": (lambda x: x.sum(), lambda x: jnp.sum(x)),
        "sum_last": (lambda x: (x * x).sum(-1), lambda x: jnp.sum(x * x, axis=-1)),
        "ellipsis": (lambda x: x[..., 0] * x[..., 1], lambda x: x[..., 0] * x[..., 1]),
        "dot": (lambda x: x @ x, lambda x: x @ x),
        "norm": (lambda x: torch.linalg.norm(x), lambda x: jnp.linalg.norm(x)),
        "shape": (lambda x: x.shape[0] * x.max(), lambda x: x.shape[0] * jnp.max(x)),
        "where": (lambda x: torch.where(x[0] > 0, x[1], -x[1]),
                  lambda x: jnp.where(x[0] > 0, x[1], -x[1])),
    }
    rng = np.random.default_rng(3)
    for shape in ((2, 2), (5, 3)):
        xs = rng.standard_normal(shape)
        t = torch.from_numpy(xs)
        for name, (tf, jf) in objectives.items():
            got = tc.batch_eval(tf, t).numpy()
            want = np.asarray(jax.vmap(jf)(jnp.asarray(xs)))
            assert got.shape == shape[:1], name
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)
            np.testing.assert_allclose(got, [float(tf(row)) for row in t], rtol=1e-15,
                                       err_msg=name)
        for name, prob in PROBLEMS.items():
            if prob.dim in (0, shape[1]):
                got = tc.batch_eval(prob.fn, t).numpy()
                np.testing.assert_allclose(got, [float(prob.fn(row)) for row in t], rtol=1e-15,
                                           err_msg=name)


@pytest.mark.parametrize("with_data", [False, True])
def test_lanes_points_score_each_lanes_points(with_data):
    """``Lanes.points`` ([B, K, n] -> [B, K]) against the objective called
    point by point, with per-lane data and without."""
    from nlsolver_torch.core.lanes import Lanes

    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.standard_normal((4, 5, 3)))
    c = torch.from_numpy(rng.standard_normal((4, 3)))
    if with_data:
        lanes = Lanes(lambda x, d: ((x - d) ** 2).sum(), c)
        want = torch.stack([torch.stack([((X[b, k] - c[b]) ** 2).sum() for k in range(5)])
                            for b in range(4)])
    else:
        lanes = Lanes(lambda x: (x ** 2).sum() + x[0])
        want = torch.stack([torch.stack([(X[b, k] ** 2).sum() + X[b, k, 0] for k in range(5)])
                            for b in range(4)])
    assert torch.equal(lanes.points(X), want)


def test_vertex_sum_adds_in_index_order_as_jax_sums():
    """The simplex's vertices added in index order equal ``jnp.sum`` over
    the vertex axis bit for bit on the CPU (the order the card keeps too)."""
    from nlsolver_torch.solvers.nelder_mead import vertex_sum

    rng = np.random.default_rng(4)
    X = rng.standard_normal((64, 6, 5)) * np.logspace(-8, 8, 6)[None, :, None]
    want = np.asarray(jax.vmap(lambda s: jnp.sum(s, axis=0))(X))
    np.testing.assert_array_equal(vertex_sum(torch.from_numpy(X)).numpy(), want)
