"""nlsolver_torch.solvers.rootfind against ``jax.vmap`` of the JAX
package's finders, lane by lane, in f64 and f32 on the CPU; and against the
C++ reference's iterates (the 78 ``root_*`` rows of
tests/data/reference_trajectories.tsv).

The lanes: 256 of the bench problem cos(x) - c x on [0, 2] (c from 0.1 to
1.9, decreasing through the root), 32 of it on [3, 5] (no root: NaN x, 2
calls), 32 of the decreasing 1 - x of tests/test_scalar.py shifted to d - x
on [0, 3], and 32 increasing ones, c x - cos(x) on [0, 2].

Where the two packages differ the source is rounding, never the logic:
XLA's CPU compiler contracts ``a * b + c`` into fused multiply-adds (in the
objective and in the finders' bodies; it changes the last bit of 23 % of
such f64 results), its ``cos`` differs from torch's in the last bit on some
lanes, and torch's host ``sqrt`` is not correctly rounded on some 0.7 % of
inputs.  ``test_differing_lanes_are_rounding`` shows it on every lane:
JAX run op by op (``jax.disable_jit``: XLA fuses nothing, so it contracts
nothing) and the port fed the same op-by-op objective, with a correctly
rounded sqrt, agree bit for bit on all of them, each lane that differs
fused among them.  The lane-by-lane test then holds each finder to a stated
tolerance: the number of lanes whose counters or converged flag differ at
most twice its reading (``COUNTS_DIFFER``; in f64 none but ITP's, whose
reference variant stops only on ``f(xt) == 0`` exactly or on max_iter, a
test that the last bit decides), and x within ``XTOL``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from trajectory_common import load_golden

import nlsolver_torch as nt
from nlsolver_torch.solvers import rootfind as tr
from nlsolver_tpu.solvers import rootfind as jr

torch.set_num_threads(1)

FINDERS = [
    ("bisection", {}), ("false_position", {}), ("false_position", {"variant": "reference"}),
    ("brent", {}), ("ridders", {}), ("tiruneh", {}), ("itp", {}), ("chandrupatla", {}),
]
IDS = ["bisection", "false_position", "false_position_reference", "brent", "ridders",
       "tiruneh", "itp", "chandrupatla"]
NB, NU, ND, NI = 256, 32, 32, 32   # bench, unbracketed, decreasing d - x, increasing lanes

# |x_port - x_jax| on every bracketed lane, from the rounding above: a few
# ulps in f64 where the iterations agree; tiruneh returns the oldest point
# of its window, which a last-bit difference moves further; ITP's lanes that
# run to max_iter stop at the midpoint of a bracket that stagnates at one
# end, so their x is only as good as that bracket (2e-6 in f64, 6e-4 in f32)
XTOL = {
    "float64": {"bisection": 0.0, "false_position": 1e-15, "false_position_reference": 1e-15,
                "brent": 1e-15, "ridders": 1e-15, "tiruneh": 1e-13, "itp": 5e-6,
                "chandrupatla": 1e-15},
    "float32": {"bisection": 2e-6, "false_position": 5e-7, "false_position_reference": 5e-7,
                "brent": 5e-7, "ridders": 5e-7, "tiruneh": 1e-3, "itp": 1e-3,
                "chandrupatla": 5e-7},
}
# lanes (of the 352) whose iterations, function calls or converged flag
# differ between the packages, as read on the CPU (jax 0.9.0, torch
# 2.13.0+cpu): none in f64 but ITP's; in f32, where the stopping tests sit
# within an ulp of f more often, up to a third (Ridders: its tolerances of
# 1e-12 lie below f32's resolution near the roots, so its stops become
# tests of exact equality, x on a bracket's end or f(x) == 0)
COUNTS_READ = {
    "float64": {"itp": 38},
    "float32": {"bisection": 1, "false_position_reference": 1, "brent": 25, "ridders": 113,
                "tiruneh": 27, "itp": 63, "chandrupatla": 19},
}
# the limit: twice the reading, at most a fifth of the lanes in f64 and a
# third in f32 (0 where the reading is 0)
COUNTS_DIFFER = {dtype: {label: min(2 * n, (NB + NU + ND + NI) // (5 if dtype == "float64" else 3))
                         for label, n in read.items()} for dtype, read in COUNTS_READ.items()}


def lanes(dtype):
    c = np.concatenate([np.linspace(0.1, 1.9, NB), np.linspace(0.1, 1.9, NU), np.ones(ND),
                        -np.linspace(0.1, 1.9, NI)])
    a = np.concatenate([np.ones(NB + NU), np.zeros(ND), -np.ones(NI)])
    d = np.concatenate([np.zeros(NB + NU), np.linspace(0.5, 1.5, ND), np.zeros(NI)])
    lo = np.concatenate([np.zeros(NB), np.full(NU, 3.0), np.zeros(ND + NI)])
    hi = np.concatenate([np.full(NB, 2.0), np.full(NU, 5.0), np.full(ND, 3.0), np.full(NI, 2.0)])
    return [v.astype(dtype) for v in (a, c, d, lo, hi)]


def jax_finder(name, kw):
    """The JAX finder of one lane, f = a cos(x) - c x + d."""
    def one(a, c, d, lo, hi):
        f = lambda x: a * jnp.cos(x) - c * x + d   # noqa: E731
        if name == "tiruneh":
            return jr.tiruneh(f, (lo, (lo + hi) / 2, hi), **kw)
        return getattr(jr, name)(f, lo, hi, **kw)
    return one


def port_run(name, kw, arrays, fn=None):
    a, c, d, lo, hi = (torch.from_numpy(v) for v in arrays)
    if fn is None:
        fn = lambda x: a * torch.cos(x) - c * x + d   # noqa: E731
    if name == "tiruneh":
        return tr.tiruneh(fn, (lo, (lo + hi) / 2, hi), **kw)
    return getattr(tr, name)(fn, lo, hi, **kw)


def fields(res):
    return {f: np.asarray(getattr(res, f)) for f in tr.RootResult._fields}


def differ(got, want):
    """Lanes where any field differs (NaN equal to NaN, bit for bit)."""
    out = np.zeros(got["x"].shape, bool)
    for f, g in got.items():
        w = want[f]
        out |= ~((g == w) | (np.isnan(g) & np.isnan(w))) if g.dtype.kind == "f" else g != w
    return out


def both(name, kw, dtype):
    arrays = lanes(dtype)
    want = fields(jax.jit(jax.vmap(jax_finder(name, kw)))(*map(jnp.asarray, arrays)))
    got = fields(port_run(name, kw, arrays))
    return arrays, got, want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,kw", FINDERS, ids=IDS)
def test_finder_matches_jax_lane_by_lane(name, kw, dtype):
    label = IDS[FINDERS.index((name, kw))]
    _, got, want = both(name, kw, dtype)
    for f in got:
        assert got[f].dtype == want[f].dtype, f
    np.testing.assert_array_equal(got["bracketed"], want["bracketed"])
    unbracketed = np.arange(NB, NB + NU)
    if name == "tiruneh":
        assert got["bracketed"].all()
    else:
        np.testing.assert_array_equal(np.nonzero(~got["bracketed"])[0], unbracketed)
        assert np.isnan(got["x"][unbracketed]).all() and np.isnan(got["f_value"][unbracketed]).all()
        assert (got["function_calls"][unbracketed] == 2).all()
        assert (got["iterations"][unbracketed] == 0).all() and not got["converged"][unbracketed].any()
    counts = ((got["iterations"] != want["iterations"])
              | (got["function_calls"] != want["function_calls"])
              | (got["converged"] != want["converged"]))
    assert counts.sum() <= COUNTS_DIFFER[dtype].get(label, 0), (label, int(counts.sum()))
    ok = got["bracketed"]
    dx = np.abs(got["x"][ok].astype(np.float64) - want["x"][ok])
    assert dx.max() <= XTOL[dtype][label], (label, dx.max())
    assert got["converged"].mean() > 0.05


def _lanes_while(cond, body, init):
    """``lax.while_loop`` over lanes as ``jax.vmap`` batches it, op by op:
    while any lane runs, the body runs on every lane, and a lane whose cond
    was false when the trip began keeps its whole state."""
    state, run = init, cond(init)
    while bool(jnp.any(run)):
        state = jax.tree_util.tree_map(lambda n, o: jnp.where(run, n, o), body(state), state)
        run = cond(state)
    return state


def _jax_op_by_op(name, kw, args):
    """One lane through the JAX finder with nothing fused."""
    with jax.disable_jit():
        return fields(jax_finder(name, kw)(*(jnp.asarray(v) for v in args)))


def _jax_op_by_op_lanes(name, kw, arrays, monkeypatch):
    """Every lane through the JAX finder at once with nothing fused, its
    while loop run by ``_lanes_while``."""
    with monkeypatch.context() as m, jax.disable_jit():
        m.setattr(jr, "lax", types.SimpleNamespace(while_loop=_lanes_while))
        out = fields(jax_finder(name, kw)(*(jnp.asarray(v) for v in arrays)))
    return {f: np.broadcast_to(v, arrays[0].shape) for f, v in out.items()}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,kw", FINDERS, ids=IDS)
def test_differing_lanes_are_rounding(name, kw, dtype, monkeypatch):
    """Every field of every lane agrees bit for bit, the lanes that differ
    between the two packages among them, once neither side fuses an FMA,
    both evaluate the objective op by op in XLA and the port's sqrt, log2
    and pow are XLA's too.  The JAX side runs all lanes op by op at once
    through ``_lanes_while``; on the differing lane with the most trips (any
    lane's, where none differs) it equals the scalar finder run op by op
    through its own while loop."""
    arrays, got, want = both(name, kw, dtype)
    lanes_differ = differ(got, want)
    trips = np.maximum(got["iterations"], want["iterations"])
    pool = lanes_differ if lanes_differ.any() else np.ones_like(lanes_differ)
    anchor = int(np.argmax(np.where(pool, trips, -1)))
    ref = _jax_op_by_op_lanes(name, kw, arrays, monkeypatch)
    one = _jax_op_by_op(name, kw, [v[anchor] for v in arrays])
    for f, w in one.items():
        g = ref[f][anchor]
        assert (g == w) or (np.isnan(g) and np.isnan(w)), ("anchor", anchor, f, g, w)

    def xla(f):
        return lambda *xs: torch.from_numpy(np.array(f(*(
            jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x for x in xs))))

    monkeypatch.setattr(torch, "sqrt", xla(jnp.sqrt))
    monkeypatch.setattr(torch, "log2", xla(jnp.log2))
    monkeypatch.setattr(torch, "pow", xla(jnp.power))
    A, C, D = (jnp.asarray(v) for v in arrays[:3])
    port = fields(port_run(name, kw, arrays, fn=xla(lambda x: A * jnp.cos(x) - C * x + D)))
    bad = np.nonzero(differ({f: np.broadcast_to(v, lanes_differ.shape) for f, v in port.items()},
                            ref))[0]
    assert bad.size == 0, (f"{bad.size} lanes differ op by op, "
                           f"{int(lanes_differ[bad].sum())} of them among the "
                           f"{int(lanes_differ.sum())} that differ fused", bad[:8].tolist())


def test_chandrupatla_clip_and_f32_guards_follow_jax():
    """jnp.clip with the lower limit above the upper (t_lim > 0.5, inf where
    the 1e-300 guard is 0 in float32) returns the upper limit; so do the
    port's max-then-min and torch.clamp."""
    t = np.array([0.3, 0.7, 0.5, 0.2, np.nan], np.float32)
    lo = np.array([0.6, 0.6, np.inf, 0.1, 0.1], np.float32)
    hi = 1.0 - lo
    want = np.asarray(jnp.clip(t, lo, hi))
    T, L, H = map(torch.from_numpy, (t, lo, hi))
    np.testing.assert_array_equal(torch.minimum(torch.maximum(T, L), H).numpy(), want)
    np.testing.assert_array_equal(torch.clamp(T, L, H).numpy(), want)
    g = torch.where(torch.ones(2, dtype=torch.bool), 1e-300, torch.ones(2))
    assert g.dtype == torch.float32 and float(g.max()) == 0.0
    assert float(torch.clamp(torch.tensor([-1.0]), min=1e-300)) == 0.0


def test_brent_on_a_step_function_matches_jax():
    """A sign step: f takes two values, so fa == fc and fb == fc arise and
    the where-guarded denominators and the bisection branch carry every trip."""
    r = np.linspace(0.1, 1.9, 64)
    want = fields(jax.jit(jax.vmap(lambda r: jr.brent(
        lambda x: jnp.where(x > r, 1.0, -1.0), 0.0, 2.0)))(jnp.asarray(r)))
    R = torch.from_numpy(r)
    got = fields(tr.brent(lambda x: torch.where(x > R, 1.0, -1.0),
                          torch.zeros(64, dtype=torch.float64), 2.0))
    assert not differ(got, want).any()


def test_root_entry_point_dtype_and_lanes():
    c = torch.linspace(0.1, 1.9, 8, dtype=torch.float64)
    fn = lambda x: torch.cos(x) - c * x   # noqa: E731
    res = nt.root(fn, torch.zeros(8, dtype=torch.float64), 2.0)
    assert isinstance(res, nt.RootResult) and res.x.dtype == torch.float64
    ref = tr.brent(fn, torch.zeros(8, dtype=torch.float64), torch.full((8,), 2.0,
                                                                      dtype=torch.float64))
    for f in tr.RootResult._fields:
        torch.testing.assert_close(getattr(res, f), getattr(ref, f), rtol=0, atol=0)
    assert float((torch.cos(res.x) - c * res.x).abs().max()) < 1e-12
    c32 = c.float()
    res32 = nt.root(lambda x: torch.cos(x) - c32 * x, torch.zeros(8), 2.0, tol=1e-6)
    assert res32.x.dtype == torch.float32 and bool(res32.converged.all())
    one = nt.root(lambda x: torch.cos(x) - x, torch.tensor(0.0), torch.tensor(2.0),
                  method="chandrupatla")
    assert one.x.shape == () and one.x.dtype == torch.float32 and bool(one.converged)
    ints = nt.root(lambda x: x - 1.5, torch.tensor([0, 1]), torch.tensor([3, 2]),
                   method="bisection")
    assert ints.x.dtype == torch.get_default_dtype() and ints.x.tolist() == [1.5, 1.5]
    tir = nt.root(lambda x: torch.cos(x) - x, method="tiruneh",
                  x_k=(torch.tensor(0.0, dtype=torch.float64), 0.5, 1.0))
    assert tir.x.dtype == torch.float64 and abs(float(tir.x) - 0.7390851332151607) < 1e-6
    with pytest.raises(ValueError, match="elementwise"):
        nt.root(lambda x: x.sum() - 1.0, torch.zeros(3), 2.0)
    assert nt.root_methods() == list(tr.ALL_FINDERS)


def test_python_brackets_need_a_card():
    """A bracket that is no tensor goes to the card, as minimize's start
    points do; without one, the start points' error."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 17 covers it")
    with pytest.raises(RuntimeError, match="lower is not a torch.Tensor and there is no CUDA"):
        nt.root(lambda x: x - 1.0, 0.0, 2.0)
    with pytest.raises(RuntimeError, match="x_k is not a torch.Tensor and there is no CUDA"):
        nt.root(lambda x: x - 1.0, method="tiruneh")


# ---- the C++ reference's iterates ---------------------------------------

def cubic(x):
    return x * x * x - 2.0 * x - 5.0


def _t(v):
    return torch.tensor(v, dtype=torch.float64)


GOLDEN_CALLS = {   # tests/trajectory_common.py:_ROOT_FNS, on 0-d lanes
    "root_bisection": lambda k: tr.bisection(cubic, _t(1.0), _t(3.0), 1e-6, k),
    "root_false_position": lambda k: tr.false_position(cubic, _t(1.0), _t(3.0), 1e-6, k,
                                                       variant="reference"),
    "root_brent": lambda k: tr.brent(cubic, _t(1.0), _t(3.0), 1e-12, k),
    "root_ridders": lambda k: tr.ridders(cubic, _t(1.0), _t(3.0), 1e-12, 1e-12, k),
    "root_itp": lambda k: tr.itp(cubic, _t(1.0), _t(3.0), 0.3, 2.1, 1.0, 1e-12, 1e-12, k),
    "root_chandrupatla": lambda k: tr.chandrupatla(cubic, _t(1.0), _t(3.0), 1e-10, 2e-10, k),
    "root_tiruneh": lambda k: tr.tiruneh(cubic, (_t(1.0), _t(2.0), _t(3.0)), 1e-6, 1e-12, k),
}
# tests/test_trajectory_parity.py:63-71: exact x, 5e-15 for false_position
GOLDEN_TOL = {"root_false_position": 5e-15}
GOLDEN_ROWS = [(solver, row) for (solver, problem), rows in sorted(load_golden().items())
               if solver.startswith("root_") for row in rows]


def test_golden_root_rows_are_all_here():
    assert len(GOLDEN_ROWS) == 78 and {s for s, _ in GOLDEN_ROWS} == set(GOLDEN_CALLS)


@pytest.mark.parametrize("solver,row", GOLDEN_ROWS,
                         ids=[f"{s}-k{r['k']}" for s, r in GOLDEN_ROWS])
def test_reference_trajectory_row(solver, row):
    res = GOLDEN_CALLS[solver](row["k"])
    assert abs(float(res.x) - row["x"][0]) <= GOLDEN_TOL.get(solver, 0.0)
    assert int(res.iterations) == row["iters"]
    assert int(res.function_calls) == row["nfev"]
