"""nlsolver_torch.trace and nlsolver_torch.parity: the reference binary's
golden trajectories (tests/data/reference_trajectories.tsv) through the
port on the CPU, and ``trace.trajectory`` against the JAX package's.

Each of the 49 (solver, problem) pairs is held to the JAX suite's rules
(tests/test_trajectory_parity.py): iteration counters equal at every k,
f-eval counters equal up to ``NFEV_EXEMPT_AFTER``, the iterate within
``DX_TOL`` (0.0 on the 30 exact pairs).  The port's tables are the JAX
suite's, entry for entry, so no tolerance here is wider than JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_trajectory_parity import DX_TOL as JAX_DX_TOL
from test_trajectory_parity import NFEV_EXEMPT_AFTER as JAX_NFEV_EXEMPT_AFTER
from trajectory_common import GOLDEN

from nlsolver_torch import parity, trace
from nlsolver_torch.core import drive_trace
from nlsolver_torch.solvers import nelder_mead
from nlsolver_tpu import trace as jtrace
from nlsolver_tpu.solvers import nelder_mead as jnm

torch.set_num_threads(1)
GOLDEN_ROWS = parity.load_golden(GOLDEN)
PAIRS = sorted(GOLDEN_ROWS)


def test_tables_are_the_jax_suites():
    assert parity.DX_TOL == JAX_DX_TOL and parity.NFEV_EXEMPT_AFTER == JAX_NFEV_EXEMPT_AFTER
    assert PAIRS == sorted(parity.DX_TOL) and len(PAIRS) == 49
    assert sum(1 for tol, _ in parity.DX_TOL.values() if tol == 0.0) == 30
    assert sorted(parity.RUNNERS) == sorted({s for s, _ in PAIRS})


@pytest.mark.parametrize("solver,problem", PAIRS, ids=[f"{s}-{p}" for s, p in PAIRS])
def test_golden_pair(solver, problem):
    per_k = parity.compare_pair(solver, problem, GOLDEN_ROWS[(solver, problem)])
    assert len(per_k) == len(GOLDEN_ROWS[(solver, problem)])
    bad = parity.check_pair(solver, problem, per_k)
    assert not bad, f"{solver}/{problem}: " + "; ".join(bad[:8])


def test_the_mt_generator_does_not_outlive_its_pairs():
    from nlsolver_torch.random import reference_rngs

    parity.compare_pair("de_rand_mt", "booth", GOLDEN_ROWS[("de_rand_mt", "booth")][:2])
    assert "mt" not in reference_rngs._CUSTOM


def _rosen3_t(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()


def _rosen3_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


@pytest.mark.parametrize("variant", ["textbook", "reference"])
def test_nelder_mead_trajectory_matches_jax(variant):
    """``trajectory("nelder_mead", ...)`` on 3-D Rosenbrock against the JAX
    package's ``trace.trajectory`` run op by op (``jax.disable_jit``), 60
    steps: the same keys, shapes and dtypes, every key bit-equal at every
    step (jitted, XLA contracts ``a + b*c`` into FMAs in the objective and
    the centroid's divide, so its x and f part in the last bits)."""
    x0 = np.array([-0.5, 0.4, 1.3])
    t_cfg = nelder_mead.NelderMeadConfig(variant=variant, max_iter=45)
    j_cfg = jnm.NelderMeadConfig(variant=variant, max_iter=45)
    got = trace.trajectory("nelder_mead", _rosen3_t, torch.from_numpy(x0), t_cfg, num_steps=60)

    with jax.disable_jit():
        want = jtrace.trajectory("nelder_mead", _rosen3_j, jnp.asarray(x0), j_cfg, num_steps=60)
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w), key
    # the run halts at max_iter: the tail repeats the final state
    assert bool(got["done"][-1]) and int(got["iteration"][-1]) == 45
    assert torch.equal(got["x"][-1], got["x"][46])


def test_every_family_traces_and_refuses_what_it_must():
    """Each of the nine families returns ``[num_steps]`` stacks; only
    Nelder-Mead takes ``bounds``; a numpy start goes to the card, and
    raises without one; an unknown family names the supported ones."""
    x0 = torch.tensor([-0.5, -0.5], dtype=torch.float64)
    fn = parity.PROBLEMS["rosenbrock"].fn
    for family in sorted(trace._FAMILIES):
        tr = trace.trajectory(family, fn, x0, num_steps=3)
        assert tr["x"].shape == (3, 2) and tr["f"].shape == (3,), family
        assert tr["iteration"].tolist() == [1, 2, 3] and tr["done"].dtype == torch.bool, family
        assert bool(torch.isfinite(tr["f"]).all()), family
    box = (torch.full((2,), -1.0, dtype=torch.float64), torch.full((2,), 0.0,
                                                                     dtype=torch.float64))
    from nlsolver_torch.core import Bounds

    tr = trace.trajectory("nelder_mead", fn, x0, num_steps=20, bounds=Bounds(*box))
    assert float(tr["x"].max()) <= 0.0 and float(tr["x"].min()) >= -1.0
    with pytest.raises(ValueError, match="takes no bounds"):
        trace.trajectory("bfgs", fn, x0, bounds=Bounds(*box))
    with pytest.raises(ValueError, match="supported"):
        trace.trajectory("nope", fn, x0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            trace.trajectory("de_reference", fn, np.array([-0.5, -0.5]))


def test_drive_trace_freezes_done_lanes_and_stacks_nested_fields():
    """``core.drive_trace``: entry i is the state after i + 1 steps, a lane
    done stays as it was, a tuple field (a generator state) is stacked
    field by field."""
    from typing import NamedTuple

    class S(NamedTuple):
        x: torch.Tensor
        pair: tuple
        done: torch.Tensor

    def step(s):
        return S(s.x + 1.0, (s.pair[0] * 2, s.pair[1] - 1), s.x + 1.0 >= torch.tensor([2.0, 9.0]))

    s0 = S(torch.zeros(2), (torch.ones(2), torch.zeros(2, dtype=torch.int64)),
           torch.zeros(2, dtype=torch.bool))
    final, tr = drive_trace(step, s0, 4)
    assert tr.x.tolist() == [[1.0, 1.0], [2.0, 2.0], [2.0, 3.0], [2.0, 4.0]]
    assert tr.pair[0][:, 0].tolist() == [2.0, 4.0, 4.0, 4.0]
    assert tr.pair[1][:, 1].tolist() == [-1, -2, -3, -4]
    assert tr.done[:, 0].tolist() == [False, True, True, True] and torch.equal(final.x, tr.x[-1])
    with pytest.raises(ValueError, match="num_steps"):
        drive_trace(step, s0, 0)
