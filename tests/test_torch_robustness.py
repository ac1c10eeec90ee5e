"""The JAX suite's robustness checks asked of the port, each beside the JAX
test it follows, on the CPU:

  * the failure modes and the float32 runs of tests/test_robustness.py
    (BFGS in a NaN region and from an indefinite start, LM on a flat and on
    a NaN objective, bisection on equal endpoints, DE from x0 = 0,
    ``maximize`` on nine families, Nelder-Mead and DE in float32 on five
    problems), to the JAX test's own thresholds.  The port's DE draws from
    a ``torch.Generator``, not JAX's key, so its float32 runs are held over
    three seeds: JAX's one key lands DE on Matyas 0.049 from the minimum
    against the 0.05 allowed;
  * bfloat16 objective scores through the DE fleet
    (tests/test_bf16_eval.py:39-59): most lanes within 0.05 of a minimum,
    the state float32;
  * a reference replay checkpointed after 8 steps, loaded into a fresh
    state and run 12 more (tests/test_emulation_checkpoint.py), through
    ``utils.save`` / ``load`` and through ``save_orbax`` / ``load_orbax``:
    bit-exact on the golden k = 20 rows of the C++ reference.
"""
import numpy as np
import pytest
import torch
from trajectory_common import GOLDEN

from nlsolver_torch import parity, utils
from nlsolver_torch.core import with_eval_dtype
from nlsolver_torch.problems import PROBLEMS
from nlsolver_torch.solvers import (bfgs, cgd, cmaes, de, de_batched, de_reference, lbfgs, lm,
                                    nelder_mead, nmpso, pso, rootfind, sann, sann_reference)
from nlsolver_torch.solvers.bfgs import BFGSConfig
from nlsolver_torch.solvers.de import DEConfig
from nlsolver_torch.solvers.lm import LMConfig

torch.set_num_threads(1)
TOL = 0.05            # tests/test_robustness.py:19, the reference's parity tolerance
SEEDS = (0, 1, 2)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def dx(p, x):
    return float(p.distance_to_nearest_minimum(x.to(torch.float64)))


@pytest.mark.parametrize("name", ["sphere", "rosenbrock", "booth", "matyas", "ackley"])
def test_float32_convergence(name):
    """tests/test_robustness.py:22-35."""
    p = PROBLEMS[name]
    x0 = torch.full((p.dim,), -0.5, dtype=torch.float32)
    res = nelder_mead.minimize(p.fn, x0)
    assert res.x.dtype == torch.float32
    assert dx(p, res.x) <= TOL
    for seed in SEEDS:
        res = de.minimize(p.fn, x0, DEConfig(), generator=gen(seed))
        assert res.x.dtype == torch.float32 and dx(p, res.x) <= TOL, seed


def test_bfgs_recovers_from_nan_region():
    """tests/test_robustness.py:38-45: NaN gradients for x < 0 end the run."""
    def fn(x):
        return torch.sqrt(x[0].abs() + 1e-12) + (x[1] - 1.0) ** 2

    res = bfgs.minimize(fn, torch.tensor([0.5, -0.5], dtype=torch.float64),
                        BFGSConfig(max_iter=50))
    assert int(res.iterations) <= 50


def test_bfgs_reset_on_nonconvex_start():
    """tests/test_robustness.py:48-55: an indefinite start resets H."""
    p = PROBLEMS["styblinski_tang"]
    res = bfgs.minimize(p.fn, torch.tensor([-0.5, -0.5], dtype=torch.float64), BFGSConfig())
    assert dx(p, res.x) <= TOL


def test_lm_on_flat_objective():
    """tests/test_robustness.py:58-63."""
    res = lm.minimize(lambda x: torch.full((), 3.14, dtype=x.dtype), torch.ones(2,
                      dtype=torch.float64), LMConfig())
    assert bool(res.converged)
    assert float(res.f_value) == pytest.approx(3.14)


def test_objective_returning_nan_terminates_everywhere():
    """tests/test_robustness.py:66-71."""
    def fn(x):
        s = (x * x).sum()
        return torch.where(s > 0.5, torch.nan, s)

    res = lm.minimize(fn, torch.tensor([1.0, 1.0], dtype=torch.float64), LMConfig(max_iter=30))
    assert int(res.iterations) <= 30


def test_rootfinder_identical_endpoints():
    """tests/test_robustness.py:74-76."""
    two = torch.tensor(2.0, dtype=torch.float64)
    assert not bool(rootfind.bisection(lambda x: x, two, two).bracketed)


def test_de_zero_width_init():
    """tests/test_robustness.py:79-86: x0 = 0 collapses the population, the
    spread is 0 and the run converges."""
    res = de.minimize(PROBLEMS["sphere"].fn, torch.zeros(2, dtype=torch.float64), DEConfig(),
                      generator=gen())
    assert bool(res.converged)


def test_maximize_all_families():
    """tests/test_robustness.py:89-98."""
    def neg_sphere(x):
        return -((x - 1.0) ** 2).sum()

    x0 = torch.tensor([0.3, -0.2], dtype=torch.float64)
    for mod in (nelder_mead, de, pso, sann, nmpso, cgd, bfgs, lbfgs, cmaes):
        kw = {"generator": gen()} if mod in (de, pso, sann, nmpso, cmaes) else {}
        res = mod.maximize(neg_sphere, x0, **kw)
        assert float(res.f_value) > -0.25, (mod.__name__, float(res.f_value))


@pytest.mark.parametrize("pname", ["sphere", "rosenbrock", "rastrigin"])
def test_de_batched_bf16_eval_solves_suite(pname):
    """tests/test_bf16_eval.py:39-59: the DE fleet with bfloat16 scores
    lands 3 lanes of 4 within the parity tolerance; the state stays f32."""
    p = PROBLEMS[pname]
    cfg = DEConfig(pop_size=32, max_iter=250, eps=0.0, best_value_no_change=1 << 30,
                   partner_sampling="rotation")
    B = 8
    x0 = torch.full((B, p.dim), -0.5, dtype=torch.float32)
    res = de_batched.minimize_batched(with_eval_dtype(p.fn, torch.bfloat16), x0, cfg,
                                      generator=gen())
    assert res.x.dtype == torch.float32
    d = np.array([dx(p, x) for x in res.x])
    assert int((d <= 0.05).sum()) >= (3 * B) // 4, d


@pytest.mark.parametrize("pair", ["npz", "orbax"])
@pytest.mark.parametrize("family", ["de", "sann"])
def test_resume_matches_golden(tmp_path, family, pair):
    """tests/test_emulation_checkpoint.py: 8 steps, a checkpoint, a fresh
    state loaded from it, 12 steps more: the golden k = 20 row of the C++
    reference, bit for bit."""
    fn = PROBLEMS["rosenbrock"].fn
    x0 = torch.tensor([-0.5, -0.5], dtype=torch.float64)
    golden = parity.load_golden(GOLDEN)
    if family == "de":
        mod, cfg = de_reference, de_reference.DEReferenceConfig(max_iter=100)
        rows = golden[("de_rand_xorshift", "rosenbrock")]
    else:
        mod, cfg = sann_reference, sann_reference.SANNReferenceConfig(max_iter=100)
        rows = golden[("sann_xorshift", "rosenbrock")]
    row = next(r for r in rows if r["k"] == 20)
    save, load = ((utils.save, utils.load) if pair == "npz" else
                  (utils.checkpoint.save_orbax, utils.checkpoint.load_orbax))

    state = mod.init(fn, x0, cfg)
    for _ in range(8):
        state = mod.step(fn, state, cfg)
    path = str(tmp_path / "state")
    save(path + (".npz" if pair == "npz" else ""), state)
    resumed = load(path + (".npz" if pair == "npz" else ""), mod.init(fn, x0, cfg))
    for _ in range(12):
        resumed = mod.step(fn, resumed, cfg)
    x = resumed.agents[de_reference.report_best(resumed)] if family == "de" else resumed.x
    assert int(resumed.iteration) == row["iters"] == 20
    assert int(resumed.nfev) == row["nfev"]
    assert [float(v) for v in x] == list(row["x"])
