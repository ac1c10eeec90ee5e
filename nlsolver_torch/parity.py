"""Trajectory parity against the reference binary, in torch alone.

The golden data (``tests/data/reference_trajectories.tsv``, made by the
reference C++ library's probe ``tools/traj_probe.cpp``) records, for each
deterministic or replayed (solver, problem) pair and each prefix length k,
where the reference lands when run with ``max_iter = k`` from
x0 = (-0.5, -0.5), in full float64.  Every run with ``max_iter = k`` of
such a solver is the k-iteration prefix of the run with ``max_iter = K``,
so one ``trace.trajectory`` gives the whole comparison set; the solvers
whose update depends on max_iter itself (GD's anneal) and the inline-loop
scalar solvers (Brent's minimizer, the root finders) are run once per k,
as the reference is.  Every run takes the reference-parity settings: FD
derivatives of accuracy 1, the ``variant="reference"`` and
``reference_update=True`` quirks where a solver has them, the reference
generators and mt19937(42) for the replays, and McCormick's ``sin`` from
the C library, as the reference binary's (``mccormick``).

``DX_TOL`` and ``NFEV_EXEMPT_AFTER`` are the JAX package's suite's
(tests/test_trajectory_parity.py), for the file's 49 pairs: 30 bit-exact, the FD-gradient
solvers within the drift that a one-ulp objective difference leaves.
``check_pair`` applies them, on any device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .core import c_math
from .deriv import Deriv
from .problems import PROBLEMS
from .random.mt19937 import registered_mt
from .solvers import brent, rootfind
from .solvers.bfgs import BFGSConfig
from .solvers.cgd import CGDConfig
from .solvers.de_reference import DEReferenceConfig
from .solvers.gd import GDConfig
from .solvers.gd import minimize as gd_minimize
from .solvers.lm import LMConfig
from .solvers.nelder_mead import NelderMeadConfig
from .solvers.nmpso_reference import NMPSOReferenceConfig
from .solvers.pso_reference import PSOAccReferenceConfig
from .solvers.sann_reference import SANNReferenceConfig
from .trace import trajectory

FD = Deriv(mode="fd", accuracy=1)
X0 = (-0.5, -0.5)

# (solver, problem) -> (dx tolerance, last k the dx is held at, or None
# for every k); the JAX suite's measured drift times ~10
DX_TOL: Dict[Tuple[str, str], Tuple[float, object]] = {
    ("nm", "booth"): (0.0, None),
    ("nm", "mccormick"): (0.0, None),
    ("nm", "rosenbrock"): (0.0, None),
    ("brent_min", "quartic1d"): (0.0, None),
    ("root_bisection", "cubic"): (0.0, None),
    ("root_brent", "cubic"): (0.0, None),
    ("root_chandrupatla", "cubic"): (0.0, None),
    ("root_itp", "cubic"): (0.0, None),
    ("root_ridders", "cubic"): (0.0, None),
    ("root_tiruneh", "cubic"): (0.0, None),
    ("root_false_position", "cubic"): (5e-15, None),
    ("gd_fixed", "booth"): (1e-6, None),
    ("gd_fixed", "rosenbrock"): (1e-7, None),
    ("gd_anneal", "booth"): (1e-6, None),
    ("gd_anneal", "rosenbrock"): (1e-7, None),
    ("gd_bigstep", "booth"): (1e-6, None),
    ("gd_bigstep", "rosenbrock"): (1e-6, None),
    ("gd_linesearch", "booth"): (1e-4, None),
    ("gd_page", "booth"): (1e-3, 3),
    ("gd_page", "rosenbrock"): (1e-8, 3),
    ("gd_linesearch", "mccormick"): (1e-6, None),
    ("gd_linesearch", "rosenbrock"): (1e-5, None),
    ("cgd", "booth"): (1e-6, None),
    ("cgd", "rosenbrock"): (1e-6, 12),
    ("bfgs", "booth"): (1e-4, None),
    ("bfgs", "mccormick"): (1e-6, None),
    ("bfgs", "rosenbrock"): (1e-5, None),
    ("lm", "booth"): (1e-6, None),
    ("lm", "rosenbrock"): (1e-6, None),
    ("de_rand_xorshift", "rosenbrock"): (0.0, None),
    ("de_rand_xorshift", "booth"): (0.0, None),
    ("de_best_xorshift", "rosenbrock"): (0.0, None),
    ("de_rand_xoshiro", "rosenbrock"): (0.0, None),
    ("de_rand_recurrent", "rosenbrock"): (0.0, None),
    ("de_rand_recurrent", "booth"): (0.0, None),
    ("de_rand_halton", "rosenbrock"): (0.0, None),
    ("de_rand_halton", "booth"): (0.0, None),
    ("de_rand_mt", "rosenbrock"): (0.0, None),
    ("de_rand_mt", "booth"): (0.0, None),
    ("sann_xoshiro", "rosenbrock"): (0.0, None),
    ("sann_recurrent", "rosenbrock"): (0.0, None),
    ("pso_acc_xoshiro", "rosenbrock"): (0.0, None),
    ("nmpso_xoshiro", "rosenbrock"): (0.0, None),
    ("sann_xorshift", "rosenbrock"): (0.0, None),
    ("sann_xorshift", "booth"): (0.0, None),
    ("pso_acc_xorshift", "rosenbrock"): (0.0, None),
    ("pso_acc_xorshift", "booth"): (0.0, None),
    ("nmpso_xorshift", "rosenbrock"): (0.0, None),
    ("nmpso_xorshift", "booth"): (0.0, None),
}

# pairs whose f-eval counters may part after some k: the iterates sit at
# the ~1e-8 gradient-noise floor there (CGD on Rosenbrock has diverged
# chaotically), where More-Thuente's trial counts flip on one ulp
NFEV_EXEMPT_AFTER = {
    ("cgd", "rosenbrock"): 21,
    ("gd_linesearch", "mccormick"): 14,
    ("gd_linesearch", "rosenbrock"): 26,
}


def quartic1d(x):
    return ((x * x) * (x * x)) - 3.0 * (x * x) + x


def cubic(x):
    return x * x * x - 2.0 * x - 5.0


def load_golden(path: str) -> Dict[Tuple[str, str], List[dict]]:
    """``{(solver, problem): [row, ...]}`` sorted by k; a row is
    ``dict(k, f, iters, nfev, gfev, hfev, x)``."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            out.setdefault((parts[0], parts[1]), []).append({
                "k": int(parts[2]), "f": float(parts[3]), "iters": int(parts[4]),
                "nfev": int(parts[5]), "gfev": int(parts[6]), "hfev": int(parts[7]),
                "x": tuple(float(v) for v in parts[8:])})
    for rows in out.values():
        rows.sort(key=lambda r: r["k"])
    return out


def mccormick(x):
    """McCormick (test_functions.h:203-211) with the C library's ``sin``,
    as the reference binary evaluates it: the card's own ``sin`` parts
    from it on some 9 % of inputs near the minimum, which moves the FD
    gradients there and with them GD's stopping test."""
    x0, x1 = x[..., 0], x[..., 1]
    return c_math("sin", x0 + x1) + (x0 - x1) ** 2 - 1.5 * x0 + 2.5 * x1 + 1.0


def objective(problem: str):
    """The golden problem's objective as the reference evaluates it:
    ``PROBLEMS``' own, but McCormick's ``sin`` the C library's."""
    return mccormick if problem == "mccormick" else PROBLEMS[problem].fn


def _x0(device) -> torch.Tensor:
    return torch.tensor(X0, dtype=torch.float64, device=device)


def _from_trace(tr, ks, final_eval: bool = False):
    """Row k - 1 of a trace for each k.  ``final_eval``: the reference's
    GD, CGD and BFGS evaluate f once more at return (e.g. nlsolver.h:
    2976-2978), which ``minimize`` counts and the trace does not."""
    tr = {key: v.cpu() for key, v in tr.items()}
    return {k: {"x": tr["x"][k - 1], "f": float(tr["f"][k - 1]),
                "iters": int(tr["iteration"][k - 1]),
                "nfev": int(tr["nfev"][k - 1]) + int(final_eval)} for k in ks}


def _traced(family, make_config, final_eval=False):
    def run(problem, ks, device):
        K = max(ks)
        tr = trajectory(family, objective(problem), _x0(device), make_config(K + 1),
                        num_steps=K)
        return _from_trace(tr, ks, final_eval)

    return run


def _result(res, swap: bool = False):
    """A per-k run's result as a row; ``swap`` takes the reference's
    swapped slots of Brent's minimizer (nlsolver.h:3424-3425: its "x" is
    f(x*), its "f_value" x*)."""
    x, f = (res.f_value, res.x) if swap else (res.x, res.f_value)
    return {"x": torch.atleast_1d(x).cpu(), "f": float(f), "iters": int(res.iterations),
            "nfev": int(res.function_calls)}


GD_ALPHA = {"booth": 0.05, "rosenbrock": 0.001}


def _gd(step_type, alpha=None):
    # PAGE's draw only feeds a `u > p` test with p = 0 (the reference's
    # size_t division, nlsolver.h:2944), so its trajectory draws on nothing
    def run(problem, ks, device):
        a = GD_ALPHA[problem] if alpha is None else alpha
        return _traced("gd", lambda m: GDConfig(step_type=step_type, alpha=a, max_iter=m,
                                                deriv=FD, variant="reference"), True)(
            problem, ks, device)

    return run


def run_gd_anneal(problem, ks, device):
    # the schedule alpha / (1 + iter / max_iter) depends on max_iter
    # (nlsolver.h:2997): each k is another dynamical system, run alone
    return {k: _result(gd_minimize(objective(problem), _x0(device), GDConfig(
        step_type="anneal", alpha=GD_ALPHA[problem], max_iter=k, deriv=FD, variant="reference")))
        for k in ks}


def run_brent_min(problem, ks, device):
    like = torch.zeros((), dtype=torch.float64, device=device)
    return {k: _result(brent.minimize_scalar(quartic1d, brent.BrentConfig(
        max_iter=k, lower=-5.0, upper=5.0), like=like), swap=True) for k in ks}


def _root_calls(device):
    def t(v):
        return torch.tensor(v, dtype=torch.float64, device=device)

    return {
        "root_bisection": lambda k: rootfind.bisection(cubic, t(1.0), t(3.0), 1e-6, k),
        "root_false_position": lambda k: rootfind.false_position(
            cubic, t(1.0), t(3.0), 1e-6, k, variant="reference"),
        "root_brent": lambda k: rootfind.brent(cubic, t(1.0), t(3.0), 1e-12, k),
        "root_ridders": lambda k: rootfind.ridders(cubic, t(1.0), t(3.0), 1e-12, 1e-12, k),
        "root_itp": lambda k: rootfind.itp(cubic, t(1.0), t(3.0), 0.3, 2.1, 1.0, 1e-12, 1e-12, k),
        "root_chandrupatla": lambda k: rootfind.chandrupatla(cubic, t(1.0), t(3.0), 1e-10,
                                                             2e-10, k),
        "root_tiruneh": lambda k: rootfind.tiruneh(cubic, (t(1.0), t(2.0), t(3.0)), 1e-6,
                                                   1e-12, k),
    }


def _root(solver):
    def run(problem, ks, device):
        call = _root_calls(device)[solver]
        return {k: _result(call(k)) for k in ks}

    return run


DE_CONFIGS = {
    "de_rand_xorshift": dict(strategy="random", rng="xorshift"),
    "de_best_xorshift": dict(strategy="best", rng="xorshift"),
    "de_rand_xoshiro": dict(strategy="random", rng="xoshiro"),
    "de_rand_recurrent": dict(strategy="random", rng="recurrent"),
    "de_rand_halton": dict(strategy="random", rng="halton"),
    # the user-RNG interop: std::mt19937(42) through the generator registry
    "de_rand_mt": dict(strategy="random", rng="mt"),
}


def _de(solver):
    def run(problem, ks, device):
        with registered_mt("mt", seed=42):
            return _traced("de_reference", lambda m: DEReferenceConfig(
                max_iter=m, **DE_CONFIGS[solver]))(problem, ks, device)

    return run


RUNNERS = {
    "nm": _traced("nelder_mead", lambda m: NelderMeadConfig(variant="reference", max_iter=m)),
    "gd_fixed": _gd("fixed"),
    "gd_anneal": run_gd_anneal,
    "gd_bigstep": _gd("bigstep", 1.0),
    "gd_linesearch": _gd("linesearch", 1.0),
    "gd_page": _gd("page"),
    "cgd": _traced("cgd", lambda m: CGDConfig(max_iter=m, deriv=FD), True),
    "bfgs": _traced("bfgs", lambda m: BFGSConfig(max_iter=m, deriv=FD, reference_update=True),
                    True),
    "lm": _traced("lm", lambda m: LMConfig(max_iter=m, deriv=FD, variant="reference")),
    "brent_min": run_brent_min,
}
RUNNERS.update({name: _root(name) for name in _root_calls("cpu")})
RUNNERS.update({name: _de(name) for name in DE_CONFIGS})
for _rng in ("xorshift", "xoshiro", "recurrent"):
    RUNNERS[f"sann_{_rng}"] = _traced(
        "sann_reference", lambda m, r=_rng: SANNReferenceConfig(max_iter=m, rng=r))
for _rng in ("xorshift", "xoshiro"):
    RUNNERS[f"pso_acc_{_rng}"] = _traced(
        "pso_acc_reference", lambda m, r=_rng: PSOAccReferenceConfig(max_iter=m, rng=r))
    RUNNERS[f"nmpso_{_rng}"] = _traced(
        "nmpso_reference", lambda m, r=_rng: NMPSOReferenceConfig(max_iter=m, rng=r))


def compare_pair(solver: str, problem: str, rows: List[dict], device="cpu") -> List[dict]:
    """Run the pair on ``device`` and compare each prefix with its golden
    row: ``[dict(k, dx, df, iters_match, nfev_match)]``."""
    ours = RUNNERS[solver](problem, [r["k"] for r in rows], device)
    per_k = []
    for r in rows:
        o = ours[r["k"]]
        x = o["x"].to(torch.float64)
        dx = float((torch.tensor(r["x"], dtype=torch.float64) - x).abs().max())
        per_k.append({"k": r["k"], "dx": dx, "df": abs(r["f"] - o["f"]),
                      "iters_match": r["iters"] == o["iters"],
                      "nfev_match": r["nfev"] == o["nfev"]})
    return per_k


def check_pair(solver: str, problem: str, per_k: List[dict]) -> List[str]:
    """The suite's rules on one pair: iteration counters equal at every k,
    f-eval counters equal up to ``NFEV_EXEMPT_AFTER``, dx within
    ``DX_TOL``.  Returns what broke, empty when the pair passes."""
    tol, max_k = DX_TOL[(solver, problem)]
    nfev_after = NFEV_EXEMPT_AFTER.get((solver, problem))
    bad = []
    for r in per_k:
        if not r["iters_match"]:
            bad.append(f"k={r['k']}: iteration counter mismatch")
        if not r["nfev_match"] and (nfev_after is None or r["k"] <= nfev_after):
            bad.append(f"k={r['k']}: nfev counter mismatch")
        if (max_k is None or r["k"] <= max_k) and not r["dx"] <= tol:
            bad.append(f"k={r['k']}: dx={r['dx']:.3e} > {tol:g}")
    return bad
