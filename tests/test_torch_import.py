"""nlsolver_torch imports and runs with JAX made unimportable."""
import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError
    import torch
    torch.set_num_threads(1)
    import nlsolver_torch as nt
    from nlsolver_torch.solvers import de_batched
    import nlsolver_torch.benches, nlsolver_torch.interop  # noqa: F401

    fn = nt.PROBLEMS["rastrigin"].fn
    cfg = nt.DEConfig(pop_size=8, partner_sampling="rotation", use_fused_kernel=True)
    g = torch.Generator().manual_seed(0)
    state = de_batched.init(fn, torch.full((4, 3), -0.5), cfg, generator=g)
    for _ in range(3):
        state = de_batched.step(fn, state, cfg, generator=g)
    assert state.generation == 3 and state.iteration.tolist() == [3] * 4

    # the NLLS slice: linalg, the kernels' CPU routes, both solvers
    import nlsolver_torch.linalg, nlsolver_torch.ops  # noqa: F401
    from nlsolver_torch.ops import qr_wavefront, smallchol  # noqa: F401
    t = torch.linspace(0.0, 2.0, 8, dtype=torch.float64)
    ys = torch.stack([2.0 * torch.exp(-t), 1.5 * torch.exp(-0.5 * t)])
    for solve in ("cholesky", "qr", "qr_pallas"):
        res = nt.fit_fleet(lambda p, y: p[0] * torch.exp(-p[1] * t) - y,
                           torch.ones(2, 2, dtype=torch.float64),
                           nt.NLLSFleetConfig(max_iter=30, solve=solve), data=ys)
        assert bool(res.converged.all()), solve
    res = nt.fit(lambda x: x - 3.0, torch.zeros(2, dtype=torch.float64))
    assert abs(float(res.x.sum()) - 6.0) < 1e-9
    # the BFGS slice: line searches, the rank-2 kernels' CPU route, the api route
    import nlsolver_torch.linesearch, nlsolver_torch.solvers.bfgs_fleet  # noqa: F401
    from nlsolver_torch.ops import rank2  # noqa: F401
    for ls in ("more_thuente", "speculative"):
        res = nt.minimize(lambda x: ((x - 0.5) ** 2).sum(), torch.zeros(3, 4, dtype=torch.float64),
                          method="bfgs", layout="fleet",
                          config=nt.BFGSFleetConfig(max_iter=20, linesearch=ls))
        assert float((res.x - 0.5).abs().max()) < 1e-2, ls
    # the CMA-ES slice: the Jacobi eigensolver, its kernel's CPU route, both solvers
    import nlsolver_torch.solvers.cmaes, nlsolver_torch.solvers.cmaes_fleet  # noqa: F401
    from nlsolver_torch.linalg import eigh
    from nlsolver_torch.ops import eigh_jacobi  # noqa: F401
    S = torch.tensor([[2.0, 1.0], [1.0, 2.0]], dtype=torch.float64)
    for method in ("xla", "jacobi", "qr"):
        assert float((eigh(S, method=method).eigenvalues.sort().values
                      - torch.tensor([1.0, 3.0], dtype=torch.float64)).abs().max()) < 1e-9, method
    assert eigh(S[:, :, None].contiguous(), method="pallas").eigenvalues.shape == (2, 1)
    for method in ("jacobi", "pallas", "xla"):
        res = nt.minimize(lambda x: ((x - 0.5) ** 2).sum(), torch.zeros(3, 4, dtype=torch.float64),
                          method="cmaes", layout="fleet",
                          config=nt.CMAESFleetConfig(max_iter=150, eigh_method=method))
        assert float((res.x - 0.5).abs().max()) < 1e-3, method
    # the root finders and the PSO and SANN lane fleets
    c = torch.linspace(0.1, 1.9, 6, dtype=torch.float64)
    for method in nt.root_methods():
        kw = {"x_k": (torch.zeros(6, dtype=torch.float64), 0.5, 1.0)} if method == "tiruneh" \
            else {"lower": torch.zeros(6, dtype=torch.float64), "upper": 2.0}
        res = nt.root(lambda x: torch.cos(x) - c * x, method=method, **kw)
        assert res.x.shape == (6,) and bool(res.bracketed.all()), method
    for method, cfg in (("pso", nt.PSOConfig(max_iter=20)), ("sann", nt.SANNConfig(max_iter=5))):
        res = nt.minimize(nt.PROBLEMS["sphere"].fn, torch.full((4, 3), 0.5, dtype=torch.float64),
                          method=method, layout="batched", config=cfg,
                          generator=torch.Generator().manual_seed(0))
        assert res.x.shape == (4, 3) and bool(torch.isfinite(res.f_value).all()), method
    # the single-instance solvers with derivatives, single and batched
    import nlsolver_torch.deriv, nlsolver_torch.linesearch.armijo  # noqa: F401
    bowl = lambda x: ((x - 0.5) ** 2).sum()  # noqa: E731
    for method in ("bfgs", "lbfgs", "lbfgsb", "gd", "cgd", "lm", "coordinate"):
        cfg = nt.GDConfig(alpha=0.1) if method == "gd" else None
        one = nt.minimize(bowl, torch.zeros(3, dtype=torch.float64), method=method, config=cfg)
        many = nt.maximize(lambda x: -bowl(x), torch.zeros(2, 3, dtype=torch.float64),
                           method=method, layout="batched", config=cfg)
        assert one.x.shape == (3,) and many.x.shape == (2, 3), method
        assert float((many.x - 0.5).abs().max()) < 1e-2, method
    res = nt.minimize(lambda t: (t - 0.25) ** 2, torch.zeros(4, 1, dtype=torch.float64),
                      method="brent", layout="batched")
    assert float((res.x - 0.25).abs().max()) < 1e-8
    # the derivative-free single-instance solvers, the default method, the
    # multistart and methods()
    rosen = lambda x: 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2  # noqa: E731
    res = nt.minimize(rosen, torch.tensor([-0.5, -0.5], dtype=torch.float64))
    assert float(res.f_value) < 1e-8 and int(res.iterations) > 0
    res = nt.minimize(rosen, torch.tensor([-0.5, -0.5], dtype=torch.float64), method="bfgs",
                      restarts=4, restart_sampler="halton")
    assert res.x.shape == (2,) and bool(torch.isfinite(res.f_value))
    for method, cfg in (("de", nt.DEConfig(pop_size=8, max_iter=20)),
                        ("pso", nt.PSOConfig(max_iter=20)), ("sann", nt.SANNConfig(max_iter=5)),
                        ("nmpso", nt.NMPSOConfig(max_iter=20)), ("nelder_mead", None),
                        ("cmaes", nt.CMAESConfig(max_iter=10))):
        one = nt.minimize(bowl, torch.zeros(3, dtype=torch.float64), method=method, config=cfg)
        assert one.x.shape == (3,) and bool(torch.isfinite(one.f_value)), method
    for method in ("nelder_mead", "nmpso"):
        many = nt.maximize(lambda x: -bowl(x), torch.ones(2, 3, dtype=torch.float64),
                           method=method, layout="batched")
        assert float((many.x - 0.5).abs().max()) < 1e-2, method
    assert "nelder_mead" in nt.methods() and len(nt.methods()) == 20
    # the CMA-ES on lane tensors, the reference-RNG replays and trajectory capture
    import nlsolver_torch.parity, nlsolver_torch.trace  # noqa: F401
    from nlsolver_torch.random import mt19937, reference_rngs
    from nlsolver_torch.solvers import (de_reference, nmpso_reference, pso_reference,  # noqa: F401
                                        sann_reference)
    many = nt.minimize(bowl, torch.zeros(3, 2, dtype=torch.float64), method="cmaes",
                       layout="batched", config=nt.CMAESConfig(eigh_method="jacobi"))
    assert many.x.shape == (3, 2) and bool(many.converged.all())
    us, _ = reference_rngs.sample(*reference_rngs.make("xorshift", torch.float64), 3)
    with mt19937.registered_mt("mt"):
        res = de_reference.minimize(rosen, torch.tensor([-0.5, -0.5], dtype=torch.float64),
                                    de_reference.DEReferenceConfig(max_iter=3, rng="mt"))
    assert int(res.iterations) == 3 and us.shape == (3,)
    tr = nlsolver_torch.trace.trajectory("sann_reference", rosen,
                                         torch.tensor([-0.5, -0.5], dtype=torch.float64),
                                         num_steps=2)
    assert tr["x"].shape == (2, 2)
    assert not any(m == "jax" or m.startswith(("jax.", "nlsolver_tpu"))
                   for m in sys.modules if sys.modules[m] is not None)
    print("ok")
    """
)


def test_imports_and_steps_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_in_package_sources():
    pkg = os.path.join(ROOT, "nlsolver_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                for banned in ("import jax", "from jax", "nlsolver_tpu import",
                               "from nlsolver_tpu"):
                    assert banned not in src, (f, banned)


MESH_SCRIPT = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None              # `import jax` raises ImportError
    sys.modules["nlsolver_tpu"] = None     # and so does the JAX package
    import torch
    torch.set_num_threads(1)
    import nlsolver_torch as nt
    from nlsolver_torch import parallel, utils
    from nlsolver_torch.parallel import distributed

    distributed.initialize()               # no launcher: stays local
    mesh = parallel.make_mesh(device_type="cpu")
    x0 = torch.full((4, 3), 1.5, dtype=torch.float64)
    res = nt.minimize(nt.PROBLEMS["sphere"].fn, x0, method="de", layout="sharded", mesh=mesh,
                      config=nt.DEConfig(pop_size=8, max_iter=30))
    assert res.x.shape == (4, 3) and bool(torch.isfinite(res.f_value).all())
    res = nt.fit_sharded(lambda p: p - 2.0, x0, mesh=mesh)
    assert float((res.x - 2.0).abs().max()) < 1e-6
    res = nt.fit_fleet_sharded(lambda p: p - 2.0, x0.T.contiguous(), mesh=mesh)
    assert float((res.x - 2.0).abs().max()) < 1e-6
    with utils.debug_nans(), utils.log_compiles():
        utils.benchmark(lambda: x0 * 2.0, runs=2, warmup=0)
    assert not any(m == "jax" or m.startswith(("jax.", "nlsolver_tpu"))
                   for m in sys.modules if sys.modules[m] is not None)
    print("ok")
    """
)


def test_parallel_and_utils_import_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", MESH_SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_parallel_and_utils_names_and_fields_follow_jax():
    """The mesh engines ported so far carry the JAX package's names; what
    it has beyond them is ROADMAP.md Queue 1 item 9b; the utilities are
    the JAX package's but the orbax pair."""
    import nlsolver_torch as nt
    import nlsolver_torch.parallel as tpar
    import nlsolver_torch.utils as tutils
    import nlsolver_tpu as nj
    import nlsolver_tpu.parallel as jpar
    import nlsolver_tpu.utils as jutils

    assert set(tpar.__all__) - {"distributed"} <= set(jpar.__all__)
    assert set(jpar.__all__) - set(tpar.__all__) == {"minimize_islands", "pso_minimize_sharded"}
    assert set(jutils.__all__) <= set(tutils.__all__)
    assert nt.SolverResult._fields == nj.SolverResult._fields
    import inspect

    def positional(fn):
        return [p.name for p in inspect.signature(fn).parameters.values()
                if p.kind == p.POSITIONAL_OR_KEYWORD]

    # the same positional parameters; the JAX package's per-instance keys
    # are the port's keyword-only generator or draws
    for name in ("make_mesh", "fit_sharded", "fit_fleet_sharded", "minimize_sharded",
                 "minimize_fleet_sharded", "bfgs_minimize_fleet_sharded",
                 "minimize_pso_fleet_sharded", "minimize_sann_fleet_sharded"):
        jp = [p for p in positional(getattr(jpar, name)) if p != "keys"]
        assert positional(getattr(tpar, name))[:len(jp)] == jp, name


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        src = fh.read()
    for banned in ("import jax", "from jax", "nlsolver_tpu import", "from nlsolver_tpu",
                   "import nlsolver_tpu"):
        assert banned not in src, banned
