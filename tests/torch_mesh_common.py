"""Worlds of gloo ranks for the tests of ``nlsolver_torch.parallel``.

``run_worlds`` starts every rank of the worlds asked for at once, each a
process of its own that imports ``torch`` and ``nlsolver_torch`` only
(``torch.set_num_threads(1)``), joins its world through a file store in a
directory of its own (``distributed.initialize(init_method="file://...")``,
so no two test workers race for a port), runs every engine on the inputs
the parent wrote, and writes what each returned.  The JAX references are
computed in the parent.

Run as a script, this file is one rank: ``python torch_mesh_common.py
RANK WORLD DIR``.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

# the (dp, pop) meshes a world runs the engines on; the dimension-sharded
# L-BFGS also runs on (1, world), so that it meets pop = 4
MESHES = {1: ((1, 1),), 2: ((2, 1), (1, 2)), 4: ((2, 2),)}
DE_STRATEGIES = ("random", "best")
ISLAND_FORMS = ("eager", "fused")
NLLS_SOLVES = ("cholesky", "qr_pallas")
LBFGS_OBJECTIVES = ("coupled", "weighted")
RANK_TIMEOUT = 300


def fields(res) -> dict:
    return {f: np.asarray(v) for f, v in zip(res._fields, res)}


# ----------------------------------------------------------------- inputs


def inputs() -> dict:
    """Every engine's inputs, numpy arrays and Python values, f64."""
    rng = np.random.default_rng(20)
    B = 8
    t = np.linspace(0.0, 2.0, 16)
    amps, rates = rng.uniform(1.0, 3.0, B), rng.uniform(0.5, 2.0, B)
    return {
        "bfgs_X0": np.stack([np.linspace(-1.2, 0.8, B), np.linspace(1.0, -0.5, B)]),
        "bfgs_cfg": dict(max_iter=60, grad_eps=1e-8),
        "t": t,
        "ys": amps[:, None] * np.exp(-rates[:, None] * t[None, :]),
        "nlls_X0": np.ones((2, B)),
        "nlls_cfg": dict(max_iter=25),
        "fit_cfg": dict(max_iter=50),
        "free_x0": rng.uniform(-3.0, 3.0, (B, 3)),
        "pso_cfg": dict(n_particles=8, max_iter=40, best_value_no_change=12),
        "sann_cfg": dict(max_iter=30),
        "cmaes_cfg": dict(max_iter=40, eigen_interval=3, kick_tol=1e-3, kick_patience=2),
        "de_x0": np.abs(rng.uniform(0.5, 3.0, (4, 3))),
        "de_cfg": dict(pop_size=8, max_iter=40, eps=5e-2, best_value_no_change=8),
        "migration_interval": 3,
        "lbfgs_n": 64,
        "lbfgs_cfg": dict(memory=5, max_iter=100, grad_eps=1e-8),
    }


def lbfgs_meshes(world: int):
    return MESHES[world] + (((1, world),) if (1, world) not in MESHES[world] else ())


def lbfgs_problem(kind: str, n: int):
    """The coupled quadratic of tests/test_parallel.py:72-106, sum w (x - t)^2
    + mean(x)^2 with w = 1 (``"coupled"``) or w from 1 to 10
    (``"weighted"``, which takes L-BFGS some iterations): (t, w)."""
    t = np.linspace(-1.0, 1.0, n)
    return t, (np.ones(n) if kind == "coupled" else np.linspace(1.0, 10.0, n))


# ----------------------------------------------------------------- a rank


def _objectives():
    import torch

    import nlsolver_torch as nt

    def rosen_cols(X):
        return 100.0 * (X[1] - X[0] ** 2) ** 2 + (1.0 - X[0]) ** 2

    def make_residual(t):
        def residual(p, y):
            return p[0] * torch.exp(-p[1] * t) - y
        return residual

    return rosen_cols, make_residual, nt.PROBLEMS["rastrigin"].fn, nt.PROBLEMS["rosenbrock"].fn


def _raised(call):
    try:
        call()
    except Exception as e:  # the type and text of a refusal, compared with JAX's
        return type(e).__name__, str(e)
    return None, ""


def lbfgs_local(kind: str, n: int, mesh):
    """The shard-local objective and gradient of ``lbfgs_problem`` on
    ``mesh`` (``parallel.lbfgs_sharded``'s contract): the coupling term on
    the first block only."""
    import torch

    from nlsolver_torch.parallel import lbfgs_sharded as ls
    from nlsolver_torch.parallel.mesh import coordinate

    t, w = (torch.as_tensor(a)[ls.dim_block(n, mesh)] for a in lbfgs_problem(kind, n))
    first = coordinate(mesh)[1] == 0

    def fn_local(x):
        mean_x = ls.dim_sum(x.sum(), mesh) / n
        base = (w * (x - t) ** 2).sum()
        return base + mean_x ** 2 if first else base

    def grad_local(x):
        mean_x = ls.dim_sum(x.sum(), mesh) / n
        return 2.0 * w * (x - t) + 2.0 * mean_x / n

    return fn_local, grad_local


class Counted:
    """Within the block, calls of the named functions of ``module`` are
    logged in order in ``log`` (by name)."""

    def __init__(self, module, names, log):
        self.module, self.names, self.log = module, names, log

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for name, f in self.saved.items():
            def counted(*a, _f=f, _name=name, **k):
                self.log.append(_name)
                return _f(*a, **k)
            setattr(self.module, name, counted)
        return self.log

    def __exit__(self, *exc):
        for name, f in self.saved.items():
            setattr(self.module, name, f)


def run_new_engines(inp: dict, draws: dict, mesh, pop: int) -> dict:
    """The population-sharded PSO, both forms of the island DE and their
    API routes on ``mesh``, their calls of the gather, the ring and the
    world count logged."""
    import torch

    import nlsolver_torch as nt
    from nlsolver_torch.parallel import de_island, de_sharded, minimize_islands, pso_sharded

    _, _, rastrigin, rosenbrock = _objectives()
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    got = {}
    pso_cfg = nt.PSOConfig(**inp["pso_cfg"])
    log = []
    with Counted(pso_sharded, ("gather_swarm", "_generation"), log):
        got["pso"] = fields(pso_sharded.minimize_sharded(
            rastrigin, T(inp["free_x0"]), pso_cfg, mesh,
            draws=pso_sharded.PSOShardedDraws(*(torch.as_tensor(a) for a in draws["pso"]))))
    got["pso_calls"] = log
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    got["pso_philox"] = fields(nt.minimize(rastrigin, T(inp["free_x0"]), method="pso",
                                           layout="sharded", config=pso_cfg, mesh=mesh,
                                           generator=g()))
    got["pso_max"] = fields(nt.maximize(lambda x: -rastrigin(x), T(inp["free_x0"]),
                                        method="pso", layout="sharded", config=pso_cfg,
                                        mesh=mesh, generator=g()))
    island_draws = de_sharded.ShardedDraws(*(torch.as_tensor(a)
                                             for a in draws[f"island{pop}"]))
    every = inp["migration_interval"]
    for strategy in DE_STRATEGIES:
        cfg = nt.DEConfig(strategy=strategy, **inp["de_cfg"])
        for form in ISLAND_FORMS:
            log = []
            with Counted(de_island, ("_generation", "_local_generation", "island_stats",
                                     "ring_exchange", "all_sum", "best_member"), log):
                got[f"islands_{form}_{strategy}"] = fields(minimize_islands(
                    rosenbrock, T(inp["de_x0"]), cfg, mesh, every, fused=form == "fused",
                    draws=island_draws))
            got[f"islands_{form}_{strategy}_calls"] = log
        got[f"islands_sync3_{strategy}"] = fields(minimize_islands(
            rosenbrock, T(inp["de_x0"]), cfg, mesh, every, 3, draws=island_draws))
        for form in ISLAND_FORMS:
            got[f"islands_{form}_{strategy}_philox"] = fields(nt.minimize(
                rosenbrock, T(inp["de_x0"]), method="de", layout="islands", config=cfg,
                mesh=mesh, generator=g(), migration_interval=every, fused=form == "fused"))
    got["islands_max"] = fields(nt.maximize(lambda x: -rosenbrock(x), T(inp["de_x0"]),
                                            method="de", layout="islands",
                                            config=nt.DEConfig(**inp["de_cfg"]), mesh=mesh,
                                            generator=g(), migration_interval=every))
    return got


def run_engines(inp: dict, world: int, draws: dict) -> dict:
    """Every engine on every mesh of ``world``; each rank returns what it
    got (the global results)."""
    import torch

    import nlsolver_torch as nt
    from nlsolver_torch.parallel import (bfgs_minimize_fleet_sharded, de_sharded,
                                         distributed, fit_fleet_sharded, fit_sharded, make_mesh,
                                         minimize_fleet_sharded, minimize_islands,
                                         minimize_pso_fleet_sharded,
                                         minimize_sann_fleet_sharded, minimize_sharded,
                                         pso_minimize_sharded)
    from nlsolver_torch.parallel.lbfgs_sharded import minimize_dim_sharded

    rosen_cols, make_residual, rastrigin, rosenbrock = _objectives()
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    residual = make_residual(T(inp["t"]))
    out = {"process_slice": distributed.process_slice(8)}
    for dp, pop in MESHES[world]:
        mesh = make_mesh(world, dp=dp, pop=pop, device_type="cpu")
        got = out[(dp, pop)] = {}
        got["fit_sharded"] = fields(fit_sharded(residual, T(inp["nlls_X0"]).T.contiguous(),
                                                nt.NLLSConfig(**inp["fit_cfg"]), mesh,
                                                data=T(inp["ys"])))
        for strategy in DE_STRATEGIES:
            cfg = nt.DEConfig(strategy=strategy, **inp["de_cfg"])
            calls = {"gather": 0, "generation": 0}
            gather, generation = de_sharded.gather_population, de_sharded._generation

            def counted_gather(*a, **k):
                calls["gather"] += 1
                return gather(*a, **k)

            def counted_generation(*a, **k):
                calls["generation"] += 1
                return generation(*a, **k)

            de_sharded.gather_population, de_sharded._generation = counted_gather, \
                counted_generation
            try:
                de_draws = de_sharded.ShardedDraws(*(torch.as_tensor(a) for a in draws["de"]))
                got[f"de_{strategy}"] = fields(minimize_sharded(rosenbrock, T(inp["de_x0"]), cfg,
                                                                mesh, draws=de_draws))
            finally:
                de_sharded.gather_population, de_sharded._generation = gather, generation
            got[f"de_{strategy}_calls"] = calls
            got[f"de_{strategy}_philox"] = fields(nt.minimize(
                rosenbrock, T(inp["de_x0"]), method="de", layout="sharded", config=cfg,
                mesh=mesh, generator=torch.Generator().manual_seed(5)))
        got.update(run_new_engines(inp, draws, mesh, pop))
        # refusals (the JAX package's messages at this mesh's shape): widths
        # that do not divide over the mesh
        got["errors"] = {}
        x2 = torch.ones(2, 2, dtype=torch.float64)
        got["errors"]["islands_small"] = _raised(lambda: minimize_islands(
            rosenbrock, x2[:dp], nt.DEConfig(pop_size=3 * pop), mesh))
        if world > 1:
            got["errors"]["pso_width"] = _raised(lambda: pso_minimize_sharded(
                rastrigin, torch.ones(dp + 1 if dp > 1 else 2, 2, dtype=torch.float64),
                nt.PSOConfig(n_particles=pop + 5 if pop > 1 else 6), mesh))
            got["errors"]["islands_width"] = _raised(lambda: minimize_islands(
                rosenbrock, torch.ones(dp + 1 if dp > 1 else 2, 2, dtype=torch.float64),
                nt.DEConfig(pop_size=4 * pop + 1 if pop > 1 else 8), mesh))
        if pop > 1:
            got["errors"]["lbfgs_dim"] = _raised(lambda: minimize_dim_sharded(
                lambda x: x.sum(), lambda x: x, torch.zeros(pop + 1, dtype=torch.float64), mesh))
        if world > 1:
            got["errors"]["fleet_width"] = _raised(lambda: bfgs_minimize_fleet_sharded(
                rosen_cols, torch.zeros(2, 2 * world + 1, dtype=torch.float64),
                nt.BFGSFleetConfig(), mesh))
            got["errors"]["de_batch"] = _raised(lambda: minimize_sharded(
                rosenbrock, torch.ones(dp + 1 if dp > 1 else 2, 2, dtype=torch.float64),
                nt.DEConfig(pop_size=pop + 5 if pop > 1 else 6), mesh))
        if dp > 1:
            got["errors"]["fit_batch"] = _raised(lambda: fit_sharded(
                residual, torch.ones(dp + 1, 2, dtype=torch.float64), nt.NLLSConfig(), mesh))
    for dp, pop in lbfgs_meshes(world):
        mesh = make_mesh(world, dp=dp, pop=pop, device_type="cpu")
        got = out.setdefault((dp, pop), {})
        n = inp["lbfgs_n"]
        for kind in LBFGS_OBJECTIVES:
            fn_local, grad_local = lbfgs_local(kind, n, mesh)
            got[f"lbfgs_{kind}"] = fields(nt.minimize(
                fn_local, torch.zeros(n, dtype=torch.float64), method="lbfgs",
                layout="sharded", mesh=mesh, grad_local=grad_local, **inp["lbfgs_cfg"]))
    # the lane fleets shard over every device: the first mesh of the world
    mesh = make_mesh(world, *MESHES[world][0], device_type="cpu")
    fleets = out["fleets"] = {}
    fleets["bfgs"] = fields(bfgs_minimize_fleet_sharded(
        rosen_cols, T(inp["bfgs_X0"]), nt.BFGSFleetConfig(**inp["bfgs_cfg"]), mesh))
    fleets["bfgs_api"] = fields(nt.minimize(
        None, T(inp["bfgs_X0"]), method="bfgs", layout="sharded", mesh=mesh,
        config=nt.BFGSFleetConfig(**inp["bfgs_cfg"]), fn_cols=rosen_cols))
    for solve in NLLS_SOLVES:
        fleets[f"fit_fleet_{solve}"] = fields(fit_fleet_sharded(
            residual, T(inp["nlls_X0"]), nt.NLLSFleetConfig(solve=solve, **inp["nlls_cfg"]), mesh,
            data=T(inp["ys"])))
    x0 = T(inp["free_x0"])
    pso_cfg, sann_cfg = nt.PSOConfig(**inp["pso_cfg"]), nt.SANNConfig(**inp["sann_cfg"])
    cma_cfg = nt.CMAESFleetConfig(**inp["cmaes_cfg"])
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    fleets["pso"] = fields(minimize_pso_fleet_sharded(rastrigin, x0, pso_cfg, mesh, generator=g()))
    fleets["pso_api"] = fields(nt.maximize(lambda x: -rastrigin(x), x0, method="pso_batched",
                                           layout="sharded", config=pso_cfg, mesh=mesh,
                                           generator=g()))
    fleets["sann"] = fields(minimize_sann_fleet_sharded(rastrigin, x0, sann_cfg, mesh,
                                                        generator=g()))
    fleets["cmaes"] = fields(minimize_fleet_sharded(rastrigin, x0.T.contiguous(), cma_cfg, mesh,
                                                    generator=g()))
    fleets["cmaes_api"] = fields(nt.minimize(rastrigin, x0.T.contiguous(), method="cmaes",
                                             layout="sharded", config=cma_cfg, mesh=mesh,
                                             generator=g()))
    return out


def orbax_round_trip(path) -> dict:
    """A DE fleet on this rank's block of lanes (its own start points and
    generator): 5 steps, ``save_orbax`` with the generator, 5 more; then a
    fresh state and generator, ``load_orbax`` and the same 5 steps."""
    import torch
    import torch.distributed as dist

    import nlsolver_torch as nt
    from nlsolver_torch.parallel import distributed
    from nlsolver_torch.solvers import de_batched
    from nlsolver_torch.utils import checkpoint

    rastrigin = nt.PROBLEMS["rastrigin"].fn
    lo, hi = distributed.process_slice(8)
    x0 = torch.linspace(0.5, 2.0, 24, dtype=torch.float64).reshape(8, 3)[lo:hi]
    cfg = nt.DEConfig(pop_size=12, partner_sampling="uniform")

    def make():
        gen = torch.Generator().manual_seed(7 + dist.get_rank())
        return de_batched.init(rastrigin, x0, cfg, generator=gen, seed=7), gen

    def steps(state, gen):
        for _ in range(5):
            state = de_batched.step(rastrigin, state, cfg, generator=gen)
        return state

    state, gen = make()
    state = steps(state, gen)
    checkpoint.save_orbax(str(path), state, gen)
    went_on = steps(state, gen)
    like, fresh = make()
    fresh.manual_seed(12345)          # another stream until the checkpoint sets it
    restored = checkpoint.load_orbax(str(path), like, fresh)
    return {"saved": fields(state), "restored": fields(restored),
            "went_on": fields(went_on), "resumed": fields(steps(restored, fresh))}


def unsharded(inp: dict) -> dict:
    """The port's unsharded fleets on the inputs and generators of
    ``run_engines``."""
    import torch

    import nlsolver_torch as nt
    from nlsolver_torch.solvers import bfgs_fleet, cmaes_fleet, pso_batched, sann_batched

    rosen_cols, _, rastrigin, _ = _objectives()
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    x0 = T(inp["free_x0"])
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    return {
        "bfgs": fields(bfgs_fleet.minimize_fleet(rosen_cols, T(inp["bfgs_X0"]),
                                                 nt.BFGSFleetConfig(**inp["bfgs_cfg"]))),
        "pso": fields(pso_batched.minimize_batched(rastrigin, x0, nt.PSOConfig(**inp["pso_cfg"]),
                                                   generator=g())),
        "sann": fields(sann_batched.minimize_batched(rastrigin, x0,
                                                     nt.SANNConfig(**inp["sann_cfg"]),
                                                     generator=g())),
        "cmaes": fields(cmaes_fleet.minimize_fleet(rastrigin, x0.T.contiguous(),
                                                   nt.CMAESFleetConfig(**inp["cmaes_cfg"]),
                                                   generator=g())),
    }


def rank_main(rank: int, world: int, workdir: str) -> None:
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from nlsolver_torch.parallel import distributed

    work = Path(workdir)
    with open(work / "inputs.pkl", "rb") as f:
        inp, draws = pickle.load(f)
    distributed.initialize(device_type="cpu", init_method=f"file://{work / 'store'}",
                           world_size=world, rank=rank)
    try:
        out = run_engines(inp, world, draws)
        out["orbax"] = orbax_round_trip(work / "orbax")
        if rank == 0:
            out["unsharded"] = unsharded(inp)
    finally:
        dist.destroy_process_group()
    with open(work / f"out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


# ----------------------------------------------------------------- the parent


def run_worlds(worlds, root: Path, inp: dict, draws: dict) -> dict:
    """Every rank of every world at once; returns ``{world: [out of rank
    r]}``.  ``draws`` holds the JAX package's draws by engine: ``"de"``,
    ``"pso"`` and ``"island{k}"`` for k islands."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent.parent), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for world in worlds:
        work = root / f"world{world}"
        work.mkdir(parents=True, exist_ok=True)
        with open(work / "inputs.pkl", "wb") as f:
            pickle.dump((inp, draws), f)
        for rank in range(world):
            procs.append((world, rank, work, subprocess.Popen(
                [sys.executable, __file__, str(rank), str(world), str(work)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)))
    outs = {}
    try:
        for world, rank, work, proc in procs:
            log, _ = proc.communicate(timeout=RANK_TIMEOUT)
            if proc.returncode != 0:
                raise RuntimeError(f"world {world} rank {rank} exited {proc.returncode}:\n"
                                   f"{log[-4000:]}")
            with open(work / f"out{rank}.pkl", "rb") as f:
                outs.setdefault(world, []).append(pickle.load(f))
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
