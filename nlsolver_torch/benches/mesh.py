"""The mesh routes across a world of ranks, one device a rank, each against
its unsharded engine run whole on the rank's own device.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m nlsolver_torch.benches.mesh [--out FILE]
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m nlsolver_torch.benches.mesh --device cpu --scale 256     # gloo, tiny

Every rank runs every route on the world's mesh (``distributed.global_mesh``)
and the unsharded engine on the same global inputs, after a warm-up of
each, four times each in pairs that take turns at going first (unsharded,
sharded; sharded, unsharded; ...); it checks that
the route's kernel ran on its lanes and no plain twin did, and reports
whether the two results are equal bit for bit and, where not, how far
they part: a rank scores its lanes in a batch of another width, and a
reduction inside the objective (a ``sum`` over a strided axis under
``vmap``) may then add in another order.  ``de_sharded``, which has no
unsharded engine that draws as it does, runs on every (dp, pop) split of
the world and is compared across them.  Rank 0 prints one JSON object
(and writes it to ``--out``): each route's seconds in the order they were
taken, its speedup (the median unsharded run over the median sharded one:
the whole fleet on one device against its lanes spread over the world),
its launches on rank 0 and the comparison.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch
import torch.distributed as dist

from .. import api
from ..core import SolverResult
from ..parallel import distributed, make_mesh
from ..problems import PROBLEMS


def _kernels():
    from ..ops import eigh_jacobi, qr_wavefront, rank2, smallchol

    return {"K4a": rank2.rank2_direction_batchminor_resident,
            "K2b-r": qr_wavefront.least_squares_wavefront_registers,
            "K3-r": smallchol.solve_spd_registers, "K5r": eigh_jacobi.eigh_jacobi_registers}


def _twins():
    from ..ops import eigh_jacobi, qr_wavefront, rank2, smallchol

    return ((rank2, "rank2_direction_batchminor_reference"),
            (qr_wavefront, "least_squares_wavefront_reference"),
            (smallchol, "_chol_solve_batchminor"), (eigh_jacobi, "eigh_jacobi"))


def _compare(a: SolverResult, b: SolverResult) -> dict:
    """Whether two results are equal bit for bit, the share of lanes whose
    counters agree and the largest |f_a - f_b| / max(|f_b|, 1)."""
    same = all(x.shape == y.shape and x.dtype == y.dtype
               and bool(torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)))
               for x, y in zip(a, b))
    agree = (a.iterations == b.iterations) & (a.function_calls == b.function_calls)
    rel = (a.f_value - b.f_value).abs() / b.f_value.abs().clamp_min(1.0)
    return {"bit_equal": same, "counters_agree": float(agree.float().mean()),
            "f_rel_diff_max": float(rel.max())}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def routes(device, scale: int = 1):
    """``{name: (kernel id or None, unsharded(), sharded(mesh))}`` at the
    scenarios of ``chip_smoke.py`` phase 27 (the BFGS bowls with one scale a
    coordinate, the CMA-ES run for 50 generations), every batch cut by
    ``scale``."""
    from ..benches import bowls_scenario, expfit_scenario, rastrigin_fleet_config
    from ..solvers.bfgs_fleet import BFGSFleetConfig
    from ..solvers.nlls import NLLSConfig
    from ..solvers.nlls_fleet import NLLSFleetConfig
    from ..solvers.pso import PSOConfig
    from ..solvers.sann import SANNConfig

    out = {}
    B = 65536 // scale
    # a column objective sees a rank's block of lanes, so the bowls' scales
    # go by coordinate and their centers become the start points
    _, centers, scales = bowls_scenario(B, 16, device=device)
    s0 = scales[:, :1].clone()

    def fn_cols(X):
        return (s0 * X * X).sum(dim=0)

    X0 = -centers
    cfg = BFGSFleetConfig(max_iter=30)
    out[f"bfgs [16, {B}]"] = ("K4a", lambda: api.minimize(
        None, X0, method="bfgs", layout="fleet", config=cfg, fn_cols=fn_cols),
        lambda mesh: api.minimize(None, X0, method="bfgs", layout="sharded", mesh=mesh,
                                  config=cfg, fn_cols=fn_cols))
    B = 262144 // scale
    residual, ys, _ = expfit_scenario(B, 32, device=device)
    Xn = torch.ones(2, B, device=device)
    for solve, kid in (("qr_pallas", "K2b-r"), ("cholesky", "K3-r")):
        fcfg = NLLSFleetConfig(max_iter=30, solve=solve)
        out[f"fit_fleet {solve} [2, {B}]"] = (kid, lambda fcfg=fcfg: api.fit_fleet(
            residual, Xn, fcfg, data=ys), lambda mesh, fcfg=fcfg: api.fit_fleet_sharded(
            residual, Xn, fcfg, mesh=mesh, data=ys))
    B = 65536 // scale
    ccfg = dataclasses.replace(rastrigin_fleet_config("pallas"), max_iter=50)
    Xc = torch.full((16, B), -0.5, device=device)
    rastrigin = PROBLEMS["rastrigin"].fn

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    out[f"cmaes [16, {B}]"] = ("K5r", lambda: api.minimize(
        rastrigin, Xc, method="cmaes", layout="fleet", config=ccfg, generator=gen()),
        lambda mesh: api.minimize(rastrigin, Xc, method="cmaes", layout="sharded", mesh=mesh,
                                  config=ccfg, generator=gen()))
    B = max(8192 // scale, 8)
    x0 = torch.full((B, 100), -0.5, device=device)
    for method, sharded_method, mcfg in (("pso", "pso_batched", PSOConfig(n_particles=32,
                                                                            max_iter=100)),
                                         ("sann", "sann", SANNConfig(max_iter=100))):
        out[f"{sharded_method} [{B}, 100]"] = (None, lambda method=method, mcfg=mcfg: api.minimize(
            rastrigin, x0, method=method, layout="batched", config=mcfg, generator=gen()),
            lambda mesh, m=sharded_method, mcfg=mcfg: api.minimize(
                rastrigin, x0, method=m, layout="sharded", mesh=mesh, config=mcfg,
                generator=gen()))
    residual_b, ys_b, _ = expfit_scenario(B, 32, device=device)
    x0s = torch.ones(B, 2, device=device)
    out[f"fit_sharded [{B}, 2]"] = (None, lambda: api.fit_batched(
        residual_b, x0s, NLLSConfig(max_iter=30), data=ys_b), lambda mesh: api.fit_sharded(
        residual_b, x0s, NLLSConfig(max_iter=30), mesh=mesh, data=ys_b))
    return out


def _timed(run, device):
    launches = {k: f.launches for k, f in _kernels().items()}
    t0 = time.perf_counter()
    res = run()
    _sync(device)
    wall = time.perf_counter() - t0
    return res, wall, {k: f.launches - launches[k] for k, f in _kernels().items()
                       if f.launches > launches[k]}


def run_routes(mesh, device, scale: int = 1) -> dict:
    """Every route against its unsharded engine on ``mesh``: see the module
    docstring.  Raises on a result that differs, a twin that ran or a
    kernel that did not."""
    twins = {name: 0 for _, name in _twins()}
    saved = []
    for mod, name in _twins():
        twin = getattr(mod, name)
        saved.append((mod, name, twin))

        def counted(*a, _twin=twin, _name=name, **k):
            twins[_name] += 1
            return _twin(*a, **k)

        setattr(mod, name, counted)
    rows = {}
    try:
        for name, (kid, unsharded, sharded) in routes(device, scale).items():
            arms = {"unsharded": unsharded, "sharded": lambda: sharded(mesh)}
            ref, _, launched_u = _timed(arms["unsharded"], device)
            res, _, launched_s = _timed(arms["sharded"], device)
            if torch.device(device).type == "cuda" and (
                    set(launched_s) != ({kid} if kid else set()) or any(twins.values())):
                raise RuntimeError(f"{name}: launched {launched_s}, twins {twins}")
            walls = {arm: [] for arm in arms}
            for pair in range(4):
                for arm in (("unsharded", "sharded") if pair % 2 == 0
                            else ("sharded", "unsharded")):
                    walls[arm].append(_timed(arms[arm], device)[1])
            rows[name] = {"unsharded_s": walls["unsharded"], "sharded_s": walls["sharded"],
                          "speedup": (statistics.median(walls["unsharded"])
                                      / statistics.median(walls["sharded"])),
                          "launches_sharded": launched_s, "launches_unsharded": launched_u,
                          **_compare(res, ref)}
    finally:
        for mod, name, twin in saved:
            setattr(mod, name, twin)
    return rows


def run_de(world: int, device, scale: int = 1, device_type=None) -> dict:
    """``de_sharded`` on 8192 / scale 10-D Rastrigin instances of 64 agents
    on every (dp, pop) split of the world, each compared with the first."""
    B = max(8192 // scale, world)
    widths = torch.full((B, 10), 10.24, device=device)
    cfg = api.DEConfig(pop_size=64, max_iter=1000)
    rows, first = {}, None
    for dp in [d for d in range(1, world + 1) if world % d == 0]:
        mesh = make_mesh(world, dp=dp, pop=world // dp, device_type=device_type)
        res, wall, _ = _timed(lambda: api.minimize(
            PROBLEMS["rastrigin"].fn, widths, method="de", layout="sharded", mesh=mesh,
            config=cfg, generator=torch.Generator(device=device).manual_seed(0)), device)
        first = res if first is None else first
        gens = int(res.iterations.max())
        rows[f"{dp}x{world // dp}"] = {"s": wall, "generations": gens,
                                       "ms_a_generation": wall / max(gens, 1) * 1e3,
                                       "converged": float(res.converged.float().mean()),
                                       **_compare(res, first)}
    return {f"de_sharded [{B}, 10] P=64": rows}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--scale", type=int, default=1, help="cut every batch by this factor")
    parser.add_argument("--out", default=None, help="rank 0 writes its JSON object here")
    args = parser.parse_args(argv)
    distributed.initialize()
    mesh = distributed.global_mesh(device_type=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
              else torch.device("cpu"))
    try:
        out = {"world": world, "mesh": str(mesh), "backend": str(dist.get_backend()),
               "device": (torch.cuda.get_device_name(device) if args.device == "cuda" else "cpu"),
               "routes": run_routes(mesh, device, args.scale),
               **run_de(world, device, args.scale, args.device)}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
