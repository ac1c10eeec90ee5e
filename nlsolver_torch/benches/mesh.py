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

The population engines with no unsharded twin run on every split of the
world too, each timed once after a short warm-up at the same shapes (its
first generations or iterations: the subgroups' communicators and the
allocator's blocks are made there), each row with its seconds,
generations (iterations), ms a generation, converged share and whether
every rank returned the same bits: ``pso_sharded`` (its draws keyed by
particle, so every split must give the first's bits), both forms of the
island DE (the island count is the split's pop, and it changes the
algorithm by design: no two splits of one world share it, so none is
compared with another) and the dimension-sharded L-BFGS on the coupled
quadratic of the JAX package's tests and on its weighted form, which
takes it through its history (a split of another pop adds its partial
sums in another order: its counters and values are compared with the
first's, not its bits).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time

import torch
import torch.distributed as dist

from .. import api
from ..core import SolverResult
from ..parallel import distributed, make_mesh
from ..parallel.mesh import all_gather, coordinate
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


@contextlib.contextmanager
def counted_twins():
    """Within the block, the calls of the plain twins of the routes'
    kernels are counted, by name."""
    twins = {name: 0 for _, name in _twins()}
    saved = []
    for mod, name in _twins():
        twin = getattr(mod, name)
        saved.append((mod, name, twin))

        def counted(*a, _twin=twin, _name=name, **k):
            twins[_name] += 1
            return _twin(*a, **k)

        setattr(mod, name, counted)
    try:
        yield twins
    finally:
        for mod, name, twin in saved:
            setattr(mod, name, twin)


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
    rows = {}
    with counted_twins() as twins:
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
    return rows


def _splits(world: int):
    return [(dp, world // dp) for dp in range(1, world + 1) if world % dp == 0]


def ranks_agree(res: SolverResult) -> bool:
    """Whether every rank of the world holds the same bits of ``res`` (one
    gather of its fields, packed as float64)."""
    packed = torch.cat([torch.nan_to_num(f.reshape(-1).to(torch.float64)) for f in res])
    g = all_gather(packed[None], None, dim=0)
    return bool((g == g[0]).all())


def _row(res: SolverResult, wall: float) -> dict:
    gens = int(res.iterations.max())
    return {"s": wall, "generations": gens, "ms_a_generation": wall / max(gens, 1) * 1e3,
            "converged": float(res.converged.float().mean()), "ranks_agree": ranks_agree(res)}


def _gen(device):
    return torch.Generator(device=device).manual_seed(0)


WARM_GENERATIONS = 20   # a population engine's warm-up: two migration intervals


def _warm_timed(run, warm, device):
    """``_timed(run)`` after one call of ``warm``."""
    warm()
    _sync(device)
    return _timed(run, device)


def run_de(world: int, device, scale: int = 1, device_type=None) -> dict:
    """``de_sharded`` on 8192 / scale 10-D Rastrigin instances of 64 agents
    on every (dp, pop) split of the world, each compared with the first."""
    B = max(8192 // scale, world)
    widths = torch.full((B, 10), 10.24, device=device)
    cfg = api.DEConfig(pop_size=64, max_iter=1000)
    rows, first = {}, None
    for dp, pop in _splits(world):
        mesh = make_mesh(world, dp=dp, pop=pop, device_type=device_type)
        res, wall, _ = _timed(lambda: api.minimize(
            PROBLEMS["rastrigin"].fn, widths, method="de", layout="sharded", mesh=mesh,
            config=cfg, generator=_gen(device)), device)
        first = res if first is None else first
        rows[f"{dp}x{pop}"] = {**_row(res, wall), **_compare(res, first), "result": res}
    return {f"de_sharded [{B}, 10] P=64": rows}


def run_pso(world: int, device, scale: int = 1, device_type=None,
            dtype=torch.float32) -> dict:
    """``pso_sharded`` on 8192 / scale 10-D Rastrigin instances, 64
    particles starting in [-5.12, 5.12] (the DE's box, of width 10.24), on
    every split, each compared with the first: bit-equal, as the draws are
    keyed by particle."""
    B = max(8192 // scale, world)
    x0 = torch.full((B, 10), 5.12, device=device, dtype=dtype)
    cfg = api.PSOConfig(n_particles=64, max_iter=1000)
    rows, first = {}, None
    for dp, pop in _splits(world):
        mesh = make_mesh(world, dp=dp, pop=pop, device_type=device_type)

        def run(cfg=cfg):
            return api.minimize(PROBLEMS["rastrigin"].fn, x0, method="pso", layout="sharded",
                                mesh=mesh, config=cfg, generator=_gen(device))

        res, wall, _ = _warm_timed(run, lambda: run(dataclasses.replace(
            cfg, max_iter=WARM_GENERATIONS)), device)
        first = res if first is None else first
        rows[f"{dp}x{pop}"] = {**_row(res, wall), **_compare(res, first), "result": res}
    return {f"pso_sharded [{B}, 10] P=64": rows}


def run_islands(world: int, device, scale: int = 1, device_type=None,
                dtype=torch.float32) -> dict:
    """The island DE on the DE's instances (8192 / scale), 64 agents, a
    migration every 10 generations, eager and fused, on every split: the
    island count is the split's pop."""
    B = max(8192 // scale, world)
    widths = torch.full((B, 10), 10.24, device=device, dtype=dtype)
    cfg = api.DEConfig(pop_size=64, max_iter=1000)
    out = {}
    for fused in (False, True):
        rows = out[f"de_island{' fused' if fused else ''} [{B}, 10] P=64"] = {}
        for dp, pop in _splits(world):
            mesh = make_mesh(world, dp=dp, pop=pop, device_type=device_type)

            def run(cfg=cfg):
                return api.minimize(PROBLEMS["rastrigin"].fn, widths, method="de",
                                    layout="islands", mesh=mesh, config=cfg,
                                    generator=_gen(device), migration_interval=10, fused=fused)

            res, wall, _ = _warm_timed(run, lambda: run(dataclasses.replace(
                cfg, max_iter=WARM_GENERATIONS)), device)
            rows[f"{dp}x{pop}"] = {**_row(res, wall), "islands": pop, "result": res}
    return out


LBFGS_OBJECTIVES = ("coupled", "weighted")


def coupled_quadratic(n: int, mesh, device, weighted: bool = False):
    """The coupled quadratic of the JAX package's tests
    (tests/test_parallel.py:72-106), sum w (x - t)^2 + mean(x)^2 with t =
    linspace(-1, 1, n) and w = 1, or w = linspace(1, 10, n) where
    ``weighted`` (which takes the L-BFGS through its history; from x = 0
    the unweighted one ends in its first step), made on the host so every
    device holds the same bits, in float64, shard-local as
    ``parallel.lbfgs_sharded`` asks: (t's block, fn_local, grad_local).
    As t sums to 0, the minimum of both is x = t."""
    from ..parallel.lbfgs_sharded import dim_block, dim_sum

    block = dim_block(n, mesh)
    t = torch.linspace(-1.0, 1.0, n, dtype=torch.float64)[block].to(device)
    w = (torch.linspace(1.0, 10.0, n, dtype=torch.float64)[block].to(device) if weighted
         else 1.0)
    first = coordinate(mesh)[1] == 0

    def fn_local(x):
        mean_x = dim_sum(x.sum(), mesh) / n
        base = (w * (x - t) ** 2).sum()
        return base + mean_x ** 2 if first else base

    def grad_local(x):
        mean_x = dim_sum(x.sum(), mesh) / n
        return 2.0 * w * (x - t) + 2.0 * mean_x / n

    return t, fn_local, grad_local


def run_lbfgs(world: int, device, scale: int = 1, device_type=None) -> dict:
    """The dimension-sharded L-BFGS on the coupled quadratic and its
    weighted form at n = 2^23 / scale in float64 on every split, each
    compared with the first (its counters and value; a split of another
    pop sums in another order), with the largest |x - t|."""
    n = max((1 << 23) // scale, world)
    t = torch.linspace(-1.0, 1.0, n, dtype=torch.float64).to(device)
    out = {}
    for kind in LBFGS_OBJECTIVES:
        rows = out[f"lbfgs_sharded {kind} n={n}"] = {}
        first = None
        for dp, pop in _splits(world):
            mesh = make_mesh(world, dp=dp, pop=pop, device_type=device_type)
            _, fn_local, grad_local = coupled_quadratic(n, mesh, device, kind == "weighted")
            x0 = torch.zeros(n, dtype=torch.float64, device=device)

            def run(max_iter=100):
                return api.minimize(fn_local, x0, method="lbfgs", layout="sharded", mesh=mesh,
                                    grad_local=grad_local, max_iter=max_iter)

            res, wall, _ = _warm_timed(run, lambda: run(2), device)
            first = res if first is None else first
            rows[f"{dp}x{pop}"] = {**_row(res, wall), **_compare(res, first),
                                   "x_err": float((res.x - t).abs().max()), "result": res}
    return out


def _split_product(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # the 32x32 -> 64-bit product of ``ops.de_fused._mulhilo`` from m's
    # 16-bit halves: no partial product reaches 2^63
    p0 = c * (m & 0xFFFF)
    p1 = c * (m >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (t >> 32), t & 0xFFFFFFFF


def probe_philox_product(device, scale: int = 1, pairs: int = 2, device_type=None) -> dict:
    """``de_sharded`` and ``pso_sharded`` on a world of one rank, their
    Philox draws' product taken as one wrapping int64 multiply
    (``ops.de_fused._mulhilo``, 4 element ops) and from 16-bit halves (7),
    after a warm-up, in ``pairs`` pairs that take turns at going first:
    each arm's ms a generation, by engine, and whether the arms' results
    are bit-equal."""
    from ..ops import de_fused

    arms = {"wrapping": de_fused._mulhilo, "split": _split_product}
    ms = {arm: {"de_sharded": [], "pso_sharded": []} for arm in arms}
    results = {arm: {} for arm in arms}
    engines = {"de_sharded": run_de, "pso_sharded": run_pso}
    try:
        for run in engines.values():
            run(1, device, scale, device_type)
        for pair in range(pairs):
            for arm in (("wrapping", "split") if pair % 2 == 0 else ("split", "wrapping")):
                de_fused._mulhilo = arms[arm]
                for name, run in engines.items():
                    (rows,) = run(1, device, scale, device_type).values()
                    ms[arm][name].append(rows["1x1"]["ms_a_generation"])
                    results[arm][name] = rows["1x1"]["result"]
    finally:
        de_fused._mulhilo = arms["wrapping"]
    return {"ms_a_generation": ms, "bit_equal": {
        name: _compare(results["wrapping"][name], results["split"][name])["bit_equal"]
        for name in engines}}


def _public(rows: dict) -> dict:
    """``rows`` without the results they keep for a caller in the process."""
    return {name: {split: {k: v for k, v in row.items() if k != "result"}
                   for split, row in by_split.items()} for name, by_split in rows.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--scale", type=int, default=1, help="cut every batch by this factor")
    parser.add_argument("--out", default=None, help="rank 0 writes its JSON object here")
    args = parser.parse_args(argv)
    distributed.initialize(args.device)
    mesh = distributed.global_mesh(device_type=args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
              else torch.device("cpu"))
    try:
        out = {"world": world, "mesh": str(mesh), "backend": str(dist.get_backend()),
               "device": (torch.cuda.get_device_name(device) if args.device == "cuda" else "cpu"),
               "routes": run_routes(mesh, device, args.scale),
               **_public(run_de(world, device, args.scale, args.device)),
               **_public(run_pso(world, device, args.scale, args.device)),
               **_public(run_islands(world, device, args.scale, args.device)),
               **_public(run_lbfgs(world, device, args.scale, args.device))}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
