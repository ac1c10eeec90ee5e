"""Benchmark scenarios of the port (counterpart of
``nlsolver_tpu.benches``): the batched-DE headline, the NLLS fleet and
the BFGS fleet.

Method, as in the JAX package: a fixed-trip run so every run does the
same work, warm-up runs, then the median of the timed runs, each fenced
by ``torch.cuda.synchronize()``.  A measurement needs a CUDA card; there
is no CPU fallback.
"""
from __future__ import annotations

import statistics
import time

import torch

from ..core.driver import drive_fleet_scan, drive_scan
from ..problems import PROBLEMS
from ..solvers import bfgs_fleet as bf
from ..solvers import de_batched as deb
from ..solvers import nlls_fleet as nf
from ..solvers.de import DEConfig


def _timed(run, runs=5, warmup=2):
    for _ in range(warmup):
        run()
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times)


def bench_de_batched(B=8192, dim=10, pop=64, iters=200, runs=5, fused: bool = False):
    """Batched DE on Rastrigin: ``B`` instances of ``dim`` dimensions, ``pop``
    agents each, rotation partners, ``iters`` generations per run.
    ``fused=True`` runs each generation through the CUDA kernel, otherwise
    through the plain PyTorch step."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_de_batched measures a CUDA card; none is available")
    device = torch.device("cuda")
    fn = PROBLEMS["rastrigin"].fn
    x0 = torch.full((B, dim), -0.5, dtype=torch.float32, device=device)
    cfg = DEConfig(
        pop_size=pop, max_iter=1 << 30, best_value_no_change=1 << 30,
        eps=0.0, partner_sampling="rotation", use_fused_kernel=fused,
    )

    def run():
        g = torch.Generator(device=device).manual_seed(0)
        state = deb.init(fn, x0, cfg, generator=g)
        final = drive_scan(lambda s: deb.step(fn, s, cfg, generator=g), state, iters)
        return final.scores.amin(dim=-1)

    med, mn = _timed(run, runs)
    # traffic model per generation: agents and scores read and written once
    bytes_per_gen = (2 * B * pop * dim + 2 * B * pop) * 4
    return {
        "name": "de_batched_torch" + ("_fused" if fused else "_plain"),
        "device": torch.cuda.get_device_name(0),
        "instances": B,
        "generations": iters,
        "iters_per_sec": B * iters / med,
        "median_ms": med * 1e3,
        "min_ms": mn * 1e3,
        "model_gbps": bytes_per_gen * iters / med / 1e9,
    }


def expfit_scenario(B: int, m: int = 32, seed: int = 0, device="cuda", dtype=torch.float32):
    """The NLLS fleet's scenario (the JAX package's config #5): ``B`` curves
    ``y = a exp(-k t)`` on ``t = linspace(0, 2, m)``, amplitudes a ~ U[1, 3]
    and rates k ~ U[0.5, 2] drawn from ``seed`` on ``device``.  Returns
    ``(residual, ys [B, m], truth [2, B])``; ``residual(p, y_i)`` is the
    per-lane residual that ``fit_fleet`` takes."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.linspace(0.0, 2.0, m, dtype=dtype, device=device)
    amps = 1.0 + 2.0 * torch.rand(B, generator=g, dtype=dtype, device=device)
    rates = 0.5 + 1.5 * torch.rand(B, generator=g, dtype=dtype, device=device)
    ys = amps[:, None] * torch.exp(-rates[:, None] * t[None, :])

    def residual(p, y_i):
        return p[0] * torch.exp(-p[1] * t) - y_i

    return residual, ys, torch.stack([amps, rates])


def bench_nlls_fleet(B=262144, m=32, runs=3, solve="qr_pallas", steps=32):
    """The NLLS fleet on ``B`` exp-decay fits (``expfit_scenario``), f32,
    ``max_iter=30``, fixed trip: ``steps`` host steps with finished lanes
    frozen, from ``X0 = ones(2, B)``.  ``solve`` picks the backend:
    ``qr_pallas`` (kernel K2b), ``cholesky`` (kernel K3) or ``qr`` (the
    plain wavefront).  One warm-up, then the median of ``runs``."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_nlls_fleet measures a CUDA card; none is available")
    device = torch.device("cuda")
    residual, ys, _ = expfit_scenario(B, m, device=device)
    cfg = nf.NLLSFleetConfig(max_iter=30, solve=solve)
    X0 = torch.ones(2, B, dtype=torch.float32, device=device)

    def run():
        state = nf.init(residual, X0, cfg, ys)
        return drive_fleet_scan(lambda s: nf.advance(residual, s, cfg, ys), state, steps)

    med, mn = _timed(run, runs, warmup=1)
    final = run()
    return {
        "name": f"nlls_fleet_torch_{solve}",
        "device": torch.cuda.get_device_name(0),
        "instances": B,
        "m": m,
        "steps": steps,
        "fits_per_sec": B / med,
        "median_ms": med * 1e3,
        "min_ms": mn * 1e3,
        "solved_frac": float((final.cost < 1e-6).float().mean()),
    }


def bowls_scenario(B: int, dim: int = 16, seed: int = 0, device="cuda", dtype=torch.float32):
    """The BFGS fleet's scenario (the JAX package's config #4a): ``B``
    anisotropic bowls ``f_b(x) = sum(scales_b * (x - centers_b)**2)`` with
    centers ~ N(0, 1) and scales ~ U[0.5, 3] drawn from ``seed`` on
    ``device``.  Returns ``(fn_cols, centers [dim, B], scales [dim, B])``;
    ``fn_cols`` closes over the per-lane data."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((dim, B), generator=g, dtype=dtype, device=device)
    scales = 0.5 + 2.5 * torch.rand((dim, B), generator=g, dtype=dtype, device=device)

    def fn_cols(X):
        return (scales * (X - centers) ** 2).sum(dim=0)

    return fn_cols, centers, scales


def bench_bfgs_fleet(B=65536, dim=16, runs=5, linesearch="more_thuente"):
    """The BFGS fleet on ``B`` bowls (``bowls_scenario``), f32,
    ``max_iter=30``, from ``X0 = zeros(dim, B)``, run until every lane
    halts.  ``linesearch`` is ``more_thuente`` or ``speculative``; the
    rank-2 update + direction runs through kernel K4a (K4b where ``dim`` is
    too large for it).  One warm-up, then the median of ``runs``."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_bfgs_fleet measures a CUDA card; none is available")
    device = torch.device("cuda")
    fn_cols, _, _ = bowls_scenario(B, dim, device=device)
    cfg = bf.BFGSFleetConfig(max_iter=30, linesearch=linesearch)
    X0 = torch.zeros(dim, B, dtype=torch.float32, device=device)

    def run():
        return bf.minimize_fleet(fn_cols, X0, cfg)

    med, mn = _timed(run, runs, warmup=1)
    res = run()
    total_iters = int(res.iterations.sum())
    return {
        "name": f"bfgs_fleet_torch_{linesearch}",
        "device": torch.cuda.get_device_name(0),
        "instances": B,
        "dim": dim,
        "linesearch": linesearch,
        # the last lane to finish halts on step max(iterations) + 1
        "host_steps": int(res.iterations.max()) + 1,
        "total_iterations": total_iters,
        "iters_per_sec": total_iters / med,
        "median_ms": med * 1e3,
        "min_ms": mn * 1e3,
        "solved_frac": float((res.f_value < 1e-4).float().mean()),
        "converged_frac": float(res.converged.float().mean()),
    }


def unconverged_bowls(B=65536, dim=16, linesearch="more_thuente"):
    """The lanes of ``bench_bfgs_fleet``'s fleet that halt without
    ``converged`` (by the stalled-gradient-norm rule or ``max_iter``), as
    numpy arrays: their index ``lane``, their data ``centers`` and ``scales``
    ``[dim, k]``, and the card's ``x``, ``iterations`` and
    ``function_calls``.  The same lanes can then go through another
    implementation, since lanes are independent."""
    if not torch.cuda.is_available():
        raise RuntimeError("unconverged_bowls runs the fleet on a CUDA card; none is available")
    device = torch.device("cuda")
    fn_cols, centers, scales = bowls_scenario(B, dim, device=device)
    res = bf.minimize_fleet(fn_cols, torch.zeros(dim, B, dtype=torch.float32, device=device),
                            bf.BFGSFleetConfig(max_iter=30, linesearch=linesearch))
    lane = torch.nonzero(~res.converged).flatten()
    out = {"lane": lane, "centers": centers[:, lane], "scales": scales[:, lane],
           "x": res.x[:, lane], "iterations": res.iterations[lane],
           "function_calls": res.function_calls[lane]}
    return {k: v.cpu().numpy() for k, v in out.items()}


def profile_bfgs_fleet(B=65536, dim=16, linesearch="more_thuente", top=5):
    """One run of ``bench_bfgs_fleet``'s fleet under ``torch.profiler``
    (CPU and CUDA activities), after a warm-up run: wall time under the
    profiler, device busy time (the sum of the device kernels' times) and
    device kernel launches, in all and per host step, and the ``top``
    kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("profile_bfgs_fleet measures a CUDA card; none is available")
    device = torch.device("cuda")
    fn_cols, _, _ = bowls_scenario(B, dim, device=device)
    cfg = bf.BFGSFleetConfig(max_iter=30, linesearch=linesearch)
    X0 = torch.zeros(dim, B, dtype=torch.float32, device=device)
    bf.minimize_fleet(fn_cols, X0, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = bf.minimize_fleet(fn_cols, X0, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    steps = int(res.iterations.max()) + 1
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "name": f"bfgs_fleet_torch_{linesearch}_profile",
        "device": torch.cuda.get_device_name(0),
        "host_steps": steps,
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e6 / wall,
        "device_launches": launches,
        "launches_per_step": launches / steps,
        "top_kernels": [(e.key[:96], e.count, e.self_device_time_total / 1e3)
                        for e in kernels[:top]],
    }
