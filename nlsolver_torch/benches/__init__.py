"""Benchmark scenarios of the port (counterpart of
``nlsolver_tpu.benches``): the batched-DE headline and the NLLS fleet.

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
