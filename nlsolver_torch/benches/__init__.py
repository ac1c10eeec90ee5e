"""Benchmark scenarios of the port (counterpart of
``nlsolver_tpu.benches``; only the batched-DE headline so far).

Method, as in the JAX package: a fixed-trip run (``drive_scan``) so every
run does the same work, 2 warm-up runs, then the median of 5, each run
fenced by ``torch.cuda.synchronize()``.  A measurement needs a CUDA card;
there is no CPU fallback.
"""
from __future__ import annotations

import statistics
import time

import torch

from ..core.driver import drive_scan
from ..problems import PROBLEMS
from ..solvers import de_batched as deb
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
