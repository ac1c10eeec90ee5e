"""Benchmark harness (counterpart of ``nlsolver_tpu.utils.timing``).

The reference's utils.h timing toolkit (Stopwatch :46-63, StreamingMedian
:77-117, benchmark / Benchmarker / benchmark_versions :121-210) for
PyTorch's asynchronous CUDA execution: a timed call whose outputs hold a
tensor on a card ends with ``torch.cuda.synchronize()``, where the JAX
package calls ``block_until_ready``, so the card's work is in the time and
not only its enqueue.  Statistics are the same median-of-runs.
"""
from __future__ import annotations

import heapq
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch


class Stopwatch:
    """Context-manager stopwatch (reference: RAII Stopwatch, utils.h:46-63)."""

    def __init__(self, name: str = "", verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed_us = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_us = (time.perf_counter() - self._t0) * 1e6
        if self.verbose:
            label = f"[{self.name}] " if self.name else ""
            print(f"{label}elapsed: {self.elapsed_us:.1f}us")
        return False


class StreamingMedian:
    """Two-heap running median (reference: utils.h:77-117)."""

    def __init__(self):
        self._lower: list = []  # max-heap (negated)
        self._upper: list = []  # min-heap

    def push(self, v: float) -> None:
        if not self._lower or v <= -self._lower[0]:
            heapq.heappush(self._lower, -v)
        else:
            heapq.heappush(self._upper, v)
        if len(self._lower) > len(self._upper) + 1:
            heapq.heappush(self._upper, -heapq.heappop(self._lower))
        elif len(self._upper) > len(self._lower):
            heapq.heappush(self._lower, -heapq.heappop(self._upper))

    @property
    def median(self) -> float:
        if not self._lower:
            return 0.0
        if len(self._lower) == len(self._upper):
            return (-self._lower[0] + self._upper[0]) / 2.0
        return -self._lower[0]


def _on_card(out: Any) -> bool:
    """Whether ``out`` (a tensor, or a tuple, list or dict of them) holds a
    tensor on a CUDA card."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_card(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_card(v) for v in out)
    return False


def fence(out: Any) -> Any:
    """Wait for the card when ``out`` holds a tensor there; returns ``out``."""
    if _on_card(out):
        torch.cuda.synchronize()
    return out


def benchmark(
    fn: Callable, *args, runs: int = 10, warmup: int = 2, **kwargs
) -> Dict[str, float]:
    """Median-of-runs timing (reference: benchmark, utils.h:121-149).

    Returns mean/median/min/max in microseconds; each call is fenced by
    :func:`fence`."""
    for _ in range(warmup):
        fence(fn(*args, **kwargs))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fence(fn(*args, **kwargs))
        times.append((time.perf_counter() - t0) * 1e6)
    return {
        "mean_us": statistics.fmean(times),
        "median_us": statistics.median(times),
        "min_us": min(times),
        "max_us": max(times),
        "runs": runs,
    }


@dataclass
class Benchmarker:
    """A/B speedup harness (reference: Benchmarker, utils.h:151-195)."""

    runs: int = 10
    warmup: int = 2
    results: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def run(self, name: str, fn: Callable, *args, **kwargs) -> Dict[str, float]:
        stats = benchmark(fn, *args, runs=self.runs, warmup=self.warmup, **kwargs)
        self.results[name] = stats
        return stats

    def speedup(self, baseline: str, candidate: str) -> float:
        """Median-time ratio baseline/candidate (>1 => candidate faster)."""
        return (
            self.results[baseline]["median_us"]
            / self.results[candidate]["median_us"]
        )

    def report(self) -> str:
        lines = []
        for name, s in self.results.items():
            lines.append(
                f"{name}: median {s['median_us']:.1f}us "
                f"(mean {s['mean_us']:.1f}, min {s['min_us']:.1f}, "
                f"max {s['max_us']:.1f}, n={s['runs']})"
            )
        return "\n".join(lines)


def benchmark_versions(versions: Dict[str, Callable], *args, baseline: str = None,
                       runs: int = 10, warmup: int = 2, **kwargs) -> Dict[str, Any]:
    """Time each of ``versions`` (name -> callable, all on the same
    arguments) and give each one's speedup over ``baseline`` (the first
    name by default), the median-time ratio (reference:
    benchmark_versions, utils.h:197-210)."""
    if not versions:
        raise ValueError("benchmark_versions needs at least one version")
    bench = Benchmarker(runs=runs, warmup=warmup)
    for name, fn in versions.items():
        bench.run(name, fn, *args, **kwargs)
    base = next(iter(versions)) if baseline is None else baseline
    return {
        "results": bench.results,
        "speedup": {name: bench.speedup(base, name) for name in versions},
        "baseline": base,
    }
