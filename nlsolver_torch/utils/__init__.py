from .checkpoint import load, save
from .observability import debug_nans, log_compiles, trace
from .timing import Benchmarker, Stopwatch, StreamingMedian, benchmark, benchmark_versions

__all__ = [
    "Benchmarker",
    "Stopwatch",
    "StreamingMedian",
    "benchmark",
    "benchmark_versions",
    "debug_nans",
    "load",
    "log_compiles",
    "save",
    "trace",
]
