"""Tracing and debugging hooks (counterpart of
``nlsolver_tpu.utils.observability``).

The reference's observability is its ``solver_status`` counters and raw
stdout (SURVEY.md section 5).  Here:

  * counters ride in every solver state and ``SolverResult``;
  * ``trace()`` records a block with ``torch.profiler`` (the card's CUDA
    activity too, where there is a card) into a trace file that
    TensorBoard and Chrome's trace viewer read;
  * ``debug_nans()`` raises at the first operation whose floating-point
    output holds a NaN, as ``jax_debug_nans`` does: a
    ``TorchDispatchMode`` checks every operation's outputs, forward and
    backward (``torch.autograd.detect_anomaly`` checks only the backward);
  * ``log_compiles()`` logs each build and each load of the kernel
    library by ``ops._build``, the port's form of a compilation.
"""
from __future__ import annotations

import contextlib
import logging

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..ops import _build


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block into ``logdir`` (one ``*.pt.trace.json`` file, for
    TensorBoard's profiler plugin or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class _NaNCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the first operation whose
    floating-point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the block, an operation that makes a NaN raises
    ``FloatingPointError`` (each check reads the card)."""
    if not enable:
        yield
        return
    with _NaNCheck():
        yield


@contextlib.contextmanager
def log_compiles(enable: bool = True):
    """Log each build and load of the kernel library (``ops._build``) to
    standard error within the block."""
    logger = _build.LOG
    prev = logger.level
    handler = logging.StreamHandler()
    logger.setLevel(logging.INFO if enable else logging.WARNING)
    if enable:
        logger.addHandler(handler)
    try:
        yield
    finally:
        logger.removeHandler(handler)
        logger.setLevel(prev)
