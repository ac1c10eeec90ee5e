"""Objective-function handling (counterpart of
``nlsolver_tpu.core.objective``).

An objective is a callable ``f(x[..., n]) -> [...]`` that reduces over the
last axis, so one call scores a whole batch; this takes the place of the
JAX package's ``vmap`` over single points.  Maximization is minimization
of ``-f``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

Objective = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class Bounds:
    """Box bounds, broadcastable against x."""

    lower: torch.Tensor
    upper: torch.Tensor


def signed(fn: Objective, minimize: bool) -> Objective:
    """Sign-wrap: maximization == minimization of -f."""
    if minimize:
        return fn
    return lambda x: -fn(x)


def with_eval_dtype(fn: Objective, dtype: torch.dtype) -> Objective:
    """Evaluate ``fn`` in ``dtype`` (for example ``torch.bfloat16``) and
    cast the score back to the query's dtype, so the solver's bookkeeping
    keeps its own precision."""

    def wrapped(x: torch.Tensor) -> torch.Tensor:
        return fn(x.to(dtype)).to(x.dtype)

    return wrapped


def batch_eval(fn: Objective, xs: torch.Tensor) -> torch.Tensor:
    """Evaluate ``fn`` over a batch of points ``[B, n] -> [B]``."""
    out = fn(xs)
    if out.shape != xs.shape[:-1]:
        raise ValueError(
            f"objective must reduce over the last axis: {tuple(xs.shape)} "
            f"gave {tuple(out.shape)}"
        )
    return out


def resolve_bounds(
    bounds: Optional[Bounds], x0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Return ``(lower, upper, bounded)`` broadcast to ``x0``."""
    if bounds is None:
        big = torch.full_like(x0, float("inf"))
        return -big, big, False
    lower = torch.as_tensor(bounds.lower, dtype=x0.dtype, device=x0.device)
    upper = torch.as_tensor(bounds.upper, dtype=x0.dtype, device=x0.device)
    return lower.expand_as(x0), upper.expand_as(x0), True
