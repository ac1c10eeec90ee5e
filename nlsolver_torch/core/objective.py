"""Objective-function handling (counterpart of
``nlsolver_tpu.core.objective``).

An objective is a callable ``f(x[n]) -> scalar`` on one point, as in the
JAX package: it may index coordinates (``x[0]``, ``x[1]``) or reduce over
them (``x.sum()``, ``x.sum(-1)``, ``x[..., i]``).  Every solver of the port
scores a batch of points through ``torch.func.vmap`` of it, with the axes
the JAX package's ``jax.vmap`` uses, and takes gradients and Hessians with
``torch.func.grad`` and ``torch.func.hessian`` under the same ``vmap``, so
``fn`` must be written in torch operations that ``torch.func`` can batch
(no ``.item()``, no Python branch on a value).  Maximization is
minimization of ``-f``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.func import vmap

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
    """Evaluate ``fn`` over a batch of points ``[B, n] -> [B]``: ``vmap``
    over the leading axis, so ``fn`` sees one point, the last axis."""
    out = vmap(fn)(xs)
    if out.shape != xs.shape[:-1]:
        raise ValueError(
            f"objective must map one point, the last axis, to a scalar: "
            f"{tuple(xs.shape)} gave {tuple(out.shape)}"
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
