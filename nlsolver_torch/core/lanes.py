"""A single-point objective scored over lane tensors.

The single-instance solvers of the port (BFGS, L-BFGS, GD, ...) run every
lane of a batch at once: points ``[B, n]``, every scalar a ``[B]`` vector,
the layout ``jax.vmap`` gives the JAX solvers.  ``Lanes`` holds the user's
single-point objective and maps it, or its gradient or Hessian, over the
lanes with ``torch.func.vmap``.  With ``data`` (a tensor or a tuple of
tensors whose leading axis is the lane axis) the objective is
``fn(x, data_b)``, one lane's slice, as in ``fit_batched``: that is how a
batch of different problems (config #4a's bowls) runs as one.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vmap


def _same(f):
    return f


class Lanes:
    """``fn`` on one point, mapped over lanes; ``minimize=False`` scores
    ``-fn`` (maximization is minimization of ``-f``)."""

    def __init__(self, fn: Callable, data=None, minimize: bool = True):
        self.data = data
        self.fn = fn if minimize else (lambda *a: -fn(*a))

    def map(self, make: Callable, X: torch.Tensor, in_dim: int = 0, out_dim: int = 0):
        """``vmap`` of ``make(f)`` over the lanes of ``X`` (its axis
        ``in_dim``), ``f`` each lane's single-point objective."""
        if self.data is None:
            return vmap(make(self.fn), in_dims=in_dim, out_dims=out_dim)(X)
        fn = self.fn
        return vmap(lambda x, d: make(lambda p: fn(p, d))(x), in_dims=(in_dim, 0),
                    out_dims=out_dim)(X, self.data)

    def values(self, X: torch.Tensor) -> torch.Tensor:
        """``[B, n] -> [B]``."""
        return self.map(_same, X)

    def points(self, X: torch.Tensor) -> torch.Tensor:
        """Several points of each lane, ``[B, K, n] -> [B, K]``: a simplex,
        a population.  Without data, one ``vmap`` over all B K points."""
        B, K, n = X.shape
        if self.data is None:
            return vmap(self.fn)(X.reshape(B * K, n)).reshape(B, K)
        fn = self.fn
        return vmap(lambda xs, d: vmap(lambda p: fn(p, d))(xs))(X, self.data)

    def grid(self, A: torch.Tensor) -> torch.Tensor:
        """Several points of each lane, batch-minor as the lane fleets keep
        them: ``[n, K, B] -> [K, B]``.  Without data, one ``vmap`` over the
        K B columns."""
        n, K, B = A.shape
        if self.data is None:
            return vmap(self.fn, in_dims=1)(A.reshape(n, K * B)).reshape(K, B)
        return self.points(A.permute(2, 1, 0)).T

    def columns(self, make_point: Optional[Callable] = None):
        """The column form of the fleets' line search: ``[n, B] -> [B]``,
        and with ``make_point`` (a single-point gradient maker)
        ``[n, B] -> [n, B]``."""
        if make_point is None:
            return lambda Xc: self.map(_same, Xc, in_dim=1)
        return lambda Xc: self.map(make_point, Xc, in_dim=1, out_dim=1)


def as_lanes(fn, data=None) -> Lanes:
    """``fn`` itself where it is a ``Lanes``, else ``Lanes(fn, data)``."""
    if isinstance(fn, Lanes):
        if data is not None:
            raise ValueError("data= goes to Lanes(fn, data), not beside it")
        return fn
    return Lanes(fn, data)


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[B, n] . [B, n] -> [B]``: ``jnp.dot`` of one lane, on every lane."""
    return (a * b).sum(dim=-1)


def lane_norm(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` of one lane's vector, ``sqrt(sum(a * a))``, on
    every lane."""
    return (a * a).sum(dim=-1).sqrt()


def matvec(H: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``[B, n, n] @ [B, n] -> [B, n]``."""
    return (H @ v[..., None])[..., 0]
