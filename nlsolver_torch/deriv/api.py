"""Derivative providers (counterpart of ``nlsolver_tpu.deriv.api``).

The reference's gradient solvers take any ``Grad`` functor and default to
finite differences (``fin_diff`` / ``fin_diff_h``, nlsolver.h:2848-2863).
Here, as in the JAX package, the provider is a small frozen config that
chooses autodiff (``torch.func.grad`` / ``torch.func.hessian``) or the
reference's FD stencils; a solver may also take a gradient callable.

``make_grad`` / ``make_hessian`` return ``(callable, f_evals_per_call)``:
the callable maps one point ``[n]`` to its gradient ``[n]`` or Hessian
``[n, n]``, and ``f_evals_per_call`` is the number of objective
evaluations one call costs, which keeps ``function_calls`` faithful to the
reference's accounting.  The solvers ``vmap`` the callable over lanes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from torch.func import grad, hessian

from .fd import fd_gradient, fd_gradient_cost, fd_hessian, fd_hessian_cost


@dataclass(frozen=True)
class Deriv:
    """Derivative provider config.

    mode: "autodiff" (torch.func.grad / torch.func.hessian) or "fd"
    (reference stencils).  accuracy: FD accuracy level (ignored for
    autodiff)."""

    mode: str = "autodiff"
    accuracy: int = 1


def make_grad(fn, n: int, deriv: Deriv = Deriv(), custom: Optional[Callable] = None):
    """Return (grad_fn, f_evals_per_call)."""
    if custom is not None:
        return custom, 0
    if deriv.mode == "fd":
        return (lambda x: fd_gradient(fn, x, deriv.accuracy),
                fd_gradient_cost(n, deriv.accuracy))
    return grad(fn), 0


def make_hessian(fn, n: int, deriv: Deriv = Deriv(), custom: Optional[Callable] = None):
    """Return (hess_fn, f_evals_per_call)."""
    if custom is not None:
        return custom, 0
    if deriv.mode == "fd":
        return (lambda x: fd_hessian(fn, x, deriv.accuracy),
                fd_hessian_cost(n, deriv.accuracy))
    return hessian(fn), 0
