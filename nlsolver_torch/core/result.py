"""Solver result / status reporting.

PyTorch counterpart of ``nlsolver_tpu.core.result`` (the reference's
``solver_status`` struct, nlsolver.h:2054-2097): an immutable record of
tensors with the same seven fields.  Batched solves give each field a
leading batch dimension.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SolverResult(NamedTuple):
    """Outcome of a solver run; every field is a tensor."""

    x: torch.Tensor               # final parameters, shape [..., n]
    f_value: torch.Tensor         # objective at x (sign-corrected for maximize)
    iterations: torch.Tensor      # algorithm iterations used
    function_calls: torch.Tensor  # objective evaluations used
    gradient_calls: torch.Tensor  # gradient evaluations used
    hessian_calls: torch.Tensor   # hessian evaluations used
    converged: torch.Tensor       # True if a tolerance criterion fired (not max_iter)

    def get_summary(self):
        """Mirror of solver_status::get_summary (nlsolver.h:2079-2083)."""
        return (
            self.function_calls,
            self.iterations,
            self.f_value,
            self.gradient_calls,
            self.hessian_calls,
        )

    def add(self, other: "SolverResult") -> "SolverResult":
        """Accumulate counters across restarts (nlsolver.h:2084-2091);
        keeps ``other``'s solution and f_value."""
        return SolverResult(
            x=other.x,
            f_value=other.f_value,
            iterations=self.iterations + other.iterations,
            function_calls=self.function_calls + other.function_calls,
            gradient_calls=self.gradient_calls + other.gradient_calls,
            hessian_calls=self.hessian_calls + other.hessian_calls,
            converged=other.converged,
        )

    def print(self) -> None:
        """Host-side pretty printer (mirrors nlsolver.h:2065-2078)."""
        print(f"Function calls used: {int(self.function_calls.sum())}")
        print(f"Algorithm iterations used: {int(self.iterations.sum())}")
        g = int(self.gradient_calls.sum())
        if g > 0:
            print(f"Gradient evaluations used: {g}")
        h = int(self.hessian_calls.sum())
        if h > 0:
            print(f"Hessian evaluations used: {h}")
        fv = self.f_value
        if fv.ndim == 0:
            print(f"With final function value of {float(fv)}")
        else:
            print(
                f"With best final function value of {float(fv.min())} "
                f"(batch of {tuple(fv.shape)})"
            )


def make_result(
    x: torch.Tensor,
    f_value: torch.Tensor,
    iterations,
    function_calls,
    gradient_calls=0,
    hessian_calls=0,
    converged=False,
) -> SolverResult:
    """Build a ``SolverResult``; counters become int32 and the flag bool,
    on ``x``'s device."""
    dev = x.device

    def as_i32(v):
        return torch.as_tensor(v, dtype=torch.int32, device=dev)

    return SolverResult(
        x=x,
        f_value=f_value,
        iterations=as_i32(iterations),
        function_calls=as_i32(function_calls),
        gradient_calls=as_i32(gradient_calls),
        hessian_calls=as_i32(hessian_calls),
        converged=torch.as_tensor(converged, dtype=torch.bool, device=dev),
    )
