"""nlsolver_torch: the PyTorch / CUDA port of nlsolver_tpu for NVIDIA Hopper.

Ported so far: the batched Differential Evolution fleet
(``minimize(fn, x0[B, n], method="de", layout="batched")``) and its fused
generation kernel (``ops.de_fused``, CUDA C++ in ``csrc/``).  The package
imports ``torch`` and never ``jax``.
"""
from .api import maximize, minimize
from .core import SolverResult
from .problems import PROBLEMS
from .solvers.de import DEConfig

__all__ = ["DEConfig", "PROBLEMS", "SolverResult", "maximize", "minimize"]
