"""nlsolver_torch: the PyTorch / CUDA port of nlsolver_tpu for NVIDIA Hopper.

Ported so far: the batched Differential Evolution fleet
(``minimize(fn, x0[B, n], method="de", layout="batched")``) with its fused
generation kernel (``ops.de_fused``), the batch-minor BFGS fleet
(``minimize(fn, x0[n, B], method="bfgs", layout="fleet")``) with its line
searches (``linesearch``) and its rank-2 update + direction kernels
(``ops.rank2``), the batch-minor CMA-ES fleet
(``minimize(fn, x0[n, B], method="cmaes", layout="fleet")``) with its
batched Jacobi eigensolver kernel (``ops.eigh_jacobi``) and the
single-instance ``solvers.cmaes``, and nonlinear least squares (``fit``,
``fit_batched``, ``curve_fit`` and the batch-minor ``fit_fleet``) with the
wavefront QR / least-squares kernels (``ops.qr_wavefront``) and the
batch-minor Cholesky solve (``ops.smallchol``); the lane fleets of PSO and
SANN (``minimize(fn, x0[B, n], method="pso" | "sann", layout="batched")``)
and the seven 1-D root finders (``root(fn, lower[B], upper[B])``), which
carry no kernel; and the single-instance solvers with derivatives (BFGS,
L-BFGS, L-BFGS-B, GD, CGD, LM) and the Brent-based ones (Brent,
coordinate descent) on lane tensors
(``minimize(fn, x0[n], method="bfgs")``, ``layout="batched"`` for
``x0[B, n]``), with their derivative providers (``deriv``) and the Armijo
search; BFGS's update runs the leading-batch rank-2 kernel on the card;
and the derivative-free single-instance solvers on lane tensors (Nelder-Mead,
the default method of ``minimize(fn, x0)``, the row-layout DE, PSO and SANN,
and the NM-PSO hybrid), with the API's ``methods()`` and its multistart
(``restarts=``); the CMA-ES on lane tensors
(``minimize(fn, x0[B, n], method="cmaes", layout="batched")``), the
reference generators and the bit-exact replays of the reference DE, SANN,
accelerated PSO and NM-PSO (``random.reference_rngs``, ``random.mt19937``,
``solvers.*_reference``), trajectory capture (``nlsolver_torch.trace``)
and the golden-trajectory runners (``nlsolver_torch.parity``).  The
kernels are CUDA C++ in ``csrc/``.  The package
imports ``torch`` and never ``jax``.
"""
from .api import (curve_fit, fit, fit_batched, fit_fleet, fit_fleet_sharded, fit_sharded,
                  maximize, methods, minimize, root, root_methods)
from .core import Bounds, SolverResult
from .problems import PROBLEMS
from .deriv import Deriv
from .solvers.bfgs import BFGSConfig
from .solvers.bfgs_fleet import BFGSFleetConfig
from .solvers.brent import BrentConfig
from .solvers.cgd import CGDConfig
from .solvers.cmaes import CMAESConfig
from .solvers.cmaes_fleet import CMAESFleetConfig
from .solvers.coordinate import CoordinateDescentConfig
from .solvers.de import DEConfig
from .solvers.gd import GDConfig
from .solvers.lbfgs import LBFGSConfig
from .solvers.lbfgsb import LBFGSBConfig
from .solvers.lm import LMConfig
from .solvers.nelder_mead import NelderMeadConfig
from .solvers.nlls import NLLSConfig
from .solvers.nlls_fleet import NLLSFleetConfig
from .solvers.nmpso import NMPSOConfig
from .solvers.pso import PSOConfig
from .solvers.rootfind import RootResult
from .solvers.sann import SANNConfig

__all__ = [
    "BFGSConfig",
    "BFGSFleetConfig",
    "Bounds",
    "BrentConfig",
    "CGDConfig",
    "CMAESConfig",
    "CMAESFleetConfig",
    "CoordinateDescentConfig",
    "DEConfig",
    "Deriv",
    "GDConfig",
    "LBFGSBConfig",
    "LBFGSConfig",
    "LMConfig",
    "NMPSOConfig",
    "NelderMeadConfig",
    "NLLSConfig",
    "NLLSFleetConfig",
    "PROBLEMS",
    "PSOConfig",
    "RootResult",
    "SANNConfig",
    "SolverResult",
    "curve_fit",
    "fit",
    "fit_batched",
    "fit_fleet",
    "fit_fleet_sharded",
    "fit_sharded",
    "maximize",
    "methods",
    "minimize",
    "root",
    "root_methods",
]
