from .api import Deriv, make_grad, make_hessian
from .fd import FDConfig, fd_gradient, fd_gradient_cost, fd_hessian, fd_hessian_cost

__all__ = [
    "Deriv",
    "FDConfig",
    "fd_gradient",
    "fd_gradient_cost",
    "fd_hessian",
    "fd_hessian_cost",
    "make_grad",
    "make_hessian",
]
