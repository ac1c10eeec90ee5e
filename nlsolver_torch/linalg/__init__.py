from .eigh_qr import Eigh, eigh, eigh_qr
from .givens import QR, givens_rotation, qr, qr_givens, validate_qr
from .jacobi import eigh_jacobi, round_robin_schedule
from .qr_parallel import backsolve_bm, least_squares_parallel, qr_parallel
from .solve import (
    backsolve,
    cholesky,
    damped_solve,
    forwardsolve,
    least_squares,
    solve_cholesky,
)

__all__ = [
    "Eigh",
    "QR",
    "backsolve",
    "cholesky",
    "eigh",
    "eigh_jacobi",
    "eigh_qr",
    "damped_solve",
    "forwardsolve",
    "givens_rotation",
    "least_squares",
    "qr",
    "qr_givens",
    "qr_parallel",
    "least_squares_parallel",
    "round_robin_schedule",
    "backsolve_bm",
    "solve_cholesky",
    "validate_qr",
]
