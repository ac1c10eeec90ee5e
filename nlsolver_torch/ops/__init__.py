from .de_fused import de_generation_fused, de_generation_reference
from .qr_wavefront import (
    least_squares_wavefront_kernel,
    least_squares_wavefront_reference,
    qr_wavefront_kernel,
    qr_wavefront_reference,
)
from .smallchol import (
    solve_spd_batched,
    solve_spd_batched_kernel,
    solve_spd_batchminor,
)

__all__ = [
    "de_generation_fused",
    "de_generation_reference",
    "least_squares_wavefront_kernel",
    "least_squares_wavefront_reference",
    "qr_wavefront_kernel",
    "qr_wavefront_reference",
    "solve_spd_batched",
    "solve_spd_batched_kernel",
    "solve_spd_batchminor",
]
