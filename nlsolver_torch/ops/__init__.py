from .de_fused import de_generation_fused, de_generation_reference
from .eigh_jacobi import (
    eigh_jacobi_global,
    eigh_jacobi_kernel,
    eigh_jacobi_pallas,
    eigh_jacobi_registers,
    eigh_jacobi_resident,
)
from .qr_wavefront import (
    least_squares_wavefront_kernel,
    least_squares_wavefront_reference,
    qr_wavefront_global,
    qr_wavefront_kernel,
    qr_wavefront_reference,
    qr_wavefront_warp,
)
from .rank2 import (
    rank2_direction_batchminor,
    rank2_direction_batchminor_cluster,
    rank2_direction_batchminor_kernel,
    rank2_direction_batchminor_reference,
    rank2_direction_batchminor_resident,
    rank2_direction_batchminor_rowsplit,
    rank2_update_batched,
    rank2_update_batched_kernel,
    rank2_update_batched_reference,
    rank2_update_reference,
)
from .smallchol import (
    solve_spd_batched,
    solve_spd_batched_kernel,
    solve_spd_batchminor,
)

__all__ = [
    "de_generation_fused",
    "de_generation_reference",
    "eigh_jacobi_global",
    "eigh_jacobi_kernel",
    "eigh_jacobi_pallas",
    "eigh_jacobi_registers",
    "eigh_jacobi_resident",
    "least_squares_wavefront_kernel",
    "least_squares_wavefront_reference",
    "qr_wavefront_global",
    "qr_wavefront_kernel",
    "qr_wavefront_reference",
    "qr_wavefront_warp",
    "rank2_direction_batchminor",
    "rank2_direction_batchminor_cluster",
    "rank2_direction_batchminor_kernel",
    "rank2_direction_batchminor_reference",
    "rank2_direction_batchminor_resident",
    "rank2_direction_batchminor_rowsplit",
    "rank2_update_batched",
    "rank2_update_batched_kernel",
    "rank2_update_batched_reference",
    "rank2_update_reference",
    "solve_spd_batched",
    "solve_spd_batched_kernel",
    "solve_spd_batchminor",
]
