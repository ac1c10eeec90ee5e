"""Sampling utilities on an explicit ``torch.Generator`` (counterpart of
``nlsolver_tpu.random.sampling``).  Where the JAX package split keys, the
port passes the generator that draws; the same seed gives other numbers
than JAX, so parity tests feed both packages the same draws."""
from __future__ import annotations

from typing import Optional

import torch


def uniform_like(
    generator: torch.Generator, template: torch.Tensor, shape=None
) -> torch.Tensor:
    """U[0, 1) draws with ``template``'s dtype and device."""
    shape = template.shape if shape is None else shape
    return torch.rand(
        shape, generator=generator, dtype=template.dtype, device=template.device
    )


def distinct_indices(
    generator: Optional[torch.Generator],
    pop_size: int,
    fixed: torch.Tensor,
    k: int = 3,
    raw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Draw ``k`` mutually distinct indices in ``[0, pop_size)``, each also
    distinct from ``fixed``.

    The successive-shift sampler of the JAX package (replacing the
    reference's rejection loop, nlsolver.h:2331-2355): the j-th draw is
    uniform over ``pop_size - 1 - j`` values and is shifted past the
    sorted indices already excluded, which gives the uniform distribution
    over ordered distinct tuples.

    Args:
      fixed: integer tensor of reserved indices, any shape.
      raw: the draws before the shift, ``fixed.shape + (k,)``, draw j
        uniform in ``[0, pop_size - 1 - j)`` (the JAX sampler's
        ``randint`` draws of ``split(key, k)``); ``generator`` draws them
        when it is None.
    Returns:
      int64 tensor of shape ``fixed.shape + (k,)``.
    """
    if pop_size < k + 1:
        raise ValueError(f"need pop_size >= {k + 1} for {k} distinct partners")
    fixed = fixed.to(torch.int64)
    exclusions = fixed[..., None]
    out = []
    for j in range(k):
        if raw is None:
            r = torch.randint(
                0, pop_size - 1 - j, fixed.shape, generator=generator,
                device=fixed.device,
            )
        else:
            r = raw[..., j].to(torch.int64)
        sorted_ex = exclusions.sort(dim=-1).values
        for e in range(sorted_ex.shape[-1]):
            r = r + (r >= sorted_ex[..., e]).to(torch.int64)
        out.append(r)
        exclusions = torch.cat([exclusions, r[..., None]], dim=-1)
    return torch.stack(out, dim=-1)


def rnorm(generator: Optional[torch.Generator], shape=(), dtype=torch.float32,
          device=None) -> torch.Tensor:
    """Standard normal draws from ``generator`` (the JAX package's
    ``jax.random.normal`` of a key).  The reference uses a Box-Muller
    transform with pi truncated to 3.141593 (nlsolver.h:2479-2494);
    ``box_muller_parity`` reproduces it for the replays."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def box_muller_parity(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """The reference's Box-Muller (nlsolver.h:2479-2485): given two
    uniforms, ``sqrt(-2 log u1) * cos(2 pi_ u2)`` with pi_ = 3.141593, its
    arithmetic in the uniforms' dtype and its ``log``, ``cos`` and ``sqrt``
    the C library's (``core.utils.c_math``), as the reference binary's."""
    from ..core.utils import c_math

    pi_trunc = 3.141593
    return c_math("sqrt", -2.0 * c_math("log", u1)) * c_math("cos", 2.0 * pi_trunc * u2)
