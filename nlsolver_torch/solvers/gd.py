"""Gradient descent with five stepping strategies, on lane tensors
(counterpart of ``nlsolver_tpu.solvers.gd``; the reference's
``GradientDescent``, nlsolver.h:2816-3035).

Step types: ``linesearch`` (More-Thuente), ``fixed``, ``bigstep`` (the
248-entry "long steps" table of Grimmer, arXiv:2307.06324, laid out as the
reference's fixed_steps, nlsolver.h:2875-2899), ``anneal``
(alpha / (1 + iter / max_iter), nlsolver.h:2997) and ``page``
(probabilistic gradient correction, nlsolver.h:3018-3031), with the JAX
package's variants ("default", "reference", "safeguarded").  The layout is
that of ``solvers.bfgs``: ``x [B, n]``, every scalar a ``[B]`` vector.

PAGE draws one uniform a step in each lane.  The JAX solver splits a
per-lane ``key``; here ``step`` takes the lanes' uniforms as ``draws [B]``
or draws them from a ``torch.Generator``, and ``minimize_batched`` takes
``draws [T, B]``, lane b reading row ``iteration[b]`` (its own key chain's
T-th uniform in JAX), so a parity test feeds JAX's own draws.  The state
has no ``key``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, SolverResult, drive, where_lanes
from ..core.lanes import Lanes, as_lanes, lane_norm
from ..deriv import Deriv, make_grad
from ..linesearch.more_thuente import more_thuente_fleet
from ._lane import finalize, grad_cost, lane_full, no_bounds, run_batched, run_single, true_div

# the "long steps" periodic step-size patterns, laid out exactly as the
# reference's fixed_steps table (nlsolver.h:2875-2899): level -> (offset,
# length) into the flat table (nlsolver.h:2825-2847)
_T = 1.4
BIGSTEP_TABLE = (
    # level 1 (len 2)
    2.9, 1.5,
    # level 2 (len 3)
    1.5, 4.9, 1.5,
    # level 3 (len 7)
    1.5, 2.2, 1.5, 12.0, 1.5, 2.2, 1.5,
    # level 4 (len 15)
    1.4, 2.0, 1.4, 4.5, 1.4, 2.0, 1.4, 29.7, 1.4, 2.0, 1.4, 4.5, 1.4, 2.0, 1.4,
    # level 5 (len 31)
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 8.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    72.3,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 8.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    # level 6 (len 63)
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    14.2,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    164.0,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    14.2,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    # level 7 (len 127)
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    12.6,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    23.5,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    12.6,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    370.0,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    12.6,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    23.5,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.5, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
    12.6,
    1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4, 7.2, 1.4, 2.0, 1.4, 3.9, 1.4, 2.0, 1.4,
)
BIGSTEP_OFFSETS = {1: (0, 2), 2: (2, 3), 3: (5, 7), 4: (12, 15), 5: (27, 31), 6: (58, 63), 7: (121, 127)}
assert len(BIGSTEP_TABLE) == 248


@dataclass(frozen=True)
class GDConfig:
    """Defaults from nlsolver.h:2903-2916."""

    step_type: str = "fixed"   # linesearch | fixed | bigstep | anneal | page
    alpha: float = 1.0
    max_iter: int = 500
    grad_eps: float = 1e-12
    minibatch: int = 128          # PAGE b
    minibatch_prime: int = 11     # PAGE b'
    bigstep_level: int = 5
    lipschitz_scaling: bool = True  # bigstep: divide step by max grad norm seen
    deriv: Deriv = field(default_factory=Deriv)
    # "default": correct gradient descent.  "reference": trajectory parity
    # with two reference quirks: for fixed and page, ``alpha_ *=
    # f_multiplier`` (nlsolver.h:3014) compounds, so minimization alternates
    # descent (even iterations, 0-based) and ascent (odd ones); PAGE's
    # switch probability is size_t division (nlsolver.h:2944-2945) = 0, so
    # the correction is taken every iteration.  "safeguarded" (anneal
    # only): divide the annealed step by the largest gradient norm seen.
    variant: str = "default"


class GDState(NamedTuple):
    x: torch.Tensor              # [B, n]
    gradient: torch.Tensor       # [B, n]
    prev_gradient: torch.Tensor  # [B, n]
    iteration: torch.Tensor      # [B] int32
    nfev: torch.Tensor           # [B] int32
    gfev: torch.Tensor           # [B] int32
    max_grad_norm: torch.Tensor  # [B]
    done: torch.Tensor           # [B] bool
    converged: torch.Tensor      # [B] bool


def init(fn, x0: torch.Tensor, config: GDConfig = GDConfig(), *, data=None) -> GDState:
    lanes = as_lanes(fn, data)
    n = x0.shape[-1]
    g = lanes.map(lambda f: make_grad(f, n, config.deriv)[0], x0)
    i32 = torch.int32
    return GDState(
        x=x0,
        gradient=g,
        prev_gradient=torch.zeros_like(g),
        iteration=lane_full(x0, 0, i32),
        nfev=lane_full(x0, grad_cost(n, config.deriv), i32),
        gfev=lane_full(x0, 1, i32),
        max_grad_norm=lane_full(x0, 0.0),
        done=lane_full(x0, False, torch.bool),
        converged=lane_full(x0, False, torch.bool),
    )


def page_draws(state: GDState, draws: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """This step's PAGE uniforms ``[B]``: ``draws [B]`` as given, or row
    ``iteration[b]`` of ``draws [T, B]`` for lane b, or fresh ones from
    ``generator``."""
    x = state.x
    if draws is None:
        return torch.rand(x.shape[:1], generator=generator, dtype=x.dtype, device=x.device)
    draws = torch.as_tensor(draws, dtype=x.dtype, device=x.device)
    if draws.ndim == 1:
        return draws
    row = state.iteration.long().clamp(max=draws.shape[0] - 1)
    return draws[row, torch.arange(x.shape[0], device=x.device)]


def step(fn, state: GDState, config: GDConfig = GDConfig(), *, draws=None, generator=None,
         data=None) -> GDState:
    lanes = as_lanes(fn, data)
    x = state.x
    dtype, dev = x.dtype, x.device
    n = x.shape[-1]
    grad_point = lambda f: make_grad(f, n, config.deriv)[0]  # noqa: E731
    g_cost = grad_cost(n, config.deriv)

    grad_norm = lane_norm(state.gradient)
    max_grad_norm = torch.maximum(state.max_grad_norm, grad_norm)
    hit_tol = grad_norm < config.grad_eps
    done_now = (state.iteration >= config.max_iter) | hit_tol | torch.isinf(grad_norm)

    nfev, gfev = state.nfev, state.gfev
    alpha = torch.full_like(grad_norm, config.alpha)
    if config.step_type == "linesearch":
        direction = -state.gradient
        f0 = lanes.values(x)
        nfev = nfev + 1
        ls = more_thuente_fleet(lanes.columns(), lanes.columns(grad_point), x.T, f0,
                                state.gradient.T, direction.T, config.alpha)
        alpha = ls.alpha
        nfev = nfev + ls.nfev * (1 + g_cost)
        gfev = gfev + ls.nfev
    elif config.step_type == "anneal":
        # cooling schedule (nlsolver.h:2997); a true divide by max_iter
        alpha = alpha / (1.0 + true_div(state.iteration.to(dtype), config.max_iter))
        if config.variant == "safeguarded":
            alpha = alpha / torch.clamp(max_grad_norm, min=1.0)
    elif config.step_type == "bigstep":
        offset, length = BIGSTEP_OFFSETS[config.bigstep_level]
        table = torch.tensor(BIGSTEP_TABLE, dtype=dtype, device=dev)
        alpha = table[offset + (state.iteration % length).long()]
        if config.lipschitz_scaling:
            alpha = alpha / max_grad_norm
    # fixed & page: alpha unchanged

    if config.variant == "reference" and config.step_type in ("fixed", "page"):
        # nlsolver.h:3014: alpha_ *= f_multiplier compounds every iteration
        alpha = torch.where(state.iteration % 2 == 0, alpha, -alpha)

    new_x = x - alpha[:, None] * state.gradient
    new_grad = lanes.map(grad_point, new_x)
    nfev = nfev + g_cost
    gfev = gfev + 1

    if config.step_type == "page":
        if config.variant == "reference":
            # size_t division: 128 // (11 + 128) == 0 (nlsolver.h:2944-2945)
            p = config.minibatch // (config.minibatch_prime + config.minibatch)
        else:
            p = config.minibatch / (config.minibatch_prime + config.minibatch)
        ratio = config.minibatch / config.minibatch_prime
        u = page_draws(state, draws, generator)
        corrected = (new_grad - state.gradient) * ratio + new_grad
        new_grad = torch.where((u > p)[:, None], corrected, new_grad)

    worked = GDState(
        x=new_x,
        gradient=new_grad,
        prev_gradient=state.gradient,
        iteration=state.iteration + 1,
        nfev=nfev,
        gfev=gfev,
        max_grad_norm=max_grad_norm,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    halted = state._replace(max_grad_norm=max_grad_norm, done=torch.ones_like(state.done),
                            converged=hit_tol)
    return where_lanes(done_now, halted, worked)


# steps between two reads of done.all(); a step without a line search is
# a handful of launches, so the host reads the flags every 16 of them
CHECK_EVERY = 16


def _run(lanes: Lanes, x0, config: GDConfig, _minimize: bool, draws=None,
         generator=None) -> SolverResult:
    if config.step_type == "page" and draws is None and generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    every = 1 if config.step_type == "linesearch" else CHECK_EVERY
    state = init(lanes, x0, config)
    state = drive(lambda s: step(lanes, s, config, draws=draws, generator=generator), state,
                  check_every=every)
    # the reference evaluates at exit (nlsolver.h:2976)
    return finalize(lanes, state, not _minimize, function_calls=state.nfev + 1,
                    gradient_calls=state.gfev)


def minimize_batched(fn, x0: torch.Tensor, config: GDConfig = GDConfig(),
                     bounds: Optional[Bounds] = None, *, draws=None,
                     generator: Optional[torch.Generator] = None, data=None,
                     _minimize: bool = True) -> SolverResult:
    """Every lane of ``x0 [B, n]``: ``jax.vmap`` of the JAX ``minimize``.
    PAGE's uniforms come from ``draws [T, B]`` or ``generator`` (on
    ``x0``'s device, seed 0 by default)."""
    no_bounds("gd", bounds)
    return run_batched(_run, fn, x0, config, data, _minimize, draws, generator)


def minimize(fn, x0: torch.Tensor, config: GDConfig = GDConfig(),
             bounds: Optional[Bounds] = None, *, draws=None,
             generator: Optional[torch.Generator] = None, data=None,
             _minimize: bool = True) -> SolverResult:
    """One point ``x0 [n]``: the lane engine at B = 1, squeezed; ``draws``
    is then ``[T]``."""
    no_bounds("gd", bounds)
    if draws is not None:
        draws = torch.as_tensor(draws)[:, None]
    return run_single(_run, fn, x0, config, data, _minimize, draws, generator)


def maximize(fn, x0, config: GDConfig = GDConfig(), bounds=None, *, draws=None, generator=None,
             data=None):
    return minimize(fn, x0, config, bounds, draws=draws, generator=generator, data=data,
                    _minimize=False)
