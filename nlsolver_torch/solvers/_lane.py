"""What the single-instance solvers on lane tensors share: their entry
points for one point (``minimize``, the case B = 1, squeezed) and for a
batch (``minimize_batched``, ``jax.vmap`` of the JAX ``minimize``), the
result, and the refusal of ``bounds`` by the unconstrained solvers."""
from __future__ import annotations

import torch

from ..core import SolverResult, make_result, start_points
from ..core.lanes import Lanes


def no_bounds(method: str, bounds) -> None:
    """The JAX package's ``bfgs``, ``gd``, ``cgd``, ``lm`` and
    ``coordinate`` take ``bounds`` and ignore them without a word; the port
    refuses them."""
    if bounds is not None:
        raise ValueError(
            f"method={method!r} is unconstrained and takes no bounds= (the JAX package's "
            f"solver ignores them without a word); use method='lbfgsb' or 'lbfgs' for a box"
        )


def lane_full(x0: torch.Tensor, value, dtype=None) -> torch.Tensor:
    """A ``[B]`` lane vector of ``value`` beside ``x0 [B, n]``, in ``dtype``
    (``x0``'s by default)."""
    return torch.full((x0.shape[0],), value, dtype=dtype or x0.dtype, device=x0.device)


def true_div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` as a true divide on ``a``'s device: a Python number there
    would let the card multiply by its reciprocal."""
    return a / torch.tensor(c, dtype=a.dtype, device=a.device)


def grad_cost(n: int, deriv) -> int:
    """Objective evaluations one gradient of ``deriv`` costs
    (``deriv.make_grad``'s second value)."""
    from ..deriv.fd import fd_gradient_cost

    return fd_gradient_cost(n, deriv.accuracy) if deriv.mode == "fd" else 0


def finalize(lanes: Lanes, state, flip_sign: bool, *, function_calls, gradient_calls=0,
             hessian_calls=0, f_value=None) -> SolverResult:
    """The result of every lane; ``f_value`` defaults to the objective at
    the final points (one more evaluation, counted by the caller)."""
    f_val = lanes.values(state.x) if f_value is None else f_value

    def per_lane(v):
        return v if torch.is_tensor(v) else torch.full_like(state.iteration, v)

    return make_result(
        x=state.x,
        f_value=-f_val if flip_sign else f_val,
        iterations=state.iteration,
        function_calls=function_calls,
        gradient_calls=per_lane(gradient_calls),
        hessian_calls=per_lane(hessian_calls),
        converged=state.converged,
    )


def _each(data, fn):
    if data is None:
        return None
    if isinstance(data, (tuple, list)):
        return type(data)(fn(d) for d in data)
    return fn(data)


def run_batched(run, fn, x0, config, data, _minimize: bool, *extra) -> SolverResult:
    """``run(lanes, x0 [B, n], config, _minimize, *extra)`` on every lane
    of ``x0``; a start point that is no tensor goes to the card."""
    x0 = start_points(x0)
    if x0.ndim != 2:
        raise ValueError(f"a batch of start points is [B, n], got {tuple(x0.shape)}")
    return run(Lanes(fn, data, _minimize), x0, config, _minimize, *extra)


def run_single(run, fn, x0, config, data, _minimize: bool, *extra) -> SolverResult:
    """``run`` on the one point ``x0 [n]`` as a batch of one lane, every
    field of the result squeezed back to the single-instance shapes."""
    x0 = start_points(x0)
    if x0.ndim != 1:
        raise ValueError(f"a single start point is [n], got {tuple(x0.shape)}")
    lanes = Lanes(fn, _each(data, lambda d: torch.as_tensor(d)[None]), _minimize)
    res = run(lanes, x0[None], config, _minimize, *extra)
    return SolverResult(*(f[0] for f in res))
