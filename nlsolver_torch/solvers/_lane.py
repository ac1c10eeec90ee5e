"""What the single-instance solvers on lane tensors share: their entry
points for one point (``minimize``, the case B = 1, squeezed) and for a
batch (``minimize_batched``, ``jax.vmap`` of the JAX ``minimize``), the
result, and the refusal of ``bounds`` by the unconstrained solvers."""
from __future__ import annotations

from typing import Any, NamedTuple

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


def lane_result(x, f_val, state, flip_sign: bool) -> SolverResult:
    """The result of every lane of a derivative-free solver: ``x [B, n]``,
    ``f_val [B]``, the state's iterations, calls and flag, no gradient or
    Hessian calls."""
    zeros = torch.zeros_like(state.iteration)
    return make_result(x=x, f_value=-f_val if flip_sign else f_val, iterations=state.iteration,
                       function_calls=state.nfev, gradient_calls=zeros, hessian_calls=zeros,
                       converged=state.converged)


def scalar(value, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """A 0-d tensor of ``value`` on ``like``'s device: one instance's
    counter or flag."""
    return torch.tensor(value, dtype=dtype, device=like.device)


def gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx [B, K]`` of each lane of ``a [B, P, ...]``: ``[B, K, ...]``."""
    return torch.gather(a, 1, idx.reshape(idx.shape + (1,) * (a.ndim - 2)).expand(
        idx.shape + a.shape[2:]))


def gather_lanes(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[b]`` of each lane: ``a [B, K, ...]``, ``idx [B]`` ->
    ``[B, ...]`` (``a[idx]`` of one lane under ``jax.vmap``)."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


class Draws(NamedTuple):
    """A run's draws, injected to replay a trajectory: ``init`` what the
    solver's ``init`` takes (lane axis leading), ``steps`` its ``step``
    draws with a leading axis T, lane b reading row ``iteration[b]`` (in
    the JAX package, lane b's key chain: its key splits only on the steps
    the lane takes)."""

    init: Any
    steps: Any


def _tree(x, fn):
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_tree(a, fn) for a in x)) if hasattr(x, "_fields") else \
            tuple(_tree(a, fn) for a in x)
    return fn(x)


def step_rows(steps, iteration: torch.Tensor):
    """This step's draws of every lane: row ``iteration[b]`` of each
    ``[T, B, ...]`` tensor of ``steps`` for lane b."""
    lane = torch.arange(iteration.shape[0], device=iteration.device)

    def pick(a):
        return a[iteration.long().clamp(max=a.shape[0] - 1), lane]

    return _tree(steps, pick)


def reversed_axes(tree):
    """Every tensor of ``tree`` with its axes in reverse order, a view: a
    lane-leading ``[B, P, n]`` as the batch-minor fleets' ``[n, P, B]``, and
    back."""
    return _tree(tree, lambda a: a.permute(*range(a.ndim - 1, -1, -1)))


def draws_on(draws, device):
    """``draws`` with every tensor on ``device``."""
    return _tree(draws, lambda a: torch.as_tensor(a).to(device))


def one_lane(draws):
    """The draws of one start point (no lane axis) as a batch of one
    lane: ``init`` tensors gain a leading axis, ``steps`` tensors one after
    T."""
    if draws is None:
        return None
    return Draws(_tree(draws.init, lambda a: torch.as_tensor(a)[None]),
                 _tree(draws.steps, lambda a: torch.as_tensor(a)[:, None]))


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
