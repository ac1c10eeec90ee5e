"""Small numeric helpers shared by all solvers (counterpart of
``nlsolver_tpu.core.utils``)."""
from __future__ import annotations

from typing import TypeVar

import torch

T = TypeVar("T")


def max_abs(x: torch.Tensor) -> torch.Tensor:
    """Infinity norm (reference: max_abs_vec, nlsolver.h:1894-1904)."""
    return x.abs().max()


def std_err(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sample standard deviation of scores along ``dim`` (reference:
    std_err, nlsolver.h:2037-2052, which divides by n-1).  Written out
    rather than ``torch.std`` so the sums follow the JAX package's order."""
    n = scores.shape[dim]
    mean = scores.mean(dim=dim, keepdim=True)
    var = ((scores - mean) ** 2).sum(dim=dim) / max(n - 1, 1)
    return var.sqrt()


def where_lanes(pred: torch.Tensor, on_true: T, on_false: T) -> T:
    """Lane-wise select over a NamedTuple state (``tree_where`` of the JAX
    package): each tensor field takes ``on_true`` where ``pred[lane]`` holds.

    ``pred`` is ``[B]`` (or 0-d, for one instance) and every tensor field
    leads with the lane axis; a field that does not raises ``ValueError``
    rather than broadcasting against the lanes (a batch-minor ``[n, B]``
    fleet selects with its own trailing-lane helper).  A field that is not
    a tensor (a fleet-global host counter) belongs to no lane and is taken
    from ``on_false``, the state being advanced.
    """
    out = []
    for a, b in zip(on_true, on_false):
        if isinstance(b, torch.Tensor):
            if tuple(b.shape[:pred.ndim]) != tuple(pred.shape):
                raise ValueError(
                    f"where_lanes: a field of shape {tuple(b.shape)} does not lead "
                    f"with the lane axis of the predicate {tuple(pred.shape)}"
                )
            m = pred.reshape(pred.shape + (1,) * (b.ndim - pred.ndim))
            out.append(torch.where(m, a, b))
        else:
            out.append(b)
    return type(on_false)(*out)


def lane_where(pred: torch.Tensor, on_true: T, on_false: T) -> T:
    """Lane-wise select over a NamedTuple state whose tensor fields END
    with the lane axis (the batch-minor fleets: x ``[n, B]``, matrices
    ``[n, n, B]``, per-lane scalars ``[B]``); ``pred`` is ``[B]``.  A field
    with no lane axis (a host counter, a 0-d tensor) belongs to the fleet
    and is taken from ``on_false``, the state being advanced."""
    def pick(a, b):
        if not isinstance(b, torch.Tensor) or b.ndim == 0:
            return b
        return torch.where(pred.reshape((1,) * (b.ndim - 1) + (-1,)), a, b)

    return type(on_false)(*(pick(a, b) for a, b in zip(on_true, on_false)))


def clamp(x: torch.Tensor, lower, upper) -> torch.Tensor:
    """Clamp to box bounds (reference: simplex_transform's std::clamp,
    nlsolver.h:2002-2004)."""
    lower = torch.as_tensor(lower, dtype=x.dtype, device=x.device)
    upper = torch.as_tensor(upper, dtype=x.dtype, device=x.device)
    return torch.clamp(x, lower, upper)


def start_points(x0, name: str = "x0") -> torch.Tensor:
    """Start points (or per-lane data) as a tensor: a ``torch.Tensor`` keeps
    its device; anything else (a numpy array, a list) goes to the CUDA
    card, and raises ``RuntimeError`` when there is none."""
    if isinstance(x0, torch.Tensor):
        return x0
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{name} is not a torch.Tensor and there is no CUDA card to put it on; "
            f"nlsolver_torch runs on the card unless {name} is a CPU torch.Tensor"
        )
    return torch.as_tensor(x0, device="cuda")
