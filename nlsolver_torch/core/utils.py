"""Small numeric helpers shared by all solvers (counterpart of
``nlsolver_tpu.core.utils``)."""
from __future__ import annotations

import math
from functools import lru_cache
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


def exact_product(x: torch.Tensor) -> torch.Tensor:
    """The identity.  The JAX package wraps a product in it so that XLA:CPU
    does not contract ``a + w*b`` into one FMA, which the reference binary
    (baseline x86-64, no FMA) never does.  Eager PyTorch runs ``*`` and
    ``+`` as separate kernels on the CPU and on the card, so each product
    is rounded on its own already; the replays call it where the JAX
    package does, and write such sums elementwise in the reference's order
    (no ``addcmul``, ``lerp``, ``addmm``, ``alpha=`` or small ``matmul``,
    each of which may fuse the two roundings into one)."""
    return x


def _c_library(name: str, x: torch.Tensor) -> torch.Tensor:
    f = getattr(math, name)
    vals = x.detach().to("cpu", torch.float64).reshape(-1)
    out = []
    for i, v in enumerate(vals.tolist()):
        try:
            out.append(f(v))
        except (ValueError, OverflowError):
            out.append(float(getattr(torch, name)(vals[i])))
    return torch.tensor(out, dtype=x.dtype, device=x.device).reshape(x.shape)


@lru_cache(maxsize=None)
def _c_math_op():
    """``_c_library`` as a custom op with a ``vmap`` rule (the op maps
    values one by one, so a batched input is one bigger input), so that
    an objective that calls ``c_math`` runs under ``torch.func.vmap`` as
    the solvers score it.  Registered at first use."""
    op = torch.library.custom_op("nlsolver_torch::c_math", _c_library, mutates_args=())
    op.register_fake(lambda name, x: torch.empty_like(x))
    torch.library.register_vmap(op, lambda info, in_dims, name, x: (op(name, x), in_dims[1]))
    return op


def c_math(name: str, x: torch.Tensor) -> torch.Tensor:
    """The C library's function ``name`` (``log``, ``exp``, ``cos``,
    ``sin``, ``sqrt``, ...: Python's ``math``) on every value of ``x``, the
    result in ``x``'s dtype on its device; it runs under
    ``torch.func.vmap`` too.

    The reference binary's transcendental functions are the C library's.
    PyTorch's kernels round other ways: on the CPU its float64 ``sqrt``,
    ``log``, ``cos``, ``sin`` and ``exp`` miss the C library's results by
    an ulp on 0.2-4 % of inputs (a torch 2.13 CPU build, AVX512), and the
    card's ``sin`` on 9.4 % of inputs near -2 (an H100, torch 2.11).  A
    replay that must land where the reference lands takes them from here:
    one read of ``x`` to the host and one copy back a call.  Where the C
    library raises (``log(0)``, an ``exp`` that overflows) the value is
    PyTorch's (-inf, inf or nan)."""
    return _c_math_op()(name, x)


def where_lanes(pred: torch.Tensor, on_true: T, on_false: T) -> T:
    """Lane-wise select over a NamedTuple state (``tree_where`` of the JAX
    package): each tensor field takes ``on_true`` where ``pred[lane]`` holds.

    ``pred`` is ``[B]`` (or 0-d, for one instance) and every tensor field
    leads with the lane axis; a field that does not raises ``ValueError``
    rather than broadcasting against the lanes (a batch-minor ``[n, B]``
    fleet selects with its own trailing-lane helper).  A field that is not
    a tensor (a fleet-global host counter) belongs to no lane and is taken
    from ``on_false``, the state being advanced.  A field that is itself a
    tuple of such fields (a replay's generator state) is selected field by
    field.
    """
    out = []
    for a, b in zip(on_true, on_false):
        if isinstance(b, tuple):
            out.append(where_lanes(pred, a, b))
        elif isinstance(b, torch.Tensor):
            if tuple(b.shape[:pred.ndim]) != tuple(pred.shape):
                raise ValueError(
                    f"where_lanes: a field of shape {tuple(b.shape)} does not lead "
                    f"with the lane axis of the predicate {tuple(pred.shape)}"
                )
            m = pred.reshape(pred.shape + (1,) * (b.ndim - pred.ndim))
            out.append(torch.where(m, a, b))
        else:
            out.append(b)
    return type(on_false)(*out) if hasattr(on_false, "_fields") else type(on_false)(out)


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
