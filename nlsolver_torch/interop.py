"""Carry a batched-DE state across packages as numpy arrays.

``de_state_from_numpy`` takes the fields of the JAX package's
``DEBatchState`` (for example ``{k: np.asarray(v) for k, v in
state._asdict().items()}``) and builds the port's state; the per-lane
``keys`` have no counterpart and are dropped.  ``de_state_to_numpy`` gives
the tensor fields back.  Neither imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .solvers.de_batched import DEBatchState

_TENSOR_FIELDS = (
    "agents", "scores", "best_value", "iteration", "nfev", "val_no_change",
    "done", "converged",
)


def de_state_from_numpy(
    fields: dict, device, *, generation: int = 0, seed: int = 0
) -> DEBatchState:
    missing = [f for f in _TENSOR_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"DE state is missing fields {missing}")
    tensors = {
        f: torch.as_tensor(np.array(fields[f]), device=device) for f in _TENSOR_FIELDS
    }
    return DEBatchState(**tensors, generation=generation, seed=seed)


def de_state_to_numpy(state: DEBatchState) -> dict:
    return {f: getattr(state, f).detach().cpu().numpy() for f in _TENSOR_FIELDS}
