"""Generic iterative-solver drivers (counterpart of
``nlsolver_tpu.core.driver``).

Every solver is a state machine: ``init`` builds a NamedTuple state of
tensors, ``step`` maps state to state, and a ``done`` field marks finished
lanes.  PyTorch runs eagerly, so ``lax.scan`` and ``lax.while_loop`` become
Python loops.  No driver reads a device value inside a step: ``drive``
looks at ``done`` on the host only once every ``check_every`` steps.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, TypeVar

import torch

from .utils import where_lanes

S = TypeVar("S")


def drive(
    step_fn: Callable[[S], S],
    init_state: S,
    check_every: int = 16,
    max_steps: Optional[int] = None,
) -> S:
    """Run ``step_fn`` until every lane's ``done`` flag is set.

    Finished lanes are frozen (as in the JAX driver), so the up to
    ``check_every - 1`` steps run after the last lane finishes change
    nothing; they buy a host sync once per ``check_every`` steps instead of
    once per step.  ``max_steps`` caps the total number of steps.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    state, steps = init_state, 0
    while max_steps is None or steps < max_steps:
        if bool(state.done.all()):
            break
        chunk = check_every if max_steps is None else min(check_every, max_steps - steps)
        for _ in range(chunk):
            state = where_lanes(state.done, state, step_fn(state))
        steps += chunk
    return state


def drive_fleet_scan(step_fn: Callable[[S], S], state: S, trips: int) -> S:
    """Fixed-trip driver for fleet engines whose ``step`` freezes finished
    lanes itself: no ``where_lanes`` pass around it."""
    for _ in range(trips):
        state = step_fn(state)
    return state


def drive_scan(step_fn: Callable[[S], S], init_state: S, num_steps: int) -> S:
    """Fixed-trip driver: ``num_steps`` steps, finished lanes frozen exactly
    as in :func:`drive`.  Deterministic work per run, for benchmarking."""
    state = init_state
    for _ in range(num_steps):
        state = where_lanes(state.done, state, step_fn(state))
    return state


def _stack(states):
    """The states of a trace as one state: each tensor field stacked on a
    new leading axis, a tuple field (a generator state) field by field."""
    first = states[0]
    if not isinstance(first, tuple):
        return torch.stack(states)
    fields = [_stack([s[i] for s in states]) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def drive_trace(step_fn: Callable[[S], S], init_state: S, num_steps: int) -> Tuple[S, S]:
    """Fixed-trip driver that also returns every state on the way.

    Returns ``(final_state, trace)``: each tensor of ``trace`` has a leading
    ``[num_steps]`` axis, and ``trace[i]`` is the state after ``i + 1``
    steps, finished lanes frozen exactly as in :func:`drive_scan`.  The
    observability hook behind :mod:`nlsolver_torch.trace` (the reference's
    per-iteration state lives in solver-local vectors and is destroyed on
    return, nlsolver.h:2166-2299).
    """
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    state, states = init_state, []
    for _ in range(num_steps):
        state = where_lanes(state.done, state, step_fn(state))
        states.append(state)
    return state, _stack(states)
