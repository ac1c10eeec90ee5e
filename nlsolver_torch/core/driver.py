"""Generic iterative-solver drivers (counterpart of
``nlsolver_tpu.core.driver``).

Every solver is a state machine: ``init`` builds a NamedTuple state of
tensors, ``step`` maps state to state, and a ``done`` field marks finished
lanes.  PyTorch runs eagerly, so ``lax.scan`` and ``lax.while_loop`` become
Python loops.  No driver reads a device value inside a step: ``drive``
looks at ``done`` on the host only once every ``check_every`` steps.

``attach_progress`` is the JAX package's progress hook without
``io_callback``: PyTorch runs the loop on the host, so the wrapped step
reads its report from the device after the step (one read of three
numbers a step) and calls the user's function there.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, TypeVar

import torch

from .utils import where_lanes

S = TypeVar("S")

# state fields probed (in order) for the progress report's "best" value
_PROGRESS_VALUE_FIELDS = ("best_value", "f_value", "scores")


def _progress_payload(state) -> torch.Tensor:
    """(iteration, best, active) of any solver state as one float64 tensor
    of three, to be read in one copy: the largest iteration over the lanes,
    the least of the first value-like field (rounded to float32, as the
    JAX package reports it) and the count of unfinished lanes."""
    done = state.done
    it = (state.iteration.max() if hasattr(state, "iteration")
          else torch.zeros((), device=done.device))
    best = torch.full((), float("nan"), device=done.device)
    for f in _PROGRESS_VALUE_FIELDS:
        if hasattr(state, f):
            best = getattr(state, f).amin().to(torch.float32)
            break
    active = (~done).sum()
    return torch.stack([it.to(torch.float64), best.to(torch.float64), active.to(torch.float64)])


def _wrap_progress(progress: Callable, every: int):
    """The JAX package's host-side filter: reports on every ``every``-th
    iteration and whenever no lane is active, once per iteration (a step
    that leaves the largest iteration where it was, as the frozen steps
    after the last lane stops do, reports nothing new).  A lower iteration
    than the last one reported starts a new run."""
    last = [-1]

    def host_fn(it: int, best: float, active: int):
        if it < last[0]:
            last[0] = -1            # a new run with the same hook
        if it == last[0]:
            return                  # the same iteration again
        if it % every and active:
            return
        last[0] = it
        progress(iteration=it, best=best, active=active)

    return host_fn


def attach_progress(body: Callable[[S], S], progress: Callable,
                    progress_every: int = 50) -> Callable[[S], S]:
    """Wrap a loop body so that, after each step, it reports
    ``progress(iteration=, best=, active=)`` on the host every
    ``progress_every`` iterations and when no lane is active (the JAX
    package's ``attach_progress``, nlsolver_tpu/core/driver.py:84-130).
    The report is read from the state the step returns, once a step: a
    kernel's step (K1's generation) has finished when it is read."""
    every = max(int(progress_every), 1)
    host_fn = _wrap_progress(progress, every)

    def wrapped(state: S) -> S:
        new_state = body(state)
        it, best, active = _progress_payload(new_state).tolist()
        host_fn(int(it), best, int(active))
        return new_state

    return wrapped


def drive(
    step_fn: Callable[[S], S],
    init_state: S,
    check_every: int = 16,
    max_steps: Optional[int] = None,
    progress: Optional[Callable] = None,
    progress_every: int = 50,
) -> S:
    """Run ``step_fn`` until every lane's ``done`` flag is set.

    Finished lanes are frozen (as in the JAX driver), so the up to
    ``check_every - 1`` steps run after the last lane finishes change
    nothing; they buy a host sync once per ``check_every`` steps instead of
    once per step.  ``max_steps`` caps the total number of steps.
    ``progress`` (optional) is called as ``progress(iteration=, best=,
    active=)`` every ``progress_every`` iterations and once when every
    lane has stopped (:func:`attach_progress`); it reads the device once a
    step, and without it the driver reads nothing more.
    """
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")

    def body(state: S) -> S:
        return where_lanes(state.done, state, step_fn(state))

    if progress is not None:
        body = attach_progress(body, progress, progress_every)
    state, steps = init_state, 0
    while max_steps is None or steps < max_steps:
        if bool(state.done.all()):
            break
        chunk = check_every if max_steps is None else min(check_every, max_steps - steps)
        for _ in range(chunk):
            state = body(state)
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
