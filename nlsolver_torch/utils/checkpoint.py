"""Checkpoint and resume of solver states (counterpart of
``nlsolver_tpu.utils.checkpoint``).

The reference has no checkpointing: its in-place ``x`` and its generators'
get_state / set_state are all it keeps (SURVEY.md section 5).  A state of
the port is a NamedTuple, tuple, list or dict of tensors and Python
scalars (host counters such as a fleet's ``generation``), so ``save`` and
``load`` round-trip any of them through an ``.npz`` file, each tensor's
bits unchanged, and resuming is calling the solver's ``step`` on the
loaded state.

The port's states carry no PRNG key: the draws come from a
``torch.Generator``.  ``save`` and ``load`` take it too (its
``get_state()`` goes into the file beside the leaves), so a resumed run
draws the same stream as the run that was saved.

``save_orbax`` / ``load_orbax`` (the JAX package's names, there on orbax)
write and read the same states, generator and all, through
``torch.distributed.checkpoint``: a directory that every rank of a world
writes and reads together.  Each rank keeps its own state under keys of its
own (``rank{r}/...``), so the blocks of a sharded run, which differ by
rank, are each kept whole and never taken for copies of one another.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Optional

import numpy as np
import torch

_GENERATOR = "generator_state"


def _leaves(state: Any) -> list:
    """The leaves of ``state`` in a fixed order: tensors, Python scalars
    and None, inside NamedTuples, tuples, lists and dicts."""
    if isinstance(state, dict):
        return [leaf for k in sorted(state) for leaf in _leaves(state[k])]
    if isinstance(state, (tuple, list)):
        return [leaf for item in state for leaf in _leaves(item)]
    return [state]


def _rebuild(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(item, leaves) for item in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(item, leaves) for item in like)
    return next(leaves)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:     # numpy has no bfloat16: keep the bits
        t = t.view(torch.int16)
    return t.numpy()


def save(path: str, state: Any, generator: Optional[torch.Generator] = None) -> None:
    """Write ``state`` (and ``generator``'s state, when given) to ``path``
    (.npz)."""
    arrays = {}
    for i, leaf in enumerate(_leaves(state)):
        if isinstance(leaf, torch.Tensor):
            arrays[f"leaf_{i}"] = _to_numpy(leaf)
        elif leaf is not None:
            arrays[f"leaf_{i}"] = np.asarray(leaf)
    if generator is not None:
        arrays[_GENERATOR] = generator.get_state().numpy()
    np.savez(path, **arrays)


def load(path: str, like: Any, generator: Optional[torch.Generator] = None) -> Any:
    """Read a state saved by :func:`save`.  ``like`` gives the structure
    (a freshly made state, say): each tensor comes back on ``like``'s
    device with its dtype, each scalar as its Python type.  With
    ``generator`` its state is set to the one saved."""
    with np.load(path) as data:
        out = []
        for i, leaf in enumerate(_leaves(like)):
            if leaf is None:
                out.append(None)
                continue
            value = data[f"leaf_{i}"]
            if isinstance(leaf, torch.Tensor):
                t = torch.from_numpy(np.array(value))
                if leaf.dtype == torch.bfloat16:
                    t = t.view(torch.bfloat16)
                out.append(t.to(device=leaf.device, dtype=leaf.dtype))
            else:
                out.append(type(leaf)(value.item()))
        if generator is not None:
            if _GENERATOR not in data:
                raise ValueError(f"{path} holds no generator state")
            generator.set_state(torch.from_numpy(np.array(data[_GENERATOR])))
    return _rebuild(like, iter(out))


def _in_world() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank_prefix() -> str:
    import torch.distributed as dist

    return f"rank{dist.get_rank() if _in_world() else 0}"


def _as_tensor(leaf) -> torch.Tensor:
    """A tensor leaf, or a Python scalar as a 0-d tensor (bool, int64 or
    float64: exact)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.tensor(leaf, dtype=torch.float64 if isinstance(leaf, float) else None)


def _dcp(call, tensors, path):
    """``torch.distributed.checkpoint``'s ``save`` or ``load``: in this
    process alone where no process group exists (its warning that it
    assumes so silenced), else over the default group."""
    import torch.distributed.checkpoint as dcp

    alone = not _in_world()
    with warnings.catch_warnings():
        if alone:
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        getattr(dcp, call)(tensors, checkpoint_id=path, no_dist=alone)


def save_orbax(path: str, state: Any, generator: Optional[torch.Generator] = None) -> None:
    """Write ``state`` (and ``generator``'s state, when given) to the
    directory ``path`` with ``torch.distributed.checkpoint``; in a world of
    several ranks every rank calls it with its own state."""
    key = _rank_prefix()
    tensors = {f"{key}/leaf_{i}": _as_tensor(leaf)
               for i, leaf in enumerate(_leaves(state)) if leaf is not None}
    if generator is not None:
        tensors[f"{key}/{_GENERATOR}"] = generator.get_state()
    _dcp("save", tensors, os.path.abspath(path))


def load_orbax(path: str, like: Any, generator: Optional[torch.Generator] = None) -> Any:
    """Read the state this rank saved with :func:`save_orbax`; ``like`` gives
    the structure, devices and dtypes, as for :func:`load`."""
    import torch.distributed.checkpoint as dcp

    path, key = os.path.abspath(path), _rank_prefix()
    leaves = _leaves(like)
    tensors = {f"{key}/leaf_{i}": torch.empty_like(_as_tensor(leaf))
               for i, leaf in enumerate(leaves) if leaf is not None}
    if generator is not None:
        if f"{key}/{_GENERATOR}" not in dcp.FileSystemReader(path).read_metadata() \
                .state_dict_metadata:
            raise ValueError(f"{path} holds no generator state")
        tensors[f"{key}/{_GENERATOR}"] = torch.empty_like(generator.get_state())
    _dcp("load", tensors, path)
    if generator is not None:
        generator.set_state(tensors[f"{key}/{_GENERATOR}"])
    out = [None if leaf is None
           else tensors[f"{key}/leaf_{i}"] if isinstance(leaf, torch.Tensor)
           else type(leaf)(tensors[f"{key}/leaf_{i}"].item())
           for i, leaf in enumerate(leaves)]
    return _rebuild(like, iter(out))
