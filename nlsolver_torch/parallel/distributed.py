"""Multi-process launch helpers (counterpart of
``nlsolver_tpu.parallel.distributed``).

The port runs one process per device.  A launcher (``torchrun``, or any
that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)
starts the same script on every rank:

    from nlsolver_torch.parallel import distributed
    distributed.initialize()                 # no-op without a launcher
    mesh = distributed.global_mesh(pop=4)
    res = nlsolver_torch.minimize(fn, x0, method="de", layout="sharded", mesh=mesh)

Every rank passes the same global inputs and gets the global result.
``process_slice(B)`` gives a rank's instance range where it builds only
its own part of the inputs.  Without a launcher, ``make_mesh`` builds a
world of one rank.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch.distributed as dist

from .mesh import backend_for, make_mesh, resolve_device_type


def initialize(device_type: Optional[str] = None, **kwargs) -> None:
    """Start the default process group (``init_process_group``).

    With keyword arguments (``init_method``, ``world_size``, ``rank``,
    ``backend``, ``store``, ``timeout``) they go to ``init_process_group``
    and its errors propagate.  Without them the launcher's environment is
    used where it is set (``env://``); a process with neither stays local,
    and so does one whose group exists already.  The backend is the one of
    ``device_type`` (``"cuda"`` unless given: NCCL beside gloo), unless
    ``backend=`` names one; starting a CUDA group on a machine with no card
    raises ``RuntimeError``."""
    if kwargs:
        if "backend" not in kwargs:
            kwargs["backend"] = backend_for(resolve_device_type(device_type))
        dist.init_process_group(**kwargs)
        return
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dist.init_process_group(backend_for(resolve_device_type(device_type)), init_method="env://")


def global_mesh(dp: Optional[int] = None, pop: Optional[int] = None,
                device_type: Optional[str] = None):
    """(dp, pop) mesh over every rank of the world.

    ``pop`` defaults to the ranks a host shares with the world
    (``LOCAL_WORLD_SIZE``, set by ``torchrun``), so the population
    collectives of ``de_sharded`` stay within a host and the dp axis,
    which carries only the termination sum, spans hosts.  A CUDA mesh
    unless ``device_type`` says otherwise."""
    device_type = resolve_device_type(device_type)
    if not dist.is_initialized():
        initialize(device_type)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if pop is None and dp is None:
        pop = math.gcd(int(os.environ.get("LOCAL_WORLD_SIZE", 1)), n)
    return make_mesh(n, dp=dp, pop=pop, device_type=device_type)


def process_slice(batch: int) -> Tuple[int, int]:
    """[start, stop) of the instances this rank owns."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = batch // p
    if batch % p:
        raise ValueError(f"batch {batch} must divide across {p} processes")
    return i * per, (i + 1) * per
