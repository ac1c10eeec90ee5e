"""Device meshes over ``torch.distributed`` (counterpart of
``nlsolver_tpu.parallel.mesh``).

The JAX package shards with ``shard_map`` over a (dp, pop) mesh of devices
seen by one controller.  The port runs one process per device (SPMD, the
PyTorch idiom): every rank calls an engine with the same global inputs,
computes its block, and returns the global result in the caller's order
through one gather at the end.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the dimensions
``("dp", "pop")`` over every rank of the world: problem instances shard
over ``dp``, a population's agents over ``pop``.  The backend is NCCL on
CUDA and gloo on the CPU.

A world of one rank needs no launcher: ``make_mesh`` then builds the
one-rank process group itself, on an in-process store.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

DP_AXIS = "dp"     # problem-instance (batch) axis
POP_AXIS = "pop"   # population / agent axis within one problem


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_for(device_type: str) -> str:
    """NCCL for CUDA tensors, beside gloo for CPU ones in the same group (so
    a CUDA world can also hold a CPU mesh); gloo alone on the CPU."""
    return "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"


def ensure_process_group(device_type: str) -> None:
    """The default process group, made here as a world of one rank (on an
    in-process store) when none exists and no launcher set one up."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) > 1:
        raise RuntimeError(
            "WORLD_SIZE is set but no process group exists: call "
            "nlsolver_torch.parallel.distributed.initialize() on every rank first"
        )
    dist.init_process_group(backend_for(device_type), store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    pop: Optional[int] = None,
    device_type: Optional[str] = None,
):
    """A (dp, pop) mesh over the world's ranks, rank r at (r // pop, r % pop).

    Default split: as square as possible, favouring the dp axis, as the JAX
    package's.  ``n_devices`` must be the world size (one process a
    device); ``dp * pop`` must equal it."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = device_type or default_device_type()
    ensure_process_group(device_type)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"n_devices = {n}, but the world has {world} ranks (one a device)")
    if dp is None and pop is None:
        pop = _largest_factor_leq(n, int(math.isqrt(n)))
        dp = n // pop
    elif dp is None:
        dp = n // pop
    elif pop is None:
        pop = n // dp
    if dp * pop != n:
        raise ValueError(f"dp*pop = {dp}*{pop} != {n} devices")
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                              % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, pop),
                      mesh_dim_names=(DP_AXIS, POP_AXIS))


def _largest_factor_leq(n: int, k: int) -> int:
    for f in range(k, 0, -1):
        if n % f == 0:
            return f
    return 1


def population_sharding(mesh):
    """``[B, P, n]`` tensors: instances over dp, agents over pop, as the
    placements of ``torch.distributed.tensor`` (one a mesh dimension).
    An export under the JAX package's name only: the engines cut their
    blocks with :func:`block` and :func:`lane_block`."""
    from torch.distributed.tensor import Shard

    return (Shard(0), Shard(1))


def instance_sharding(mesh):
    """``[B, ...]`` tensors sharded over instances (dp) only, replicated over
    pop.  An export under the JAX package's name only, as
    :func:`population_sharding`."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def coordinate(mesh) -> tuple[int, int]:
    """This rank's (dp, pop) place on the mesh."""
    dp_i, pop_i = mesh.get_coordinate()
    return int(dp_i), int(pop_i)


def block(size: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``size`` items cut into ``parts`` equal blocks."""
    per = size // parts
    return slice(index * per, (index + 1) * per)


def lane_block(mesh, size: int) -> slice:
    """This rank's block of ``size`` lanes sharded over every device of the
    mesh (dp major, pop minor: the JAX package's ``P((DP_AXIS, POP_AXIS))``)."""
    dp_i, pop_i = coordinate(mesh)
    return block(size, mesh.size(), dp_i * mesh.size(1) + pop_i)


def check_device(x: torch.Tensor, mesh) -> None:
    """A mesh's collectives run on its device type: NCCL on CUDA tensors,
    gloo on CPU tensors."""
    if x.device.type != mesh.device_type:
        raise ValueError(f"the mesh is on {mesh.device_type} but the inputs are on {x.device}")


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along ``dim`` in rank order
    (one ``all_gather_into_tensor``)."""
    size = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def all_sum(t: torch.Tensor, group=None) -> int:
    """The sum of the 0-d integer tensor ``t`` over the group, on the host."""
    t = t.to(torch.int64).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return int(t.item())


def gather_result(res, group=None, x_lane_dim: int = 1):
    """The global ``SolverResult`` from every rank's block of lanes, in rank
    order, by ONE gather: every per-lane field packed into a float64
    ``[B_local, n + 6]`` tensor (exact for float32 and float64 values,
    int32 counters and flags), gathered along the lanes, unpacked to each
    field's dtype.  ``x`` has its lanes on axis ``x_lane_dim`` (1 for the
    batch-minor fleets' ``[n, B]``, 0 for ``[B, n]``); a field with no lane
    axis is the same on every rank and stays as it is."""
    x = res.x if x_lane_dim == 1 else res.x.T
    n = x.shape[0]
    per_lane = [(i, f) for i, f in enumerate(res) if i > 0 and f.ndim > 0]
    packed = torch.cat([x.to(torch.float64)]
                       + [f.reshape(1, -1).to(torch.float64) for _, f in per_lane]).T
    g = all_gather(packed, group, dim=0)
    fields = list(res)
    gx = g[:, :n].to(res.x.dtype)
    fields[0] = (gx.T if x_lane_dim == 1 else gx).contiguous()
    for row, (i, f) in enumerate(per_lane, start=n):
        fields[i] = g[:, row].to(f.dtype).contiguous()
    return type(res)(*fields)
