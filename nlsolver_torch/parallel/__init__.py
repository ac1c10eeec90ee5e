"""Mesh engines over ``torch.distributed`` (counterpart of
``nlsolver_tpu.parallel``): one process a device, every rank calling an
engine with the same global inputs and getting the global result.  Not
ported yet (ROADMAP.md Queue 1 item 9b): the population-sharded PSO, the
island DE and the dimension-sharded L-BFGS."""
from . import distributed
from .cmaes_sharded import minimize_fleet_sharded
from .de_sharded import minimize_sharded
from .fleet_sharded import (
    fit_fleet_sharded,
    minimize_fleet_sharded as bfgs_minimize_fleet_sharded,
    minimize_pso_fleet_sharded,
    minimize_sann_fleet_sharded,
)
from .mesh import DP_AXIS, POP_AXIS, instance_sharding, make_mesh, population_sharding
from .nlls_sharded import fit_sharded

__all__ = [
    "DP_AXIS",
    "POP_AXIS",
    "bfgs_minimize_fleet_sharded",
    "distributed",
    "fit_fleet_sharded",
    "fit_sharded",
    "instance_sharding",
    "make_mesh",
    "minimize_fleet_sharded",
    "minimize_pso_fleet_sharded",
    "minimize_sann_fleet_sharded",
    "minimize_sharded",
    "population_sharding",
]
