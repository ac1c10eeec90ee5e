"""Carry solver states across packages as numpy arrays.

``de_state_from_numpy`` takes the fields of the JAX package's
``DEBatchState`` (for example ``{k: np.asarray(v) for k, v in
state._asdict().items()}``) and builds the port's state; the per-lane
``keys`` have no counterpart and are dropped.  ``de_state_to_numpy`` gives
the tensor fields back.  ``nlls_fleet_state_from_numpy`` and
``nlls_fleet_state_to_numpy`` do the same for the NLLS fleet's
``NLLSFleetState``, and ``bfgs_fleet_state_from_numpy`` and
``bfgs_fleet_state_to_numpy`` for the BFGS fleet's ``BFGSFleetState``,
field for field.  ``cmaes_fleet_state_from_numpy`` and
``cmaes_fleet_state_to_numpy`` carry the CMA-ES fleet's ``CMAESFleetState``:
the JAX state's ``key`` has no counterpart and is dropped (the port's
``step`` takes its draws or a generator), and its counters ``gen`` and
``filled`` become host ints.  ``pso_batch_state_from_numpy`` /
``pso_batch_state_to_numpy`` and ``sann_batch_state_from_numpy`` /
``sann_batch_state_to_numpy`` carry the PSO and SANN lane fleets'
``PSOBatchState`` and ``SANNBatchState`` field for field; like
``de_state_from_numpy`` they drop the per-lane ``keys``.  The states of
the single-instance solvers on lane tensors carry the fields of the JAX
state under ``jax.vmap`` (a leading lane axis): ``bfgs_state_*``,
``lbfgs_state_*``, ``lbfgsb_state_*``, ``gd_state_*`` (the JAX state's
per-lane ``key`` has no counterpart and is dropped: ``gd.step`` takes its
draws or a generator), ``cgd_state_*``, ``lm_state_*`` and ``cd_state_*``
(coordinate descent).  So do those of the derivative-free ones:
``nm_state_*`` (Nelder-Mead's ``NMState``), ``de_row_state_*`` (the
row-layout DE's ``DEState``), ``pso_state_*``, ``sann_state_*`` and
``nmpso_state_*``; the JAX states' per-lane ``key`` has no counterpart and
is dropped (their ``step`` takes its draws or a generator).  None of them
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .solvers.bfgs import BFGSState
from .solvers.bfgs_fleet import BFGSFleetState
from .solvers.cgd import CGDState
from .solvers.coordinate import CDState
from .solvers.gd import GDState
from .solvers.lbfgs import LBFGSState
from .solvers.lbfgsb import LBFGSBState
from .solvers.lm import LMState
from .solvers.cmaes_fleet import CMAESFleetState
from .solvers.de import DEState
from .solvers.nelder_mead import NMState
from .solvers.nmpso import NMPSOState
from .solvers.pso import PSOState
from .solvers.sann import SANNState
from .solvers.de_batched import DEBatchState
from .solvers.nlls_fleet import NLLSFleetState
from .solvers.pso_batched import PSOBatchState
from .solvers.sann_batched import SANNBatchState

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


def _state_from_numpy(cls, what: str, fields: dict, device):
    missing = [f for f in cls._fields if f not in fields]
    if missing:
        raise ValueError(f"{what} state is missing fields {missing}")
    return cls(*(torch.as_tensor(np.array(fields[f]), device=device) for f in cls._fields))


def _state_to_numpy(state) -> dict:
    return {f: getattr(state, f).detach().cpu().numpy() for f in state._fields}


def nlls_fleet_state_from_numpy(fields: dict, device) -> NLLSFleetState:
    return _state_from_numpy(NLLSFleetState, "NLLS fleet", fields, device)


def nlls_fleet_state_to_numpy(state: NLLSFleetState) -> dict:
    return _state_to_numpy(state)


def bfgs_fleet_state_from_numpy(fields: dict, device) -> BFGSFleetState:
    return _state_from_numpy(BFGSFleetState, "BFGS fleet", fields, device)


def bfgs_fleet_state_to_numpy(state: BFGSFleetState) -> dict:
    return _state_to_numpy(state)


_CMAES_HOST_INTS = ("gen", "filled")


def cmaes_fleet_state_from_numpy(fields: dict, device) -> CMAESFleetState:
    missing = [f for f in CMAESFleetState._fields if f not in fields]
    if missing:
        raise ValueError(f"CMA-ES fleet state is missing fields {missing}")
    return CMAESFleetState(**{
        f: int(fields[f]) if f in _CMAES_HOST_INTS
        else torch.as_tensor(np.array(fields[f]), device=device)
        for f in CMAESFleetState._fields
    })


def cmaes_fleet_state_to_numpy(state: CMAESFleetState) -> dict:
    return {
        f: np.int32(v) if f in _CMAES_HOST_INTS else v.detach().cpu().numpy()
        for f, v in state._asdict().items()
    }


def pso_batch_state_from_numpy(fields: dict, device) -> PSOBatchState:
    return _state_from_numpy(PSOBatchState, "PSO fleet", fields, device)


def pso_batch_state_to_numpy(state: PSOBatchState) -> dict:
    return _state_to_numpy(state)


def sann_batch_state_from_numpy(fields: dict, device) -> SANNBatchState:
    return _state_from_numpy(SANNBatchState, "SANN fleet", fields, device)


def sann_batch_state_to_numpy(state: SANNBatchState) -> dict:
    return _state_to_numpy(state)


def bfgs_state_from_numpy(fields: dict, device) -> BFGSState:
    return _state_from_numpy(BFGSState, "BFGS", fields, device)


def bfgs_state_to_numpy(state: BFGSState) -> dict:
    return _state_to_numpy(state)


def lbfgs_state_from_numpy(fields: dict, device) -> LBFGSState:
    return _state_from_numpy(LBFGSState, "L-BFGS", fields, device)


def lbfgs_state_to_numpy(state: LBFGSState) -> dict:
    return _state_to_numpy(state)


def lbfgsb_state_from_numpy(fields: dict, device) -> LBFGSBState:
    return _state_from_numpy(LBFGSBState, "L-BFGS-B", fields, device)


def lbfgsb_state_to_numpy(state: LBFGSBState) -> dict:
    return _state_to_numpy(state)


def gd_state_from_numpy(fields: dict, device) -> GDState:
    """The JAX ``GDState``'s fields less its ``key``, which is dropped."""
    return _state_from_numpy(GDState, "GD", fields, device)


def gd_state_to_numpy(state: GDState) -> dict:
    return _state_to_numpy(state)


def cgd_state_from_numpy(fields: dict, device) -> CGDState:
    return _state_from_numpy(CGDState, "CGD", fields, device)


def cgd_state_to_numpy(state: CGDState) -> dict:
    return _state_to_numpy(state)


def lm_state_from_numpy(fields: dict, device) -> LMState:
    return _state_from_numpy(LMState, "LM", fields, device)


def lm_state_to_numpy(state: LMState) -> dict:
    return _state_to_numpy(state)


def cd_state_from_numpy(fields: dict, device) -> CDState:
    return _state_from_numpy(CDState, "coordinate descent", fields, device)


def cd_state_to_numpy(state: CDState) -> dict:
    return _state_to_numpy(state)


def nm_state_from_numpy(fields: dict, device) -> NMState:
    return _state_from_numpy(NMState, "Nelder-Mead", fields, device)


def nm_state_to_numpy(state: NMState) -> dict:
    return _state_to_numpy(state)


def de_row_state_from_numpy(fields: dict, device) -> DEState:
    """The JAX row-layout ``DEState``'s fields less its ``key``, which is
    dropped."""
    return _state_from_numpy(DEState, "DE", fields, device)


def de_row_state_to_numpy(state: DEState) -> dict:
    return _state_to_numpy(state)


def pso_state_from_numpy(fields: dict, device) -> PSOState:
    """The JAX ``PSOState``'s fields less its ``key``, which is dropped."""
    return _state_from_numpy(PSOState, "PSO", fields, device)


def pso_state_to_numpy(state: PSOState) -> dict:
    return _state_to_numpy(state)


def sann_state_from_numpy(fields: dict, device) -> SANNState:
    """The JAX ``SANNState``'s fields less its ``key``, which is dropped."""
    return _state_from_numpy(SANNState, "SANN", fields, device)


def sann_state_to_numpy(state: SANNState) -> dict:
    return _state_to_numpy(state)


def nmpso_state_from_numpy(fields: dict, device) -> NMPSOState:
    """The JAX ``NMPSOState``'s fields less its ``key``, which is dropped."""
    return _state_from_numpy(NMPSOState, "NM-PSO", fields, device)


def nmpso_state_to_numpy(state: NMPSOState) -> dict:
    return _state_to_numpy(state)
