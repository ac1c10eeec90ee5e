"""Per-iteration trajectory capture for the state-machine solvers
(counterpart of ``nlsolver_tpu.trace``).

The reference destroys its per-iteration state on return (solver-local
``std::vector`` buffers, e.g. nlsolver.h:2166-2299); observing a trajectory
there takes one whole run per prefix length.  Here every solver is an
``init`` / ``step`` machine, so one fixed-trip loop
(:func:`nlsolver_torch.core.driver.drive_trace`) yields the whole iterate
sequence: for debugging, plotting, and the trajectory parity against the
reference binary (``nlsolver_torch.parity``).

``trajectory(...)`` returns a dict of stacked tensors with a leading
``[num_steps]`` axis; entry ``i`` is the state after ``i + 1`` iterations,
a finished run frozen (so the tail of a converged run repeats its fixed
point: what re-running the reference with ``max_iter = i + 1`` gives).
The single-instance solvers with a lane form (Nelder-Mead, GD, CGD, BFGS,
LM) run one lane, B = 1, squeezed; the reference replays run their one
instance.  GD's PAGE mode draws from a ``torch.Generator`` of seed 0 on
``x0``'s device.
"""
from __future__ import annotations

import torch

from .core import batch_eval, resolve_bounds, start_points
from .core.driver import drive_trace
from .solvers import (bfgs, cgd, de_reference, gd, lm, nelder_mead, nmpso_reference,
                      pso_reference, sann_reference)


def _pick(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[t]`` of ``a[t]`` for every step t: ``[T, K, ...]`` ->
    ``[T, ...]``."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def _out(x, f, tr):
    return {"x": x, "f": f, "iteration": tr.iteration, "nfev": tr.nfev, "done": tr.done}


def _lane_out(x, f, tr):
    """A trace of one lane (B = 1): ``x [T, n]`` and ``f [T]``, the
    counters without their lane axis."""
    return {"x": x, "f": f, "iteration": tr.iteration[:, 0], "nfev": tr.nfev[:, 0],
            "done": tr.done[:, 0]}


def _de_ref(fn, x0, config, num_steps):
    _, tr = drive_trace(lambda s: de_reference.step(fn, s, config),
                        de_reference.init(fn, x0, config), num_steps)
    best = de_reference.report_best(tr)
    return _out(_pick(tr.agents, best), _pick(tr.scores, best), tr)


def _sann_ref(fn, x0, config, num_steps):
    _, tr = drive_trace(lambda s: sann_reference.step(fn, s, config),
                        sann_reference.init(fn, x0, config), num_steps)
    return _out(tr.x, tr.best_val, tr)


def _pso_ref(fn, x0, config, num_steps):
    _, tr = drive_trace(lambda s: pso_reference.step(fn, s, config),
                        pso_reference.init(fn, x0, config), num_steps)
    return _out(tr.swarm_best, tr.swarm_best_value, tr)


def _nmpso_ref(fn, x0, config, num_steps):
    _, tr = drive_trace(lambda s: nmpso_reference.step(fn, s, config),
                        nmpso_reference.init(fn, x0, config), num_steps)
    best = nmpso_reference.report_best(tr)
    return _out(_pick(tr.positions, best), _pick(tr.values, best), tr)


def _nm(fn, x0, config, num_steps, bounds):
    x0 = x0[None]
    lower, upper, bounded = resolve_bounds(bounds, x0)
    _, tr = drive_trace(lambda s: nelder_mead.step(fn, s, config, lower, upper, bounded),
                        nelder_mead.init(fn, x0, config), num_steps)
    best = tr.scores.argmin(dim=-1)                                 # [T, 1]
    x = torch.take_along_dim(tr.simplex, best[..., None, None], dim=2)[:, :, 0]
    return _lane_out(x[:, 0], tr.scores.amin(dim=-1)[:, 0], tr)


def _plain(module, draws: bool):
    def run(fn, x0, config, num_steps):
        kw = {"generator": torch.Generator(device=x0.device).manual_seed(0)} if draws else {}
        _, tr = drive_trace(lambda s: module.step(fn, s, config, **kw),
                            module.init(fn, x0[None], config), num_steps)
        x = tr.x[:, 0]
        return _lane_out(x, batch_eval(fn, x), tr)

    return run


# family -> (runner, default config, takes bounds)
_FAMILIES = {
    "nelder_mead": (_nm, nelder_mead.NelderMeadConfig, True),
    "gd": (_plain(gd, True), gd.GDConfig, False),
    "cgd": (_plain(cgd, False), cgd.CGDConfig, False),
    "bfgs": (_plain(bfgs, False), bfgs.BFGSConfig, False),
    "lm": (_plain(lm, False), lm.LMConfig, False),
    "de_reference": (_de_ref, de_reference.DEReferenceConfig, False),
    "sann_reference": (_sann_ref, sann_reference.SANNReferenceConfig, False),
    "pso_acc_reference": (_pso_ref, pso_reference.PSOAccReferenceConfig, False),
    "nmpso_reference": (_nmpso_ref, nmpso_reference.NMPSOReferenceConfig, False),
}


def trajectory(family: str, fn, x0, config=None, *, num_steps: int = 50, bounds=None):
    """Capture ``num_steps`` iterates of ``family`` minimizing ``fn`` from
    ``x0 [n]``.  Supported families: bfgs, cgd, de_reference, gd, lm,
    nelder_mead, nmpso_reference, pso_acc_reference, sann_reference.
    ``bounds`` is Nelder-Mead's (the other families are unconstrained and
    refuse it); a start point that is no tensor goes to the card."""
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}; supported: {sorted(_FAMILIES)}")
    run, default_cfg, takes_bounds = _FAMILIES[family]
    if config is None:
        config = default_cfg()
    x0 = start_points(x0)
    if x0.ndim != 1:
        raise ValueError(f"a trajectory starts from one point [n], got {tuple(x0.shape)}")
    if takes_bounds:
        return run(fn, x0, config, num_steps, bounds)
    if bounds is not None:
        raise ValueError(f"family {family!r} is unconstrained and takes no bounds= (the JAX "
                         f"package's ignores them without a word)")
    return run(fn, x0, config, num_steps)
