"""Shared inputs of the replay parity tests (tests/test_torch_replays.py,
test_torch_replays_chains.py, test_torch_replays_api.py): the four replay
modules of each package, which fields of their states are compared, the
4-D Rosenbrock problem outside the golden file, and the step-by-step
comparison against the JAX replay run op by op (``jax.disable_jit``)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nlsolver_torch.random import mt19937 as tm
from nlsolver_torch.random import reference_rngs as tr
from nlsolver_torch.solvers import de_reference as tde
from nlsolver_torch.solvers import nmpso_reference as tnp
from nlsolver_torch.solvers import pso_reference as tps
from nlsolver_torch.solvers import sann_reference as tsa
from nlsolver_tpu.random import mt19937 as jm
from nlsolver_tpu.random import reference_rngs as jr
from nlsolver_tpu.solvers import de_reference as jde
from nlsolver_tpu.solvers import nmpso_reference as jnp_ref
from nlsolver_tpu.solvers import pso_reference as jps
from nlsolver_tpu.solvers import sann_reference as jsa

X0 = (-0.5, 0.3, 0.8, -1.2)
STEPS = 10
PAIRS = {"de": (tde, jde, "DEReferenceConfig"), "sann": (tsa, jsa, "SANNReferenceConfig"),
         "pso": (tps, jps, "PSOAccReferenceConfig"),
         "nmpso": (tnp, jnp_ref, "NMPSOReferenceConfig")}
# the positions, the stored scores and the counters of each replay's state
POSITIONS = {"de": ("agents",), "sann": ("x", "p"), "pso": ("positions", "swarm_best"),
             "nmpso": ("positions", "velocities")}
SCORES = {"de": ("scores",), "sann": ("best_val",), "pso": ("best_values", "swarm_best_value"),
          "nmpso": ("values", "best_val0")}
COUNTERS = {"de": ("best_id", "val_no_change"), "sann": (), "pso": ("val_no_change",),
            "nmpso": ("no_change",)}


def t_rosen(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()


def j_rosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def words(state):
    out = []
    for leaf in (state if isinstance(state, tuple) else (state,)):
        if isinstance(leaf, tuple):
            out.extend(words(leaf))
        else:
            a = np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor) else leaf)
            out.extend(a.reshape(-1).tolist() if a.dtype.kind in "iu" else
                       a.reshape(-1).view(np.uint64 if a.dtype == np.float64 else np.uint32)
                       .tolist())
    return out


def bit_equal(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want), name


def op_by_op(fn):
    def run(*args):
        with jax.disable_jit():
            return fn(*args)

    return run


def steps_equal_jax(family, rng, extra):
    """``STEPS`` steps of ``family``'s replay on generator ``rng`` (mt19937
    registered in both packages for the run and taken out after), each
    state held against the JAX replay's run op by op, every field bit for
    bit."""
    tmod, jmod, cls = PAIRS[family]
    kind = rng if rng != "mt" else "mt_replays"
    kw = dict(max_iter=STEPS + 5, rng=kind, **extra)
    if family == "de":
        kw["pop_size"] = 8
    tcfg, jcfg = getattr(tmod, cls)(**kw), getattr(jmod, cls)(**kw)
    x0 = np.asarray(X0)
    if rng == "mt":
        jm.register_mt(kind, seed=42)
    try:
        with tm.registered_mt(kind, seed=42) if rng == "mt" else contextlib.nullcontext():
            t_state = tmod.init(t_rosen, torch.from_numpy(x0), tcfg)
            j_state = op_by_op(lambda: jmod.init(j_rosen, jnp.asarray(x0), jcfg))()
            j_step = op_by_op(lambda s: jmod.step(j_rosen, s, jcfg))
            fields = POSITIONS[family] + SCORES[family] + COUNTERS[family] + (
                "iteration", "nfev", "done", "converged")
            for k in range(STEPS + 1):
                for f in fields:
                    bit_equal(getattr(t_state, f), getattr(j_state, f), f"{f} after {k} steps")
                assert words(t_state.rng) == words(j_state.rng), f"rng after {k} steps"
                t_state, j_state = tmod.step(t_rosen, t_state, tcfg), j_step(j_state)
            assert int(t_state.iteration) == STEPS + 1
    finally:
        jr._CUSTOM.pop(kind, None)
    assert kind not in tr._CUSTOM
