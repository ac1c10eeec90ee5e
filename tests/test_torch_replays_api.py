"""The replays' entry points and configs against the JAX package's: the
config dataclasses field for field, ``minimize`` and ``maximize`` bit for
bit against the JAX replay run op by op (tests/torch_replays_common.py),
and the refusals of ``bounds`` and of a numpy start without a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_replays_common import PAIRS, X0, bit_equal, op_by_op, j_rosen, t_rosen

torch.set_num_threads(1)


@pytest.mark.parametrize("family", sorted(PAIRS))
def test_config_fields_equal_jax(family):
    tmod, jmod, cls = PAIRS[family]

    def spec(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert spec(getattr(tmod, cls)) == spec(getattr(jmod, cls))


@pytest.mark.parametrize("family", sorted(PAIRS))
def test_minimize_and_maximize_equal_jax(family):
    """The entry points: ``minimize`` to a halt (``max_iter`` 4) and
    ``maximize`` of the negated objective give what the JAX package's give
    op by op, bit for bit."""
    tmod, jmod, cls = PAIRS[family]
    kw = {"max_iter": 4} if family != "de" else {"max_iter": 4, "pop_size": 8}
    tcfg, jcfg = getattr(tmod, cls)(**kw), getattr(jmod, cls)(**kw)
    x0 = np.asarray(X0)
    for verb, sign in (("minimize", 1.0), ("maximize", -1.0)):
        got = getattr(tmod, verb)(lambda x: sign * t_rosen(x), torch.from_numpy(x0), tcfg)
        want = op_by_op(lambda x: getattr(jmod, verb)(lambda p: sign * j_rosen(p), x, jcfg))(
            jnp.asarray(x0))
        for f in ("x", "f_value", "iterations", "function_calls", "converged"):
            bit_equal(getattr(got, f), getattr(want, f), f"{verb} {f}")


@pytest.mark.parametrize("family", sorted(PAIRS))
def test_replays_refuse_bounds_and_numpy_starts_without_a_card(family):
    """The JAX replays take ``bounds`` and ignore them; the port's refuse
    them.  A start point that is no tensor goes to the card, and raises
    without one."""
    tmod, _, cls = PAIRS[family]
    x0 = torch.tensor(X0, dtype=torch.float64)
    with pytest.raises(ValueError, match="no bounds"):
        tmod.minimize(t_rosen, x0, getattr(tmod, cls)(max_iter=2), bounds=(-1.0, 1.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmod.minimize(t_rosen, np.asarray(X0), getattr(tmod, cls)(max_iter=2))
