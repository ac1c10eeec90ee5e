"""Shared inputs of the parity tests of the derivative-free single-instance
solvers on lane tensors (tests/test_torch_nelder_mead.py,
test_torch_de_row.py, test_torch_pso_sann_row.py, test_torch_nmpso.py):
eight lanes of one objective family at n = 2-5, made from a numpy seed,
the same data going through ``jax.vmap`` of the JAX solver and through the
port's lane engine, in float64; and the replay of each lane's JAX key
chain, whose draws the port takes as ``draws=``.

Lane b minimizes f(x; k_b, c_b, w_b):
  k = 0, a bowl sum(w (x - c)^2) (lanes 0, 1 and 6),
  k = 1, Rosenbrock (lanes 2, 3 and 7),
  k = 2, Rastrigin (lane 4),
  k = 3, a flat f = 1 (lane 5): every spread test fires at the first step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_lanes_common import j_objective as j_three
from torch_lanes_common import t_objective as t_three

from nlsolver_torch.solvers._lane import Draws

B = 8
KINDS = np.array([0, 0, 1, 1, 2, 3, 0, 1])


def lanes(n=3, seed=0, scale=1.0):
    """(x0 [B, n], k [B], c [B, n], w [B, n]) as numpy float64 arrays;
    ``scale`` widens the starts."""
    rng = np.random.default_rng(seed + 10 * n)
    x0 = rng.uniform(-2.0, 2.0, (B, n))
    x0[KINDS == 1] = rng.uniform(-1.5, 1.5, ((KINDS == 1).sum(), n))
    x0[KINDS == 2] = rng.uniform(-0.6, 0.6, ((KINDS == 2).sum(), n))
    c = rng.standard_normal((B, n))
    w = rng.uniform(0.5, 3.0, (B, n))
    return x0 * scale, KINDS.astype(np.int64), c, w


def j_objective(x, k, c, w):
    return jnp.where(k == 3, jnp.ones((), x.dtype), j_three(x, k, c, w))


def t_objective(x, d):
    k = d[0]
    return torch.where(k == 3, torch.ones((), dtype=x.dtype), t_three(x, d))


def jax_vmapped(minimize, config, keyed=True, bounded=False):
    """``jax.vmap`` of the JAX ``minimize`` over the lanes, jitted: a
    function of (x0, k, c, w[, keys][, lower, upper])."""
    from nlsolver_tpu.core import Bounds

    def one(x, k, c, w, *rest):
        kw = {}
        if keyed:
            kw["key"], rest = rest[0], rest[1:]
        if bounded:
            kw["bounds"] = Bounds(*rest)
        return minimize(lambda p: j_objective(p, k, c, w), x, config, **kw)

    return jax.jit(jax.vmap(one))


def chain(keys, T, first, body, init_cls=None, step_cls=None):
    """Each lane's key chain replayed with ``jax.random``: ``first(key) ->
    (key, init draws)`` as the JAX ``init`` splits, then ``T`` times
    ``body(key) -> (key, step draws)`` as its ``step`` splits (a lane's key
    advances only on the steps it takes, so its t-th step reads row t).
    Returns ``Draws`` of torch tensors: init ``[B, ...]`` (a tuple made
    ``init_cls``), steps ``[T, B, ...]`` (a tuple made ``step_cls``)."""
    def lane(key):
        key, init = first(key)
        return init, jax.lax.scan(lambda k, _: body(k), key, None, length=T)[1]

    init, steps = jax.vmap(lane)(keys)

    def t(a, lead):
        a = np.array(a)
        return torch.from_numpy(a.swapaxes(0, 1).copy() if lead else a)

    init = jax.tree_util.tree_map(lambda a: t(a, False), init)
    steps = jax.tree_util.tree_map(lambda a: t(a, True), steps)
    return Draws(init if init_cls is None else init_cls(*init),
                 steps if step_cls is None else step_cls(*steps))


def torch_data(k, c, w):
    return tuple(torch.from_numpy(np.asarray(a)) for a in (k, c, w))


def keys_for(seed, b=B):
    return jax.random.split(jax.random.key(seed), b)
