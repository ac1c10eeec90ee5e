"""Shared inputs of the parity tests of the single-instance solvers on lane
tensors (tests/test_torch_gradient_solvers.py, test_torch_lm_lbfgsb.py,
test_torch_scalar.py): eight lanes of one objective family, made from a
numpy seed, the same data going through ``jax.vmap`` of the JAX solver and
through the port's lane engine.

Lane b minimizes f(x; k_b, c_b, w_b), n = 3, in float64:
  k = 0, a bowl sum(w (x - c)^2) (lanes 0-2 and 7),
  k = 1, Rosenbrock (lanes 3-5),
  k = 2, Rastrigin from a start inside its central basin's neighbours (lane 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

B, N = 8, 3
KINDS = np.array([0, 0, 0, 1, 1, 1, 2, 0])
FIELDS = ("x", "f_value", "iterations", "function_calls", "gradient_calls", "hessian_calls",
          "converged")
COUNTERS = ("iterations", "function_calls", "gradient_calls", "hessian_calls", "converged")


def lanes(seed=0):
    """(x0 [B, N], k [B], c [B, N], w [B, N]) as numpy float64 arrays."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2.0, 2.0, (B, N))
    x0[KINDS == 1] = rng.uniform(-1.5, 1.5, ((KINDS == 1).sum(), N))
    x0[KINDS == 2] = rng.uniform(-0.6, 0.6, ((KINDS == 2).sum(), N))
    c = rng.standard_normal((B, N))
    w = rng.uniform(0.5, 3.0, (B, N))
    return x0, KINDS.astype(np.int64), c, w


def j_objective(x, k, c, w):
    bowl = jnp.sum(w * (x - c) ** 2)
    rosen = jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    ras = 10.0 * x.shape[-1] + jnp.sum(x * x - 10.0 * jnp.cos(2.0 * jnp.pi * x))
    return jnp.where(k == 0, bowl, jnp.where(k == 1, rosen, ras))


def t_objective(x, d):
    k, c, w = d
    bowl = (w * (x - c) ** 2).sum()
    rosen = (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()
    ras = 10.0 * x.shape[-1] + (x * x - 10.0 * torch.cos(2.0 * torch.pi * x)).sum()
    return torch.where(k == 0, bowl, torch.where(k == 1, rosen, ras))


def jax_batched(minimize, config, **kw):
    """``jax.vmap`` of the JAX ``minimize`` over the lanes, jitted: a
    function of (x0, k, c, w)."""
    return jax.jit(jax.vmap(lambda x, k, c, w: minimize(
        lambda p: j_objective(p, k, c, w), x, config, **kw)))


def torch_data(k, c, w):
    return tuple(torch.from_numpy(np.asarray(a)) for a in (k, c, w))


def fields(res):
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def counters_differ(got, want):
    """Lanes whose counters or converged flag differ."""
    out = np.zeros(got["iterations"].shape, bool)
    for f in COUNTERS:
        out |= got[f] != want[f]
    return out


def hold(got, want, differ_limit, xtol):
    """Dtypes and shapes equal; at most ``differ_limit`` lanes whose
    counters differ; on the others x and f_value within ``xtol`` relative
    to max(|value|, 1), NaN equal to NaN.  Returns the differing lanes."""
    for f in got:
        assert got[f].dtype == want[f].dtype, f
        assert got[f].shape == want[f].shape, f
    bad = counters_differ(got, want)
    assert bad.sum() <= differ_limit, (np.nonzero(bad)[0], {f: (got[f], want[f]) for f in COUNTERS})
    ok = ~bad
    for f in ("x", "f_value"):
        g, w = got[f][ok], want[f][ok]
        close = (np.abs(g - w) <= xtol * np.maximum(np.abs(w), 1.0)) | (np.isnan(g) & np.isnan(w))
        assert close.all(), (f, g[~close], w[~close])
    return bad
