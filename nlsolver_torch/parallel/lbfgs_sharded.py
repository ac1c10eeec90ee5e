"""L-BFGS with the dimension sharded over a mesh, for very large n
(counterpart of ``nlsolver_tpu.parallel.lbfgs_sharded``).

``x``, the gradient and the ``[m, n]`` history rings are cut into blocks
over the ``pop`` axis (the dimension axis here); the dp rows compute the
same thing.  The two-loop recursion keeps its axpys local: each inner
product is a local partial dot plus a sum over the pop subgroup, and the
backtracking Armijo search costs one such sum a trial.  The sums are one
``all_gather`` of the partials, added in rank order (``dim_sum``), so
every rank reads the same bits and every branch (a converged gradient, an
ascent direction, an Armijo test, a curvature pair kept or dropped) is
taken alike on every rank; each is read on the host.

The objective contract (the JAX package's, whose objective reduces with
``lax.psum`` and finds its block with ``lax.axis_index``):

  * ``fn_local(x_local)`` returns a 0-d partial value; the sum of the
    partials over the pop subgroup is the objective;
  * ``grad_local(x_local)`` returns this rank's block of the gradient of
    the objective;
  * an objective that couples the blocks reduces over the pop subgroup
    itself, with ``dim_sum(t, mesh)``, and finds its block of the
    dimension with ``dim_block(n, mesh)`` (or ``parallel.mesh.coordinate``).
    Each rank calls them in the same order, as it calls any collective.

Every rank returns the global ``x [n]`` through one gather over pop.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core import SolverResult, make_result, start_points
from .mesh import POP_AXIS, all_gather, block, check_device, coordinate

DIM_AXIS = POP_AXIS  # the mesh's second axis doubles as the dimension axis


def dim_block(n: int, mesh) -> slice:
    """This rank's block of an ``n``-vector sharded over the dimension axis."""
    return block(n, mesh.size(1), coordinate(mesh)[1])


def dim_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the pop subgroup, added in rank order after one
    gather (the same bits on every rank); ``t`` itself on one rank."""
    if mesh.size(1) == 1:
        return t
    g = all_gather(t[None], mesh.get_group(DIM_AXIS), dim=0)
    out = g[0]
    for i in range(1, g.shape[0]):
        out = out + g[i]
    return out


def minimize_dim_sharded(
    fn_local: Callable,     # this block's partial value of the objective
    grad_local: Callable,   # d(objective) / d(x_local) given x_local
    x0,                     # [n] global start point
    mesh,
    memory: int = 10,
    max_iter: int = 100,
    grad_eps: float = 1e-8,
    ls_shrink: float = 0.5,
    ls_max: int = 30,
) -> SolverResult:
    """L-BFGS over a dimension-sharded parameter vector, with a
    backtracking Armijo line search (one sum over pop a trial) in place of
    More-Thuente to keep the cross-rank traffic small."""
    x0 = start_points(x0)
    n = x0.shape[0]
    shards = mesh.size(1)
    if n % shards:
        raise ValueError(f"dimension {n} must divide over {shards} shards")
    check_device(x0, mesh)
    x = x0[dim_block(n, mesh)].clone()
    m, n_loc, dtype, dev = memory, x.shape[0], x.dtype, x.device

    def pdot(a, b):
        return dim_sum(torch.dot(a, b), mesh)

    def f_global(xl):
        return dim_sum(fn_local(xl), mesh)

    g = grad_local(x)
    f = f_global(x)
    s_hist = torch.zeros((m, n_loc), dtype=dtype, device=dev)
    y_hist = torch.zeros((m, n_loc), dtype=dtype, device=dev)
    rho = torch.zeros((m,), dtype=dtype, device=dev)
    valid = [False] * m
    head = it = 0
    nfev = 1

    def two_loop(g):
        # an entry never kept adds nothing (JAX masks it to a zero step)
        q, alphas = g, {}
        for i in range(m):
            idx = (head - 1 - i) % m
            if valid[idx]:
                alphas[idx] = rho[idx] * pdot(s_hist[idx], q)
                q = q - alphas[idx] * y_hist[idx]
        newest = (head - 1) % m
        r = q
        if valid[newest]:
            ys, yy = pdot(s_hist[newest], y_hist[newest]), pdot(y_hist[newest], y_hist[newest])
            if bool(yy > 0):
                r = (ys / yy) * q
        for i in range(m):
            idx = (head + i) % m
            if valid[idx]:
                b = rho[idx] * pdot(y_hist[idx], r)
                r = r + (alphas[idx] - b) * s_hist[idx]
        return -r

    while True:
        hit = bool(pdot(g, g).sqrt() < grad_eps)
        if it >= max_iter or hit:
            break
        d = two_loop(g)
        slope = pdot(g, d)
        if bool(slope >= 0):
            d = -g
            slope = -pdot(g, g)
        alpha = torch.ones((), dtype=dtype, device=dev)
        f_new = f_global(x + d)
        k = 0
        while k < ls_max and bool(f_new > f + 1e-4 * alpha * slope):
            alpha = alpha * ls_shrink
            f_new = f_global(x + alpha * d)
            k += 1
        s = alpha * d
        x = x + s
        g_new = grad_local(x)
        y = g_new - g
        ys = pdot(y, s)
        if bool(ys > 1e-10):
            idx = head % m
            s_hist[idx], y_hist[idx], rho[idx] = s, y, 1.0 / ys
            valid[idx] = True
            head += 1
        g, f = g_new, f_new
        it += 1
        nfev += k + 1
    x_global = all_gather(x, mesh.get_group(DIM_AXIS), dim=0) if shards > 1 else x
    return make_result(x=x_global, f_value=f, iterations=it, function_calls=nfev, converged=hit)
