"""Batch-minor CMA-ES fleet: B independent strategies as one lane-parallel
program (counterpart of ``nlsolver_tpu.solvers.cmaes_fleet``).

The FLEET stays on the trailing (lane) axis end to end: means [n, B],
covariances [n, n, B], populations [n, lam, B], the layout rule of
solvers/bfgs_fleet.py and ops/smallchol.py.  The eigendecomposition of the
B covariances, the heavy part of a generation, is the batched
parallel-order Jacobi: ``eigh_method="jacobi"`` (the plain tensor code of
``linalg.jacobi``), ``"pallas"`` (the JAX package's name for the kernel:
here ``ops.eigh_jacobi``, the CUDA kernel on CUDA tensors and the Jacobi
twin on CPU tensors) or ``"xla"`` (its name for the library call, here
``torch.linalg.eigh`` over ``[B, n, n]``).

Every other update is elementwise over the lanes; the n-sized contractions
(sampling y = B D z, C^{-1/2} y_w, the rank-mu update) are unrolled over
the small n and mu axes.

Algorithm identical to ``solvers.cmaes`` (Hansen tutorial, arXiv:1604.00772)
including projection-repair bounds, the stagnation-gated restart variance
kick (nlsolver.h:4566-4568), and per-lane termination on max_iter /
stagnation / condition number / sigma collapse.

Against the JAX package: randomness is an input (``step`` takes the normal
draws ``z [n, lam, B]`` or makes them from a ``torch.Generator``; the
state has no ``key``); ``gen`` and ``filled`` are host ints and the two
``lax.cond``s on fleet-global predicates are Python branches, so a stale
generation launches no eigensolver at all; ``kicked`` stays on the device
and is read on the host only on a generation that would not refresh
anyway; ``drive_fleet`` is a host loop that reads ``any(~done)`` after
every step and so runs exactly the reference's steps.  ``step`` builds new
tensors and never writes into its input state.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import Bounds, lane_where, make_result
from .bfgs_fleet import colwise
from .cmaes import _params


@dataclass(frozen=True)
class CMAESFleetConfig:
    pop_size: int = 0          # 0 => 4 + floor(3 ln n)
    sigma0: float = 0.5
    max_iter: int = 500
    f_tol: float = 1e-12
    best_value_no_change: int = 50
    cond_max: float = 1e14
    kick_tol: float = 1e-6
    kick_patience: int = 10
    # eigensolver for C = B D^2 B^T: "jacobi" (batched parallel-order
    # Jacobi, linalg.jacobi), "pallas" (the ops.eigh_jacobi kernel on a
    # CUDA tensor), "xla" (torch.linalg.eigh, the library baseline)
    eigh_method: str = "jacobi"
    sweeps: int = 8
    # tile of the TPU kernel; kept for field parity, selects nothing here
    pallas_tile: int = 128
    # Hansen's lazy eigendecomposition (tutorial code's `eigeneval` gating):
    # recompute B, D every k generations and sample from the stale basis in
    # between; C itself accumulates every generation.  1 = recompute every
    # generation.  Two staleness consequences at interval k: (a) the
    # cond>cond_max termination test lags by up to k-1 generations (it
    # reads the last computed spectrum); (b) a restart variance kick would
    # otherwise keep sampling from the pre-kick basis, so any kick forces
    # a refresh on the NEXT generation (state.kicked).
    eigen_interval: int = 1
    # Deferred covariance accumulation (requires eigen_interval > 1): C is
    # only USED at eigen refreshes, so instead of streaming the [n, n, B]
    # tensor twice per generation the per-generation rank-1/rank-mu
    # FACTORS (p_c [n, B], ytop [n, mu, B], the lane decay scalar) are
    # buffered and C is materialized once per refresh as
    #   C' = (prod a_i) C + sum_i (prod_{j>i} a_j)(c1 p_c p_c^T + cmu sum_l w_l y_l y_l^T)
    # which is the eager recurrence up to roundoff, with per-generation
    # memory traffic dropping from ~2 n^2 B to ~n (mu+1) B.
    defer_covariance: bool = False


class CMAESFleetState(NamedTuple):
    mean: torch.Tensor        # [n, B]
    sigma: torch.Tensor       # [B]
    C: torch.Tensor           # [n, n, B]
    D: torch.Tensor           # [n, B]    sqrt-eigenvalues of C (possibly stale)
    Bv: torch.Tensor          # [n, n, B] eigenbasis of C (possibly stale)
    p_sigma: torch.Tensor     # [n, B]
    p_c: torch.Tensor         # [n, B]
    best_x: torch.Tensor      # [n, B]
    best_value: torch.Tensor  # [B]
    prev_best: torch.Tensor   # [B]
    iteration: torch.Tensor   # [B] int32
    nfev: torch.Tensor        # [B] int32
    no_change: torch.Tensor   # [B] int32
    gen: int                  # fleet-global generation counter (host)
    kicked: torch.Tensor      # () bool: a lane kicked last gen; force refresh
    a_buf: torch.Tensor       # [K, B] per-gen covariance decay (defer mode)
    pc_buf: torch.Tensor      # [K, n, B] per-gen evolution paths (defer mode)
    y_buf: torch.Tensor       # [K, n, mu, B] per-gen top-mu steps (defer mode)
    filled: int               # buffered gens since last refresh (host)
    done: torch.Tensor        # [B] bool
    converged: torch.Tensor   # [B] bool


def _eigh_bm(C, config: CMAESFleetConfig):
    """Eigendecomposition of [n, n, B] by the configured backend; returns
    (eigvals [n, B], eigvecs [n, n, B]), unsorted (CMA-ES is order-free)."""
    if config.eigh_method == "jacobi":
        from ..linalg.jacobi import eigh_jacobi

        return eigh_jacobi(C, sweeps=config.sweeps, sort=False)
    if config.eigh_method == "pallas":
        from ..ops.eigh_jacobi import eigh_jacobi_pallas

        return eigh_jacobi_pallas(
            C.contiguous(), sweeps=config.sweeps, tile=config.pallas_tile, sort=False
        )
    if config.eigh_method == "xla":
        from ..linalg.eigh_qr import eigh_library_batched

        w, v = eigh_library_batched(C.movedim(-1, 0))
        return w.movedim(0, -1), v.movedim(0, -1)
    raise ValueError(f"unknown eigh_method {config.eigh_method!r}")


def _materialize(C, a_buf, pc_buf, y_buf, filled, c1, cmu, w, mu, K):
    """Apply the buffered covariance window in one pass (defer mode):
    C' = (prod_i a_i) C + sum_i (prod_{j>i} a_j) U_i with
    U_i = c1 pc_i pc_i^T + cmu sum_l w_l y_il y_il^T.  Slots >= ``filled``
    (a host int) are skipped (decay 1, contribution 0), so kick-forced
    partial windows materialize correctly."""
    filled = min(int(filled), K)
    a = a_buf[:filled]
    ones = torch.ones_like(a_buf[:1])
    suffix_incl = torch.cat([torch.flip(torch.cumprod(torch.flip(a, (0,)), 0), (0,)), ones])
    Cm = suffix_incl[0][None, None, :] * C
    for i in range(filled):
        coeff = suffix_incl[i + 1]                 # prod of the decays after slot i
        pc = pc_buf[i]
        Cm = Cm + (coeff * c1) * (pc[:, None, :] * pc[None, :, :])
        for el in range(mu):
            yl = y_buf[i, :, el, :]
            Cm = Cm + (coeff * (cmu * w[el])) * (yl[:, None, :] * yl[None, :, :])
    return (Cm + Cm.transpose(0, 1)) * 0.5


def init(fn, X0: torch.Tensor, config: CMAESFleetConfig) -> CMAESFleetState:
    n, B = X0.shape
    kw = {"dtype": X0.dtype, "device": X0.device}
    f0 = colwise(fn)(X0)
    eye = torch.eye(n, **kw)[:, :, None].expand(n, n, B).contiguous()
    if config.defer_covariance:
        if config.eigen_interval < 2:
            raise ValueError(
                "defer_covariance requires eigen_interval > 1 (the buffers "
                "amortize over the refresh window)"
            )
        K = config.eigen_interval
        _, mu = _params(n, config.pop_size)[:2]
    else:
        K, mu = 1, 1                       # dummy one-slot buffers
    return CMAESFleetState(
        mean=X0,
        sigma=torch.full((B,), config.sigma0, **kw),
        C=eye,
        D=torch.ones((n, B), **kw),
        Bv=eye,
        p_sigma=torch.zeros((n, B), **kw),
        p_c=torch.zeros((n, B), **kw),
        best_x=X0,
        best_value=f0,
        prev_best=torch.full((B,), float("inf"), **kw),
        iteration=torch.zeros(B, dtype=torch.int32, device=X0.device),
        nfev=torch.ones(B, dtype=torch.int32, device=X0.device),
        no_change=torch.zeros(B, dtype=torch.int32, device=X0.device),
        gen=0,
        kicked=torch.zeros((), dtype=torch.bool, device=X0.device),
        a_buf=torch.ones((K, B), **kw),
        pc_buf=torch.zeros((K, n, B), **kw),
        y_buf=torch.zeros((K, n, mu, B), **kw),
        filled=0,
        done=torch.zeros(B, dtype=torch.bool, device=X0.device),
        converged=torch.zeros(B, dtype=torch.bool, device=X0.device),
    )


def refresh_due(state: CMAESFleetState, config: CMAESFleetConfig) -> bool:
    """Whether this generation recomputes B and D.  The schedule is decided
    from host counters; ``kicked`` is read from the device only when the
    schedule alone would skip the refresh and a kick is possible at all."""
    if config.defer_covariance:
        scheduled = state.filled >= config.eigen_interval
    else:
        scheduled = config.eigen_interval <= 1 or state.gen % config.eigen_interval == 0
    if scheduled or config.kick_tol <= 0:
        return scheduled
    return bool(state.kicked)


def _set_slot(buf: torch.Tensor, slot: int, value: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``buf[slot] = value``, as a new tensor."""
    return torch.cat([buf[:slot], value[None], buf[slot + 1:]])


def step(
    fn,
    state: CMAESFleetState,
    config: CMAESFleetConfig,
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
) -> CMAESFleetState:
    """One generation of every lane.  ``z [n, lam, B]`` are its standard
    normal draws; left out, they come from ``generator`` on the state's
    device.  Halted lanes are frozen; ``gen``, ``kicked``, ``filled`` and
    the draws advance for the whole fleet."""
    n, B = state.mean.shape
    dtype, dev = state.mean.dtype, state.mean.device
    lam, mu, weights, mu_eff, cc, cs, c1, cmu, damps, chi_n = _params(n, config.pop_size)
    w = torch.as_tensor(weights, dtype=dtype, device=dev)                # [mu]

    refresh = refresh_due(state, config)
    C_base, filled0 = state.C, state.filled
    if config.defer_covariance and refresh:
        # C was last materialized at the previous refresh; the buffers hold
        # the window since: materialize, then decompose
        C_base = _materialize(
            state.C, state.a_buf, state.pc_buf, state.y_buf, state.filled,
            c1, cmu, w, mu, config.eigen_interval,
        )
        filled0 = 0
    if refresh:
        ev, Bv = _eigh_bm(C_base, config)
        D = torch.sqrt(ev.clamp_min(1e-20))
    else:
        D, Bv = state.D, state.Bv       # the stale basis: no eigensolver runs
    eigvals = D * D                                        # [n, B]
    cond = eigvals.amax(dim=0) / eigvals.amin(dim=0)

    improved = state.best_value < state.prev_best - config.f_tol
    no_change = torch.where(improved, torch.zeros_like(state.no_change), state.no_change + 1)
    hit_tol = no_change >= config.best_value_no_change
    done_now = (
        (state.iteration >= config.max_iter)
        | hit_tol
        | (cond > config.cond_max)
        | (state.sigma < 1e-18)
    )
    halted = state._replace(
        no_change=no_change, done=torch.ones_like(state.done), converged=hit_tol
    )

    if z is None:
        z = torch.randn((n, lam, B), generator=generator, dtype=dtype, device=dev)
    Dz = D[:, None, :] * z                                 # [n, lam, B]
    # y = B (D z): contraction over the small k axis, unrolled
    y = torch.zeros((n, lam, B), dtype=dtype, device=dev)
    for k in range(n):
        y = y + Bv[:, k, :][:, None, :] * Dz[k][None, :, :]
    xs = state.mean[:, None, :] + state.sigma[None, None, :] * y
    if bounds is not None:
        # bounds are "broadcastable against x": scalars and [n] alike
        lo, hi = _box(bounds, n, dtype, dev)
        xs = torch.clamp(xs, lo[:, :, None], hi[:, :, None])
        y = (xs - state.mean[:, None, :]) / state.sigma[None, None, :]
    values = colwise(fn)(xs.reshape(n, lam * B)).reshape(lam, B)

    order = torch.argsort(values, dim=0, stable=True)      # [lam, B]
    order_mu = order[:mu]                                  # [mu, B]
    gen_best = torch.take_along_dim(values, order[:1], dim=0)[0]     # [B]
    ytop = torch.take_along_dim(y, order_mu[None, :, :], dim=1)      # [n, mu, B]
    y_w = (ytop * w[None, :, None]).sum(dim=1)             # [n, B]
    new_mean = state.mean + state.sigma[None, :] * y_w

    # C^{-1/2} y_w = B D^-1 B^T y_w
    t = (Bv * y_w[:, None, :]).sum(dim=0)                  # [n, B] (B^T y_w)
    ci = (Bv * (t / D)[None, :, :]).sum(dim=1)             # [n, B]
    p_sigma = (1 - cs) * state.p_sigma + math.sqrt(cs * (2 - cs) * mu_eff) * ci
    ps_norm = torch.sqrt((p_sigma * p_sigma).sum(dim=0))   # [B]
    sigma = state.sigma * torch.exp((cs / damps) * (ps_norm / chi_n - 1))
    if config.kick_tol > 0:
        vmu = torch.take_along_dim(values, order[mu - 1: mu], dim=0)[0]
        collapsed = ((gen_best - vmu).abs() < config.kick_tol) & (
            no_change >= config.kick_patience
        )
        sigma = torch.where(collapsed, sigma * math.exp(0.2 + cs / damps), sigma)
        any_kick = (collapsed & ~done_now).any()
    else:
        any_kick = torch.zeros((), dtype=torch.bool, device=dev)

    it1 = (state.iteration + 1).to(dtype)
    hsig = (
        ps_norm / torch.sqrt(1 - (1 - cs) ** (2 * it1)) / chi_n
    ) < (1.4 + 2 / (n + 1))
    hsig = hsig.to(dtype)     # a bool times a Python float would drop to float32
    p_c = (1 - cc) * state.p_c + hsig[None, :] * math.sqrt(cc * (2 - cc) * mu_eff) * y_w
    delta_hsig = (1 - hsig) * cc * (2 - cc)
    if config.defer_covariance:
        # buffer this generation's factors instead of streaming [n, n, B]
        a_t = (1.0 - c1 - cmu) + c1 * delta_hsig           # [B]
        a_buf = _set_slot(state.a_buf, filled0, a_t)
        pc_buf = _set_slot(state.pc_buf, filled0, p_c)
        y_buf = _set_slot(state.y_buf, filled0, ytop)
        C = C_base
        new_filled = filled0 + 1
    else:
        rank1 = p_c[:, None, :] * p_c[None, :, :]          # [n, n, B]
        rank_mu = torch.zeros((n, n, B), dtype=dtype, device=dev)
        for el in range(mu):
            yl = ytop[:, el, :]
            rank_mu = rank_mu + w[el] * yl[:, None, :] * yl[None, :, :]
        C = (
            (1 - c1 - cmu) * state.C
            + c1 * (rank1 + delta_hsig[None, None, :] * state.C)
            + cmu * rank_mu
        )
        C = (C + C.transpose(0, 1)) / 2
        a_buf, pc_buf, y_buf = state.a_buf, state.pc_buf, state.y_buf
        new_filled = state.filled

    x_gen = torch.take_along_dim(xs, order[:1][None, :, :], dim=1)[:, 0, :]
    better = gen_best < state.best_value
    best_x = torch.where(better[None, :], x_gen, state.best_x)
    best_value = torch.where(better, gen_best, state.best_value)

    worked = CMAESFleetState(
        mean=new_mean,
        sigma=sigma,
        C=C,
        D=D,
        Bv=Bv,
        p_sigma=p_sigma,
        p_c=p_c,
        best_x=best_x,
        best_value=best_value,
        prev_best=state.best_value,
        iteration=state.iteration + 1,
        nfev=state.nfev + lam,
        no_change=no_change,
        gen=state.gen + 1,
        kicked=any_kick,
        a_buf=a_buf,
        pc_buf=pc_buf,
        y_buf=y_buf,
        filled=new_filled,
        done=torch.zeros_like(state.done),
        converged=torch.zeros_like(state.converged),
    )
    # per-lane select; gen, kicked and filled carry no lane axis (one
    # counter covers all lanes) and always advance with ``worked``
    return lane_where(done_now, halted, worked)


def _box(bounds: Bounds, n: int, dtype, dev):
    """The box as ``[n, 1]`` columns."""
    lo = torch.as_tensor(bounds.lower, dtype=dtype, device=dev).expand(n).reshape(n, 1)
    hi = torch.as_tensor(bounds.upper, dtype=dtype, device=dev).expand(n).reshape(n, 1)
    return lo, hi


def drive_fleet_scan(step_fn, state: CMAESFleetState, trips: int) -> CMAESFleetState:
    """Fixed-trip loop for benchmarking: every run does identical work;
    finished lanes stay frozen, the fleet's counters advance."""
    for _ in range(trips):
        state = lane_where(state.done, state, step_fn(state))
    return state


def drive_fleet(step_fn, state: CMAESFleetState) -> CMAESFleetState:
    """Step until every lane is done; ``any(~done)`` is read on the host
    after every step (a generation is far longer than a read)."""
    while bool((~state.done).any()):
        state = lane_where(state.done, state, step_fn(state))   # freeze finished lanes
    return state


def minimize_fleet(
    fn,
    X0: torch.Tensor,                    # [n, B] batch-minor start points
    config: CMAESFleetConfig = CMAESFleetConfig(),
    bounds: Optional[Bounds] = None,
    *,
    generator: Optional[torch.Generator] = None,
):
    """Minimize B independent instances of ``fn`` ([n] -> scalar).

    The fleet runs on ``X0``'s device; ``generator`` lives there too, takes
    the place of the JAX package's ``key`` and defaults to seed 0.  Returns
    a SolverResult with per-lane fields; ``x`` stays [n, B]."""
    if generator is None:
        generator = torch.Generator(device=X0.device).manual_seed(0)
    if bounds is not None:
        lo, hi = _box(bounds, X0.shape[0], X0.dtype, X0.device)
        X0 = torch.clamp(X0, lo, hi)
    state = init(fn, X0, config)
    state = drive_fleet(lambda s: step(fn, s, config, bounds, generator=generator), state)
    return make_result(
        x=state.best_x,
        f_value=state.best_value,
        iterations=state.iteration,
        function_calls=state.nfev,
        converged=state.converged,
    )
