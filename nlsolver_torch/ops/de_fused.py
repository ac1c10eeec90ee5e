"""One whole DE generation as one CUDA kernel (``csrc/de_fused.cu``), with
its plain PyTorch twin.

Counterpart of ``nlsolver_tpu/ops/de_fused.py:de_generation_fused``.  The
layout is the batched engine's: agents ``[B, n, P]``, scores ``[B, P]``,
ring-rotation partners.  The kernel also folds the lane freeze into the
greedy select: a lane whose ``active`` flag is false comes back unchanged.

``de_generation_fused`` launches a kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
``de_generation_reference``.  The JAX kernel traced any ``fn`` into its
body; the CUDA kernel has a registry of compiled objectives instead
(``KERNEL_OBJECTIVES``).

The kernel comes in three forms, chosen by n and P alone:
``de_generation_staged`` (K1s) stages a block's instances in shared memory
with one bulk asynchronous copy and keeps each proposal from the score pass
(in registers for n <= 16, in shared memory beyond), for every population
whose slab fits a block (``staged_plan``); ``de_generation_cluster`` (K1c)
stages one instance over the shared memory of a thread-block cluster of 2,
4, 8 or 16 CTAs, reads the partners through distributed shared memory and
keeps the proposals beside the slab, where ``cluster_plan`` fits (n <= 226
at P = 1024 on 8 CTAs, up to 453 on 16); ``de_generation_global`` (K1g)
reads the agents from device memory and recomputes an accepted proposal for
its write-back, for the rest.  All give the same proposals and scores.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
from torch.func import vmap

from ..problems import PROBLEMS
from . import _build
from ._build import MAX_DYNAMIC_SMEM

# objectives compiled into the kernel, by the port's function object
KERNEL_OBJECTIVES = {
    PROBLEMS["rastrigin"].fn: "rastrigin",
    PROBLEMS["sphere"].fn: "sphere",
}

# the staged form: its proposal in registers up to this n (csrc/de_fused.cu's
# kRegisterMaxN), the threads a block aims at, and the dynamic shared memory a
# block may take beside its 8-byte mbarrier
STAGED_REGISTER_MAX_N = 16
STAGED_THREADS = 256
STAGED_SMEM = MAX_DYNAMIC_SMEM - 16

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # the 32x32 -> 64-bit product wraps modulo 2^64 in int64 (two's
    # complement), so its high and low 32-bit words are exact
    p = c * m
    return (p >> 32) & _MASK32, p & _MASK32


def philox4x32_10(ctr: Sequence[torch.Tensor], k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words: the twin of
    ``csrc/philox.cuh``.  Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = k0 & _MASK32, k1 & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_draws(seed: int, generation: int, B: int, n: int, P: int,
                 dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's Philox-mode draws: ``u [B, n, P]`` and ``fdim [B, P]``.
    Counter ``(d // 4, p, b, 0)`` gives the uniforms of coordinates
    ``d .. d+3``; counter ``(0, p, b, 1)`` gives the forced dimension."""
    def ar(k, shape):
        return torch.arange(k, dtype=torch.int64, device=device).reshape(shape)

    G = (n + 3) // 4
    b, p = ar(B, (B, 1, 1)), ar(P, (1, P, 1))
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10((ar(G, (1, 1, G)), p, b, zero), seed, generation)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(B, P, 4 * G)
    u = ((bits[..., :n] >> 8).to(dtype) * 2.0**-24).permute(0, 2, 1).contiguous()
    fbits = philox4x32_10((zero, p[..., 0], b[..., 0], zero + 1), seed, generation)[0]
    return u, fbits.expand(B, P) % n


def eval_columns(fn, agents: torch.Tensor) -> torch.Tensor:
    """Score every agent column: ``[B, n, P] -> [B, P]``, ``fn`` on one
    point ``[n]`` through ``vmap``, as the JAX engine's ``_eval_columns``
    does; one ``vmap`` over the B P points, not one inside another, for the
    host's sake."""
    B, n, P = agents.shape
    return vmap(fn)(agents.transpose(1, 2).reshape(B * P, n)).reshape(B, P)


def de_generation_reference(fn, agents, scores, offs, u, fdim, active, F, CR):
    """Plain PyTorch twin of the kernel: one rotation DE generation.

    ``offs`` are the ring offsets (partners ``(p + o_k) % P``), ``u [B, n, P]``
    the crossover uniforms, ``fdim [B, P]`` the forced dimensions and
    ``active [B]`` the lanes that may change.  Returns the new agents and
    scores."""
    o1, o2, o3 = (int(o) for o in offs)
    a1, a2, a3 = (torch.roll(agents, -o, dims=2) for o in (o1, o2, o3))
    donor = a1 + F * (a2 - a3)
    dims = torch.arange(agents.shape[1], device=agents.device)[None, :, None]
    mutate = (u < CR) | (dims == fdim[:, None, :])
    prop = torch.where(mutate, donor, agents)
    prop_scores = eval_columns(fn, prop)
    accept = (prop_scores < scores) & active[:, None]
    return (
        torch.where(accept[:, None, :], prop, agents),
        torch.where(accept, prop_scores, scores),
    )


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"de_generation_fused: {what}")


def staged_plan(n: int, P: int) -> Optional[tuple[int, int]]:
    """``(instances a block, bytes of dynamic shared memory)`` of the staged
    form for n coordinates and P agents: about STAGED_THREADS threads, as
    many instances as fit, each a slab of n * P floats (and as many again
    for the proposals where n > STAGED_REGISTER_MAX_N).  None where one
    instance does not fit a block: the global form takes it."""
    if P > 1024 or n < 1:
        return None
    words = n * P * (1 if n <= STAGED_REGISTER_MAX_N else 2)
    per_block = max(1, STAGED_THREADS // P)
    while per_block > 1 and per_block * words * 4 > STAGED_SMEM:
        per_block -= 1
    return (per_block, per_block * words * 4) if words * 4 <= STAGED_SMEM else None


# the clusters K1c takes, CTAs an instance (16 by the non-portable size),
# and the agents (threads) a CTA its plan aims at
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER_AGENTS = 128


def cluster_plan(n: int, P: int) -> Optional[tuple[int, int]]:
    """``(CTAs a cluster, bytes of dynamic shared memory a CTA)`` of K1c for n
    coordinates and P agents: of the sizes of ``CLUSTER_SIZES`` that divide
    P and whose CTA's share of the instance, P / C agents' slab and
    proposals (2 n P / C floats), fits its shared memory, the fewest CTAs
    of at most ``CLUSTER_AGENTS`` agents each (several CTAs an SM: on an
    H100, 49.97 us against 56.20 on clusters of 2 at [256, 29, 1024]), or
    the most CTAs where none is that small.  None where no cluster takes it (P > 1024,
    or n past 453 at P = 1024): the global form takes it."""
    if P > 1024 or n < 1:
        return None
    fits = [size for size in CLUSTER_SIZES
            if P % size == 0 and 2 * n * (P // size) * 4 <= STAGED_SMEM]
    if not fits:
        return None
    size = next((c for c in fits if P // c <= CLUSTER_AGENTS), fits[-1])
    return size, 2 * n * (P // size) * 4


# C entry points by form: de_<form>_<objective>_f32 and the ints after the
# draws' key (staged: instances a block, bytes, bulk; cluster: CTAs, bytes,
# bulk, probe mode)
_ENTRY = {"staged": ("staged", 3), "cluster": ("cluster", 4), "global": ("generation", 0)}


def generation_form(n: int, P: int) -> str:
    """The form the dispatcher gives n and P: "staged" (K1s) where
    ``staged_plan`` fits, else "cluster" (K1c) where ``cluster_plan`` fits,
    else "global" (K1g)."""
    if staged_plan(n, P) is not None:
        return "staged"
    return "cluster" if cluster_plan(n, P) is not None else "global"


@functools.lru_cache(maxsize=None)
def _launcher(name: str, form: str):
    entry, extra = _ENTRY[form]
    fn = getattr(_build.load_library(), f"de_{entry}_{name}_f32")
    vp, ci, cf, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fn.argtypes = [vp] * 7 + [ci] * 6 + [cf, cf, cu, cu] + [ci] * extra + [vp]
    fn.restype = ci
    return fn


def _check_common(agents, offs, u, fdim):
    _check(agents.ndim == 3, f"agents must be [B, n, P], got {tuple(agents.shape)}")
    B, n, P = agents.shape
    offs = tuple(int(o) for o in offs)
    _check(len(offs) == 3 and all(0 < o < P for o in offs),
           f"offs must be 3 offsets in [1, {P}), got {offs}")
    _check((u is None) == (fdim is None), "pass u and fdim together or neither")
    return B, n, P, offs


def _twin(fn, agents, scores, offs, active, seed, generation, cross_prob, diff_weight, u, fdim):
    """The CPU route: the plain twin on the injected draws, or on the
    kernel's Philox draws replayed."""
    B, n, P = agents.shape
    if u is None:
        u, fdim = philox_draws(seed, generation, B, n, P, agents.dtype, agents.device)
    return de_generation_reference(fn, agents, scores, offs, u, fdim, active, diff_weight,
                                   cross_prob)


def _launch(form: str, fn, agents, scores, offs, active, seed, generation, cross_prob,
            diff_weight, u, fdim, _mode=0):
    """K1's ``form`` ("staged", "cluster" or "global"): the twin on CPU
    tensors; on CUDA tensors the inputs checked and the kernel launched.
    Returns the new agents and scores and whether a kernel was launched."""
    name = f"de_generation_{form}"
    B, n, P, offs = _check_common(agents, offs, u, fdim)
    if agents.device.type == "cpu":
        return (*_twin(fn, agents, scores, offs, active, seed, generation, cross_prob,
                       diff_weight, u, fdim), False)
    _check(agents.device.type == "cuda", f"unsupported device {agents.device}")
    objective = KERNEL_OBJECTIVES.get(fn)
    _check(objective is not None,
           "the CUDA kernel evaluates only the objectives of its registry "
           f"({', '.join(sorted(KERNEL_OBJECTIVES.values()))} from "
           "nlsolver_torch.PROBLEMS); use use_fused_kernel=False for others")
    _check(P <= 1024, f"pop size {P} exceeds one block (1024 threads)")
    plan = () if form == "global" else (staged_plan if form == "staged" else cluster_plan)(n, P)
    _check(plan is not None,
           f"{name}: n={n}, P={P} does not fit the shared memory of a "
           f"{'block' if form == 'staged' else 'cluster'}; de_generation_global takes it")
    dev = agents.device
    expect = {
        "agents": (agents, (B, n, P), torch.float32),
        "scores": (scores, (B, P), torch.float32),
        "active": (active, (B,), torch.bool),
    }
    if u is not None:
        fdim = fdim.to(torch.int32)
        expect["u"] = (u, (B, n, P), torch.float32)
        expect["fdim"] = (fdim, (B, P), torch.int32)
    for what, (t, shape, dtype) in expect.items():
        _check(t.device == dev, f"{what} is on {t.device}, agents on {dev}")
        _check(tuple(t.shape) == shape, f"{what} must be {shape}, got {tuple(t.shape)}")
        _check(t.dtype == dtype, f"{what} must be {dtype}, got {t.dtype}")
        _check(t.is_contiguous(), f"{what} must be contiguous")

    out_agents = torch.empty_like(agents)
    out_scores = torch.empty_like(scores)
    if B == 0:
        return out_agents, out_scores, False
    extra = ()
    if form == "staged":
        # one bulk copy a block where every slab is 16-byte aligned and sized
        bulk = (n * P) % 4 == 0 and agents.data_ptr() % 16 == 0
        extra = (*plan, int(bulk))
    elif form == "cluster":
        # a bulk copy a row where every CTA's row is 16-byte aligned and sized
        bulk = P % 4 == 0 and (P // plan[0]) % 4 == 0 and agents.data_ptr() % 16 == 0
        extra = (*plan, int(bulk), _mode)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher(objective, form)(
            agents.data_ptr(), scores.data_ptr(), active.data_ptr(),
            None if u is None else u.data_ptr(),
            None if fdim is None else fdim.data_ptr(),
            out_agents.data_ptr(), out_scores.data_ptr(),
            B, n, P, *offs, diff_weight, cross_prob,
            seed & _MASK32, generation & _MASK32, *extra, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    return out_agents, out_scores, True


def de_generation_staged(fn, agents, scores, offs, active, *, seed: int, generation: int,
                         cross_prob: float = 0.9, diff_weight: float = 0.8,
                         u: Optional[torch.Tensor] = None, fdim: Optional[torch.Tensor] = None):
    """K1's staged form: a block's instances staged in shared memory by one
    bulk copy, the proposal kept from the score pass.  CPU tensors run the
    twin; on a card it raises where one instance does not fit a block
    (``staged_plan``)."""
    out_agents, out_scores, launched = _launch(
        "staged", fn, agents, scores, offs, active, seed, generation, cross_prob, diff_weight,
        u, fdim)
    de_generation_staged.launches += launched
    return out_agents, out_scores


def de_generation_cluster(fn, agents, scores, offs, active, *, seed: int, generation: int,
                          cross_prob: float = 0.9, diff_weight: float = 0.8,
                          u: Optional[torch.Tensor] = None, fdim: Optional[torch.Tensor] = None,
                          _mode: int = 0):
    """K1's cluster form: one instance over a thread-block cluster of the
    CTAs ``cluster_plan`` names, each staging its agents' rows by bulk
    copies, the partners read through distributed shared memory, the
    proposal kept.  CPU tensors run the twin; on a card it raises where no
    cluster takes n and P.  ``_mode`` (for tests and probes): 1 leaves out
    the proposals, every agent kept; 2 reads each partner from the CTA's
    own slab (no distributed shared memory), a proposal no twin computes."""
    out_agents, out_scores, launched = _launch(
        "cluster", fn, agents, scores, offs, active, seed, generation, cross_prob, diff_weight,
        u, fdim, _mode)
    de_generation_cluster.launches += launched
    return out_agents, out_scores


def de_generation_global(fn, agents, scores, offs, active, *, seed: int, generation: int,
                         cross_prob: float = 0.9, diff_weight: float = 0.8,
                         u: Optional[torch.Tensor] = None, fdim: Optional[torch.Tensor] = None):
    """K1's device-memory form, any n and P <= 1024: the agents read through
    L1, an accepted proposal recomputed for its write-back.  CPU tensors run
    the twin."""
    out_agents, out_scores, launched = _launch(
        "global", fn, agents, scores, offs, active, seed, generation, cross_prob, diff_weight,
        u, fdim)
    de_generation_global.launches += launched
    return out_agents, out_scores


def de_generation_fused(
    fn,
    agents: torch.Tensor,                # [B, n, P]
    scores: torch.Tensor,                # [B, P]
    offs: Sequence[int],                 # 3 ring offsets in [1, P)
    active: torch.Tensor,                # [B] bool
    *,
    seed: int,
    generation: int,
    cross_prob: float = 0.9,
    diff_weight: float = 0.8,
    u: Optional[torch.Tensor] = None,    # [B, n, P]: injected uniforms
    fdim: Optional[torch.Tensor] = None,  # [B, P]: injected forced dims
):
    """One DE generation: mutation, crossover, objective, greedy select.

    Without ``u`` and ``fdim`` the draws come from Philox keyed by
    ``(seed, generation)``; with them (both or neither) the kernel reads
    them.  CPU tensors run the plain twin on the same draws; CUDA tensors
    launch the form ``generation_form`` names (float32 only), or raise."""
    _, n, P, offs = _check_common(agents, offs, u, fdim)
    if agents.device.type == "cpu":
        return _twin(fn, agents, scores, offs, active, seed, generation, cross_prob,
                     diff_weight, u, fdim)
    form = {"staged": de_generation_staged, "cluster": de_generation_cluster,
            "global": de_generation_global}[generation_form(n, P)]
    return form(fn, agents, scores, offs, active, seed=seed, generation=generation,
                cross_prob=cross_prob, diff_weight=diff_weight, u=u, fdim=fdim)


de_generation_staged.launches = 0
de_generation_cluster.launches = 0
de_generation_global.launches = 0
