"""The progress hook (nlsolver_torch.core.driver.attach_progress) against the
JAX package's (nlsolver_tpu/core/driver.py:84-130, its io_callback): the
batched DE fleet on the JAX fleet's own draws (its ring offsets and
uniforms, read from its states as it steps) reports the same
``(iteration, best, active)`` sequence, ``best`` within 1e-12, on the plain
step and on the kernel's step (its plain twin here on the CPU); a run with
the hook gives the run without it; the filter and its duplicate
suppression as the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_de_batched import jax_init_draws, jax_step_draws

import nlsolver_torch as nt
from nlsolver_torch.core import driver as tdriver
from nlsolver_torch.solvers import de_batched as tdeb
from nlsolver_torch.solvers._lane import Draws
from nlsolver_torch.solvers.de import DEConfig as TConfig
from nlsolver_tpu.core import driver as jdriver
from nlsolver_tpu.problems import PROBLEMS as JP
from nlsolver_tpu.solvers import de_batched as jdeb
from nlsolver_tpu.solvers.de import DEConfig as JConfig

torch.set_num_threads(1)
B, N, P = 8, 3, 12
KW = dict(pop_size=P, partner_sampling="rotation", eps=1e-3, max_iter=40)
EVERY = 5


def _recorder():
    calls = []

    def progress(iteration, best, active):
        calls.append((iteration, best, active))

    return calls, progress


@pytest.fixture(scope="module")
def jax_run():
    """The JAX fleet's reports, result and the draws of every generation."""
    x0 = np.random.default_rng(6).uniform(0.2, 3.0, (B, N))
    cfg = JConfig(**KW)
    fn = JP["sphere"].fn
    keys = jax.random.split(jax.random.key(9), B)
    calls, progress = _recorder()
    res = jax.jit(lambda x, k: jdeb.minimize_batched(
        fn, x, cfg, keys=k, progress=progress, progress_every=EVERY))(jnp.asarray(x0), keys)
    jax.block_until_ready(res.x)
    state = jdeb.init(fn, jnp.asarray(x0), cfg, keys)
    step = jax.jit(lambda s: jdeb.step(fn, s, cfg))
    steps = []
    for _ in range(cfg.max_iter + 1):
        steps.append(jax_step_draws(state, cfg))
        state = step(state)
    u0 = torch.tensor(jax_init_draws(keys, N, P, jnp.float64))
    return x0, calls, res, Draws(u0, steps)


def _port(x0, draws, fused, **kw):
    cfg = TConfig(use_fused_kernel=fused, **KW)
    return tdeb.minimize_batched(nt.PROBLEMS["sphere"].fn, torch.from_numpy(x0), cfg,
                                 draws=draws, **kw)


@pytest.mark.parametrize("fused", [False, True])
def test_reports_equal_the_jax_hook(jax_run, fused):
    x0, want, jres, draws = jax_run
    got, progress = _recorder()
    res = _port(x0, draws, fused, progress=progress, progress_every=EVERY)
    assert [(it, act) for it, _, act in got] == [(it, act) for it, _, act in want]
    np.testing.assert_allclose([b for _, b, _ in got], [b for _, b, _ in want], rtol=1e-12)
    # the last lane stops at max_iter: its halting step repeats iteration 40,
    # which was reported already, as the JAX hook suppresses it
    assert len(got) >= 3 and got[-1][0] == KW["max_iter"]
    # lanes stop at different generations, so active falls in steps
    assert len({act for _, _, act in got}) > 2
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_allclose(res.f_value.numpy(), np.asarray(jres.f_value), rtol=1e-12)


def test_silent_run_is_the_same_and_reads_nothing_more(jax_run, monkeypatch):
    x0, _, _, draws = jax_run
    reads = [0]
    payload = tdriver._progress_payload

    def counted(state):
        reads[0] += 1
        return payload(state)

    monkeypatch.setattr(tdriver, "_progress_payload", counted)
    silent = _port(x0, draws, False)
    assert reads[0] == 0
    calls, progress = _recorder()
    loud = _port(x0, draws, False, progress=progress, progress_every=EVERY)
    assert reads[0] > 0 and calls
    for a, b in zip(silent, loud):
        assert torch.equal(a, b)


def test_progress_fires_on_repeat_runs_with_one_hook(jax_run):
    x0, want, _, draws = jax_run
    calls, progress = _recorder()
    _port(x0, draws, False, progress=progress, progress_every=EVERY)
    first = len(calls)
    _port(x0, draws, False, progress=progress, progress_every=EVERY)
    assert first == len(want) and len(calls) == 2 * first


@pytest.mark.parametrize("stream", [
    [(5, 1.0, 3), (5, 1.0, 3), (7, 0.5, 2), (10, 0.25, 1), (12, 0.125, 0), (12, 0.125, 0),
     (3, 2.0, 4), (5, 1.5, 4)],
])
def test_host_filter_matches_jax(stream):
    """The filter on a stream of payloads, a restart among them."""
    got, want = [], []
    mine = tdriver._wrap_progress(lambda **k: got.append(tuple(k.values())), 5)
    theirs = jdriver._wrap_progress(lambda **k: want.append(tuple(k.values())), 5)
    for it, best, active in stream:
        mine(it, best, active)
        theirs(np.int32(it), np.float32(best), np.int32(active))
    assert got == want


def test_drive_reports_through_the_generic_driver():
    """``core.drive`` on any state with ``iteration``, ``done`` and a value
    field: a countdown that stops lane b at step b + 1."""
    from typing import NamedTuple

    class S(NamedTuple):
        f_value: torch.Tensor
        iteration: torch.Tensor
        done: torch.Tensor

    def step(s):
        it = s.iteration + 1
        return S(s.f_value - 1.0, it, it >= torch.arange(1, 5))

    calls, progress = _recorder()
    init = S(torch.full((4,), 10.0), torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=bool))
    out = tdriver.drive(step, init, check_every=3, progress=progress, progress_every=2)
    assert out.iteration.tolist() == [1, 2, 3, 4]
    assert calls == [(2, 8.0, 2), (4, 6.0, 0)]
