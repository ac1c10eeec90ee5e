"""nlsolver_torch.utils against nlsolver_tpu.utils: the timing harness
(tests/test_utils.py:18-45 asked of the port), the NaN checker, the
compile log, the profiler trace, and checkpoints of a DE, a BFGS-fleet and
a CMA-ES-fleet state with their generator, resumed bit for bit."""
import ctypes
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import nlsolver_torch as nt
import nlsolver_tpu.utils as jutils
from nlsolver_torch import utils as tutils
from nlsolver_torch.ops import _build
from nlsolver_torch.solvers import bfgs_fleet, cmaes_fleet, de_batched

torch.set_num_threads(1)


def test_exports_match_jax_but_the_orbax_pair():
    want = set(jutils.__all__)
    assert set(tutils.__all__) - {"benchmark_versions"} == want
    assert not hasattr(tutils, "save_orbax")


def test_stopwatch(capsys):
    with tutils.Stopwatch("t") as sw:
        sum(range(1000))
    assert sw.elapsed_us > 0
    assert "[t] elapsed" in capsys.readouterr().out


def test_streaming_median_matches_jax_on_draws():
    draws = np.random.default_rng(4).standard_normal(10_000)
    mine, theirs = tutils.StreamingMedian(), jutils.StreamingMedian()
    for i, v in enumerate(draws.tolist()):
        mine.push(v)
        theirs.push(v)
        if i % 997 == 0:
            assert mine.median == theirs.median
    assert mine.median == theirs.median == float(np.median(draws))
    assert tutils.StreamingMedian().median == 0.0


def test_benchmark_and_benchmarker():
    f = lambda x: x * 2.0  # noqa: E731
    x = torch.ones(128)
    stats = tutils.benchmark(f, x, runs=3, warmup=1)
    assert stats["median_us"] > 0 and stats["runs"] == 3
    assert set(stats) == set(jutils.benchmark(lambda y: y, np.ones(2), runs=1, warmup=0))
    b = tutils.Benchmarker(runs=3, warmup=1)
    b.run("a", f, x)
    b.run("b", f, x)
    assert b.speedup("a", "b") > 0
    assert "median" in b.report()
    assert [f.name for f in dataclasses.fields(tutils.Benchmarker)] == \
        [f.name for f in dataclasses.fields(jutils.Benchmarker)]


def test_benchmark_versions():
    out = tutils.benchmark_versions({"slow": lambda x: x.sort().values, "fast": lambda x: x},
                                    torch.rand(1000), runs=2, warmup=0)
    assert out["baseline"] == "slow" and out["speedup"]["slow"] == 1.0
    assert set(out["results"]) == {"slow", "fast"}
    with pytest.raises(ValueError):
        tutils.benchmark_versions({})


def test_fence_reads_only_a_card():
    out = {"a": (torch.zeros(2), [torch.ones(1)])}
    assert tutils.timing.fence(out) is out
    assert not tutils.timing._on_card(out)


def test_debug_nans_raises_at_the_first_nan_and_is_silent_otherwise():
    with tutils.debug_nans(True):
        x = torch.tensor([1.0, 4.0])
        assert torch.equal(torch.sqrt(x), torch.tensor([1.0, 2.0]))
        res = nt.minimize(lambda p: ((p - 1.0) ** 2).sum(), torch.zeros(2, 3, dtype=torch.float64),
                          method="bfgs", layout="fleet")
        assert float(res.f_value.max()) < 1e-6
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(torch.tensor([-1.0]))
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()   # off outside the block
    with tutils.debug_nans(False):
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


def test_log_compiles_logs_the_library_build_and_load(monkeypatch, tmp_path, capsys):
    lib = tmp_path / "lib_test.so"
    monkeypatch.setattr(_build, "ensure_built", lambda: (lib, ""))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    _build.load_library.cache_clear()
    try:
        with tutils.log_compiles(True):
            assert _build.load_library() == str(lib)
        assert f"loaded {lib}" in capsys.readouterr().err
        _build.load_library.cache_clear()
        _build.load_library()
        assert "loaded" not in capsys.readouterr().err
    finally:
        _build.load_library.cache_clear()
    assert _build.LOG.level == 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tutils.trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0


def _fields_equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
        else:
            assert x == y


def _resume(tmp_path, make, step, k=5, with_generator=True):
    """``k`` steps, a checkpoint, ``k`` more: the run from the file equals
    the run that went on, bit for bit, generator and all."""
    state, gen = make()
    for _ in range(k):
        state = step(state, gen)
    path = str(tmp_path / "ckpt.npz")
    tutils.save(path, state, gen if with_generator else None)
    went_on = state
    for _ in range(k):
        went_on = step(went_on, gen)
    like, fresh = make()
    fresh.manual_seed(12345)          # another stream until the file sets it
    restored = tutils.load(path, like, fresh if with_generator else None)
    _fields_equal(restored, state)
    for _ in range(k):
        restored = step(restored, fresh)
    _fields_equal(restored, went_on)
    return went_on


def test_checkpoint_resumes_a_de_fleet(tmp_path):
    fn = nt.PROBLEMS["rastrigin"].fn
    cfg = nt.DEConfig(pop_size=12, partner_sampling="uniform")

    def make():
        gen = torch.Generator().manual_seed(7)
        x0 = torch.linspace(0.5, 2.0, 12, dtype=torch.float64).reshape(4, 3)
        return de_batched.init(fn, x0, cfg, generator=gen, seed=7), gen

    final = _resume(tmp_path, make, lambda s, g: de_batched.step(fn, s, cfg, generator=g))
    assert final.generation == 10


def test_checkpoint_resumes_a_bfgs_fleet(tmp_path):
    cols = lambda X: (torch.arange(1.0, 4.0, dtype=X.dtype)[:, None] * (X - 0.3) ** 2).sum(0)  # noqa
    cfg = nt.BFGSFleetConfig(grad_eps=1e-10)

    def make():
        X0 = torch.linspace(-1.0, 1.0, 15, dtype=torch.float64).reshape(3, 5)
        return bfgs_fleet.init(cols, X0, cfg), torch.Generator()

    _resume(tmp_path, make, lambda s, g: bfgs_fleet.step(cols, s, cfg), k=3,
            with_generator=False)


def test_checkpoint_resumes_a_cmaes_fleet_with_its_generator(tmp_path):
    fn = nt.PROBLEMS["rastrigin"].fn
    cfg = nt.CMAESFleetConfig(eigen_interval=2, defer_covariance=True)

    def make():
        X0 = torch.linspace(-2.0, 2.0, 12, dtype=torch.float32).reshape(3, 4)
        return cmaes_fleet.init(fn, X0, cfg), torch.Generator().manual_seed(3)

    final = _resume(tmp_path, make, lambda s, g: cmaes_fleet.step(fn, s, cfg, generator=g))
    assert final.gen == 10 and 0 < final.filled <= cfg.eigen_interval


def test_load_refuses_a_file_without_a_generator(tmp_path):
    path = str(tmp_path / "plain.npz")
    state = {"a": torch.ones(2, dtype=torch.bfloat16), "n": 3, "none": None}
    tutils.save(path, state)
    back = tutils.load(path, {"a": torch.zeros(2, dtype=torch.bfloat16), "n": 0, "none": None})
    assert torch.equal(back["a"], state["a"]) and back["n"] == 3 and back["none"] is None
    with pytest.raises(ValueError, match="no generator"):
        tutils.load(path, state, torch.Generator())
