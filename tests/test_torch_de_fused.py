"""The fused DE generation of nlsolver_torch: its plain twin against the JAX
engine's XLA rotation step (the JAX kernel has no CPU lowering, so that
step is its reference), the wrapper's CPU route, the Philox twin, the build
command, and the CUDA kernel against its twin (on a card only).

JAX is imported only inside the tests that compare with it, so that the
card's test runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_de_fused.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import nlsolver_torch as nt
from nlsolver_torch.ops import _build
from nlsolver_torch.ops import de_fused as tdf

torch.set_num_threads(1)
RTOL = 1e-12
B, N, P = 10, 4, 16


def _jax_fleet(problem, frozen):
    import jax
    import jax.numpy as jnp
    from nlsolver_tpu.problems import PROBLEMS as JP
    from nlsolver_tpu.solvers import de_batched as jdeb
    from nlsolver_tpu.solvers.de import DEConfig as JConfig

    cfg = JConfig(pop_size=P, partner_sampling="rotation", eps=0.0,
                  best_value_no_change=1 << 30)
    x0 = np.random.default_rng(0).uniform(0.5, 3.0, (B, N))
    state = jdeb.init(JP[problem].fn, jnp.asarray(x0), cfg,
                      jax.random.split(jax.random.key(1), B))
    return state._replace(done=jnp.asarray(frozen)), cfg


@pytest.mark.parametrize("problem", ["rastrigin", "sphere"])
def test_reference_equals_jax_rotation_step(problem):
    import jax
    import jax.numpy as jnp
    from nlsolver_tpu.problems import PROBLEMS as JP
    from nlsolver_tpu.solvers import de_batched as jdeb

    frozen = np.arange(B) % 3 == 0
    j, cfg = _jax_fleet(problem, frozen)
    # the draws of JAX's step (de_batched.py:98,123-124,141-146)
    split = jax.vmap(lambda k: jax.random.split(k, 4))(j.keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (N, P), dtype=jnp.float64))(split[:, 2])
    fdim = jax.vmap(lambda k: jax.random.randint(k, (P,), 0, N))(split[:, 1])
    third = P // 3
    ko = jax.random.fold_in(j.keys[0], j.iteration[0])
    offs = [int(jax.random.randint(jax.random.fold_in(ko, i), (), lo, hi))
            for i, (lo, hi) in enumerate(((1, third + 1), (third + 1, 2 * third + 1),
                                          (2 * third + 1, P)), 1)]
    new = jdeb.step(JP[problem].fn, j, cfg)
    active = ~np.asarray(new.done)
    assert active.any() and not active.all()

    agents, scores = tdf.de_generation_reference(
        nt.PROBLEMS[problem].fn, torch.tensor(np.asarray(j.agents)),
        torch.tensor(np.asarray(j.scores)), offs, torch.tensor(np.asarray(u)),
        torch.tensor(np.asarray(fdim)), torch.tensor(active), cfg.differential_weight,
        cfg.crossover_prob,
    )
    np.testing.assert_allclose(agents.numpy(), np.asarray(new.agents), rtol=RTOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(new.scores), rtol=RTOL)
    # frozen lanes unchanged bit for bit, and some proposals accepted
    np.testing.assert_array_equal(agents.numpy()[frozen], np.asarray(j.agents)[frozen])
    assert (scores.numpy() < np.asarray(j.scores)).any()


def _fleet(seed, dtype=torch.float64, device="cpu", b=B, n=N, p=P):
    rng = np.random.default_rng(seed)
    agents = torch.tensor(rng.uniform(-2, 2, (b, n, p)), dtype=dtype, device=device)
    scores = nt.PROBLEMS["rastrigin"].fn(agents.transpose(1, 2))
    active = torch.tensor(np.arange(b) % 3 != 0, device=device)
    u = torch.tensor(rng.random((b, n, p)), dtype=dtype, device=device)
    fdim = torch.tensor(rng.integers(0, n, (b, p)), device=device)
    return agents, scores, active, u, fdim


def test_wrapper_on_cpu_runs_the_twin():
    agents, scores, active, u, fdim = _fleet(2)
    fn = nt.PROBLEMS["rastrigin"].fn
    before = tdf.de_generation_fused.launches
    got = tdf.de_generation_fused(fn, agents, scores, (1, 6, 11), active,
                                  seed=3, generation=4, u=u, fdim=fdim)
    want = tdf.de_generation_reference(fn, agents, scores, (1, 6, 11), u, fdim, active, 0.8, 0.9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # without injected draws the CPU route replays the kernel's Philox draws
    pu, pf = tdf.philox_draws(3, 4, B, N, P, agents.dtype, "cpu")
    got = tdf.de_generation_fused(fn, agents, scores, (1, 6, 11), active, seed=3, generation=4)
    want = tdf.de_generation_reference(fn, agents, scores, (1, 6, 11), pu, pf, active, 0.8, 0.9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the twin is not a launch
    assert tdf.de_generation_fused.launches == before


def test_wrapper_rejects_bad_input():
    agents, scores, active, u, fdim = _fleet(3)
    fn = nt.PROBLEMS["sphere"].fn
    with pytest.raises(ValueError, match="offs"):
        tdf.de_generation_fused(fn, agents, scores, (0, 6, 11), active, seed=0, generation=0)
    with pytest.raises(ValueError, match="together"):
        tdf.de_generation_fused(fn, agents, scores, (1, 6, 11), active, seed=0,
                                generation=0, u=u)
    with pytest.raises(ValueError, match="agents"):
        tdf.de_generation_fused(fn, agents[0], scores, (1, 6, 11), active, seed=0, generation=0)


def test_philox_known_answers():
    # Random123's known-answer vectors for Philox4x32-10
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        got = tdf.philox4x32_10([torch.tensor([c]) for c in ctr], *key)
        assert [int(w) for w in got] == list(want)


def test_philox_draws_statistics():
    u, fdim = tdf.philox_draws(7, 0, 64, 10, 64, torch.float32, "cpu")
    assert u.shape == (64, 10, 64) and fdim.shape == (64, 64)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert set(fdim.unique().tolist()) == set(range(10))
    u2, _ = tdf.philox_draws(7, 1, 64, 10, 64, torch.float32, "cpu")
    assert not torch.equal(u, u2)


def test_build_command_targets_hopper():
    cmd = _build.nvcc_command("nvcc", _build.sources(), Path("out.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--use_fast_math" not in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    names = {p.name for p in _build.sources()}
    assert {"de_fused.cu", "qr_wavefront.cu", "smallchol.cu"} <= names
    assert len(_build.source_digest()) == 16
    obj = _build.nvcc_command("nvcc", _build.sources()[:1], Path("a.o"), compile_only=True)
    assert "-c" in obj and "-shared" not in obj and "arch=compute_90a,code=sm_90a" in obj


FAKE_NVCC = """#!{python}
import sys
with open({log!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "w").write("built")
"""


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    import sys

    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    path, _ = _build.ensure_built()
    calls = log.read_text().splitlines()
    srcs = _build.sources()
    assert len(calls) == len(srcs) + 1                  # one compile per source, one link
    assert all("-c" in c.split() for c in calls[:-1]) and "-shared" in calls[-1].split()
    assert {c.split()[-1] for c in calls[:-1]} == {str(s) for s in srcs}
    assert path.read_text() == "built" and path.name == f"lib_{_build.source_digest()}.so"
    assert sorted(p.name for p in path.parent.iterdir()) == [path.name]  # objects removed
    assert _build.ensure_built() == (path, "")          # built once per source digest


def test_find_nvcc_order(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(fake)


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["rastrigin", "sphere"])
def test_kernel_matches_twin_on_card(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_de_fused.py)")
    fn = nt.PROBLEMS[problem].fn
    agents, scores, active, u, fdim = _fleet(4, torch.float32, "cuda", b=257, n=10, p=64)
    offs = (3, 25, 50)
    got = tdf.de_generation_fused(fn, agents, scores, offs, active, seed=1, generation=2,
                                  u=u, fdim=fdim)
    torch.cuda.synchronize()
    want = tdf.de_generation_reference(fn, agents, scores, offs, u, fdim, active, 0.8, 0.9)
    # scores: the same terms summed in another order
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    # where both made the same choice, the agents are bit-equal
    same = ((got[1] < scores) == (want[1] < scores))[:, None, :].expand_as(agents)
    assert torch.equal(got[0][same], want[0][same])
    assert torch.equal(got[0][~active], agents[~active])
