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
    forms = (tdf.de_generation_staged, tdf.de_generation_cluster, tdf.de_generation_global)
    before = [f.launches for f in forms]
    pu, pf = tdf.philox_draws(3, 4, B, N, P, agents.dtype, "cpu")
    for wrapper in (tdf.de_generation_fused,) + forms:
        got = wrapper(fn, agents, scores, (1, 6, 11), active, seed=3, generation=4, u=u, fdim=fdim)
        want = tdf.de_generation_reference(fn, agents, scores, (1, 6, 11), u, fdim, active,
                                           0.8, 0.9)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # without injected draws the CPU route replays the kernel's Philox draws
        got = wrapper(fn, agents, scores, (1, 6, 11), active, seed=3, generation=4)
        want = tdf.de_generation_reference(fn, agents, scores, (1, 6, 11), pu, pf, active,
                                           0.8, 0.9)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # the twin is not a launch
    assert [f.launches for f in forms] == before


def test_staged_plan():
    # the headline's 4 instances of 10 x 64 agents a block; 16 x 1024 fits one
    # instance's slab; past n = 16 the proposals take as much again
    assert tdf.staged_plan(10, 64) == (4, 10 * 64 * 4 * 4)
    assert tdf.staged_plan(16, 64) == (4, 16 * 64 * 4 * 4)
    assert tdf.staged_plan(17, 64) == (4, 17 * 64 * 4 * 4 * 2)
    assert tdf.staged_plan(16, 1024) == (1, 16 * 1024 * 4)
    assert tdf.staged_plan(28, 1024) == (1, 28 * 1024 * 4 * 2)
    assert tdf.staged_plan(29, 1024) is None and tdf.staged_plan(60, 1024) is None
    assert tdf.staged_plan(3, 7) == (36, 36 * 3 * 7 * 4)
    assert tdf.staged_plan(10, 1025) is None
    # every plan fits a block: its threads and its shared memory
    for n in range(1, 300, 7):
        for p in (4, 7, 64, 100, 256, 1000):
            plan = tdf.staged_plan(n, p)
            if plan is not None:
                assert plan[0] * p <= 1024 and plan[1] <= tdf.STAGED_SMEM


def test_cluster_plan():
    # the fewest CTAs of at most 128 agents each whose slab and proposals
    # (2 n P / C floats) fit a CTA: 8 at the wide fleet's shape and up to n
    # = 226 at P = 1024, 16 up to 453, none beyond
    assert (tdf.CLUSTER_SIZES, tdf.CLUSTER_AGENTS) == ((2, 4, 8, 16), 128)
    assert tdf.cluster_plan(29, 1024) == (8, 2 * 29 * 128 * 4)
    assert tdf.cluster_plan(226, 1024) == (8, 231424)
    assert tdf.cluster_plan(227, 1024) == (16, 2 * 227 * 64 * 4)
    assert tdf.cluster_plan(453, 1024) == (16, 231936)
    assert tdf.cluster_plan(454, 1024) is None and tdf.cluster_plan(10, 1025) is None
    assert tdf.cluster_plan(57, 512) == (4, 2 * 57 * 128 * 4)
    assert tdf.cluster_plan(114, 256) == (2, 2 * 114 * 128 * 4)
    # no size of at most 128 agents divides P = 1022: the fewest CTAs that fit
    assert tdf.cluster_plan(40, 1022) == (2, 2 * 40 * 511 * 4)
    assert tdf.cluster_plan(200, 1022) is None
    for n in range(1, 500, 11):
        for p in (7, 64, 100, 256, 1000, 1022, 1024):
            plan = tdf.cluster_plan(n, p)
            if plan is not None:
                assert p % plan[0] == 0 and plan[1] == 2 * n * (p // plan[0]) * 4
                assert plan[1] <= tdf.STAGED_SMEM and p // plan[0] <= 1024


def test_generation_form_hands_over():
    # the staged form while one instance fits a block, the cluster form
    # while it fits a cluster, the global form beyond
    forms = [tdf.generation_form(n, 1024) for n in range(1, 500)]
    assert forms == ["staged"] * 28 + ["cluster"] * (453 - 28) + ["global"] * (499 - 453)
    forms = [tdf.generation_form(n, 64) for n in range(1, 800)]
    assert forms == ["staged"] * 453 + ["cluster"] * (799 - 453)
    assert tdf.generation_form(10, 64) == "staged" and tdf.generation_form(29, 1022) == "cluster"


def cluster_emulation(fn, agents, scores, offs, u, fdim, active, F, CR, size):
    """K1c's partition in plain torch ops: CTA k of a cluster of ``size``
    holds the agents k P / C .. (k + 1) P / C - 1 of each instance in its
    own slab; agent p's partner (p + o) % P is read from the slab of its
    owner, CTA q // (P / C), at the owner's column q % (P / C); each
    coordinate mutates where u < CR or d is the forced dimension."""
    B, n, P = agents.shape
    cols = P // size
    slabs = [agents[:, :, k * cols:(k + 1) * cols].clone() for k in range(size)]
    p = torch.arange(P)
    dims = torch.arange(n)[None, :, None]
    partners = []
    for o in offs:
        q = (p + o) % P
        owner, col = q // cols, q % cols
        partners.append(torch.stack([slabs[int(w)][:, :, int(c)] for w, c in zip(owner, col)],
                                    dim=2))
    a1, a2, a3 = partners
    own = torch.cat(slabs, dim=2)
    mutate = (u < CR) | (dims == fdim[:, None, :])
    prop = torch.where(mutate, a1 + F * (a2 - a3), own)
    prop_scores = tdf.eval_columns(fn, prop)
    accept = (prop_scores < scores) & active[:, None]
    return torch.where(accept[:, None, :], prop, own), torch.where(accept, prop_scores, scores)


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("problem", ["rastrigin", "sphere"])
def test_cluster_partition_equals_twin(problem, size):
    """K1c's partition (owner CTA and local column of each partner) gives
    the twin's agents and scores bit for bit, every proposal accepted and
    with the fleet's own scores, on each cluster size."""
    fn = nt.PROBLEMS[problem].fn
    agents, scores, active, u, fdim = _fleet(9, b=5, n=7, p=32)
    offs = (3, 17, 30)
    inf = torch.full_like(scores, float("inf"))
    for s in (scores, inf):
        got = cluster_emulation(fn, agents, s, offs, u, fdim, active, 0.8, 0.9, size)
        want = tdf.de_generation_reference(fn, agents, s, offs, u, fdim, active, 0.8, 0.9)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("problem", ["rastrigin", "sphere"])
def test_cluster_partition_equals_jax_rotation_step(problem):
    """K1c's partition on JAX's own draws and offsets, over clusters of 2
    and 4, against the JAX engine's XLA rotation step, as the twin is held
    (``test_reference_equals_jax_rotation_step``)."""
    import jax
    import jax.numpy as jnp
    from nlsolver_tpu.problems import PROBLEMS as JP
    from nlsolver_tpu.solvers import de_batched as jdeb

    frozen = np.arange(B) % 3 == 0
    j, cfg = _jax_fleet(problem, frozen)
    split = jax.vmap(lambda k: jax.random.split(k, 4))(j.keys)
    u = jax.vmap(lambda k: jax.random.uniform(k, (N, P), dtype=jnp.float64))(split[:, 2])
    fdim = jax.vmap(lambda k: jax.random.randint(k, (P,), 0, N))(split[:, 1])
    third = P // 3
    ko = jax.random.fold_in(j.keys[0], j.iteration[0])
    offs = [int(jax.random.randint(jax.random.fold_in(ko, i), (), lo, hi))
            for i, (lo, hi) in enumerate(((1, third + 1), (third + 1, 2 * third + 1),
                                          (2 * third + 1, P)), 1)]
    new = jdeb.step(JP[problem].fn, j, cfg)
    active = torch.tensor(~np.asarray(new.done))
    for size in (2, 4):
        agents, scores = cluster_emulation(
            nt.PROBLEMS[problem].fn, torch.tensor(np.asarray(j.agents)),
            torch.tensor(np.asarray(j.scores)), offs, torch.tensor(np.asarray(u)),
            torch.tensor(np.asarray(fdim)), active, cfg.differential_weight, cfg.crossover_prob,
            size)
        np.testing.assert_allclose(agents.numpy(), np.asarray(new.agents), rtol=RTOL)
        np.testing.assert_allclose(scores.numpy(), np.asarray(new.scores), rtol=RTOL)
        np.testing.assert_array_equal(agents.numpy()[frozen], np.asarray(j.agents)[frozen])


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


def test_philox_product_is_the_exact_one():
    """The twin's 32x32 -> 64-bit product, one int64 multiply that wraps
    modulo 2^64, gives the exact high and low words (Python's integers) of
    both Philox multipliers, at the ends of the word's range and between."""
    rng = np.random.default_rng(5)
    words = [0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    words += [int(w) for w in rng.integers(0, 1 << 32, 4096, dtype=np.uint64)]
    c = torch.tensor(words, dtype=torch.int64)
    for m in tdf._PHILOX_M:
        hi, lo = tdf._mulhilo(m, c)
        assert hi.tolist() == [w * m >> 32 for w in words]
        assert lo.tolist() == [w * m & 0xFFFFFFFF for w in words]


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


# (n, P, b): the staged form with the proposal in registers (n = 10, 16), in
# shared memory (n = 17, and P = 1024 at n = 28, its last fit), staged by
# plain loads (n * P = 21 is no multiple of 4); the cluster form past it
# (n = 29, P = 1024 on 8 CTAs, the wide fleet's, to 226; on 16 from 227 to
# 453; 4 CTAs at P = 512, 2 at P = 256; P = 1022 on 2, whose CTAs' rows
# are no multiple of 16 bytes, staged by plain loads); the global form past
# the cluster form (n = 454, P = 1024)
FORM_SHAPES = [(10, 64, 257), (16, 64, 33), (17, 64, 33), (28, 1024, 3), (3, 7, 101),
               (29, 1024, 3), (226, 1024, 2), (227, 1024, 2), (453, 1024, 2), (57, 512, 3),
               (114, 256, 5), (40, 1022, 3), (454, 1024, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["rastrigin", "sphere"])
@pytest.mark.parametrize("n,p,b", FORM_SHAPES)
def test_forms_match_twin_on_card(problem, n, p, b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_de_fused.py)")
    fn = nt.PROBLEMS[problem].fn
    agents, scores, active, u, fdim = _fleet(5, torch.float32, "cuda", b=b, n=n, p=p)
    offs = (1, p // 3 + 1, p - 1) if p > 3 else (1, 2, 2)
    want = tdf.de_generation_reference(fn, agents, scores, offs, u, fdim, active, 0.8, 0.9)
    form = tdf.generation_form(n, p)
    forms = [tdf.de_generation_global] + ([] if form == "global" else
                                          [getattr(tdf, f"de_generation_{form}")])
    chosen = forms[-1]
    before = chosen.launches
    outs = [tdf.de_generation_fused(fn, agents, scores, offs, active, seed=1, generation=2,
                                    u=u, fdim=fdim)]
    assert chosen.launches == before + 1  # the dispatcher's choice
    outs += [f(fn, agents, scores, offs, active, seed=1, generation=2, u=u, fdim=fdim)
             for f in forms]
    torch.cuda.synchronize()
    inf = torch.full_like(scores, float("inf"))
    for got in outs:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
        same = ((got[1] < scores) == (want[1] < scores))[:, None, :].expand_as(agents)
        assert torch.equal(got[0][same], want[0][same])
        assert torch.equal(got[0][~active], agents[~active])
    # every proposal accepted: the proposals themselves bit-equal, and the
    # two forms equal on the Philox draws too
    all_in = [f(fn, agents, inf, offs, torch.ones_like(active), seed=1, generation=2, u=u,
                fdim=fdim)[0] for f in forms]
    want_all = tdf.de_generation_reference(fn, agents, inf, offs, u, fdim,
                                           torch.ones_like(active), 0.8, 0.9)[0]
    assert all(torch.equal(a, want_all) for a in all_in)
    philox = [f(fn, agents, scores, offs, active, seed=5, generation=7) for f in forms]
    assert all(torch.equal(x[0], philox[0][0]) and torch.equal(x[1], philox[0][1])
               for x in philox)


def test_issue_floor_takes_the_cheaper_arm_and_counts_the_hot_loop():
    from nlsolver_torch.benches import issue_instructions

    # entry (2), an early exit not taken, a branch around a slow arm of 3,
    # a loop of 4 (the hot one), a loop of 2, the end
    sass = ["S2R R0, SR_TID.X", "ISETP.GE.AND P0, PT, R0, c[0x0][0x170], PT", "@P0 EXIT",
            "@P1 BRA 0x70", "FADD R1, R1, R2", "FMUL R1, R1, R2", "CALL.REL.NOINC 0x200",
            "FADD R3, R1, R1", "FMUL R3, R3, R3", "IADD3 R4, R4, 0x1, RZ", "@P2 BRA 0x70",
            "MOV R5, R3", "@P3 BRA 0xb0", "STG.E [R6.64], R3", "EXIT"]
    ins = [(16 * i, op) for i, op in enumerate(sass)]
    way, bodies = issue_instructions(ins)
    # the fewest: 3 + the branch, one pass of each loop, 2; a pass of each
    # loop alone
    assert (way, bodies) == (4 + 4 + 2 + 2, [4, 2])
    # 5 passes of the hot loop (4 backward branches) and one of the other
    assert way + 4 * bodies[0] + 0 * bodies[1] == 4 + 5 * 4 + 2 + 2
    # a slow path placed after the exit that jumps back (a wait's retry):
    # a way through it counts its instructions, and its jump back is no loop
    # that the code after the jump's target leads into
    sass = ["@!P0 BRA 0x40", "FADD R1, R1, R2", "FMUL R1, R1, R2", "EXIT",
            "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R0], RZ", "@!P0 BRA 0x40", "BRA 0x10"]
    ins = [(16 * i, op) for i, op in enumerate(sass)]
    assert issue_instructions(ins) == (4, [2, None])


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,b", [(29, 1024, 256), (453, 1024, 3)])
def test_cluster_form_bit_equal_to_twin_on_card(n, p, b):
    """K1c at the wide fleet's [256, 29, 1024] and at the last n its largest
    cluster takes: proposals and scores bit-equal to the twin's on injected
    draws and on the Python Philox draws (every proposal accepted, so the
    agents out are the proposals), and bit-equal to K1g."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_de_fused.py)")
    fn = nt.PROBLEMS["rastrigin"].fn
    agents, scores, active, u, fdim = _fleet(6, torch.float32, "cuda", b=b, n=n, p=p)
    fdim = fdim.to(torch.int32)
    every = torch.ones_like(active)
    inf = torch.full_like(scores, float("inf"))
    offs = (5, p // 2 - 2, p - 14)
    pu, pf = tdf.philox_draws(9, 4, b, n, p, torch.float32, "cuda")
    for draws, (uu, ff) in (({"u": u, "fdim": fdim}, (u, fdim)), ({}, (pu, pf))):
        before = tdf.de_generation_cluster.launches
        got = tdf.de_generation_cluster(fn, agents, inf, offs, every, seed=9, generation=4, **draws)
        assert tdf.de_generation_cluster.launches == before + 1
        twin = tdf.de_generation_reference(fn, agents, inf, offs, uu, ff, every, 0.8, 0.9)
        glob = tdf.de_generation_global(fn, agents, inf, offs, every, seed=9, generation=4, **draws)
        torch.cuda.synchronize()
        assert torch.equal(got[0], twin[0]) and torch.equal(got[0], glob[0])
        assert torch.equal(got[1], glob[1])
        torch.testing.assert_close(got[1], twin[1], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [2, 4, 8, 16])
def test_cluster_form_every_size_on_card(size, monkeypatch):
    """Each cluster size at n = 29, P = 1024 (the plan's is 8): the same
    agents and scores as K1g, bit for bit, on Philox draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_de_fused.py)")
    fn = nt.PROBLEMS["rastrigin"].fn
    agents, scores, active, _, _ = _fleet(7, torch.float32, "cuda", b=64, n=29, p=1024)
    monkeypatch.setattr(tdf, "CLUSTER_SIZES", (size,))
    assert tdf.cluster_plan(29, 1024)[0] == size
    got = tdf.de_generation_cluster(fn, agents, scores, (5, 510, 1010), active, seed=3,
                                    generation=1)
    want = tdf.de_generation_global(fn, agents, scores, (5, 510, 1010), active, seed=3,
                                    generation=1)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cluster_form_refuses_what_it_does_not_take_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: pytest -m gpu tests/test_torch_de_fused.py)")
    fn = nt.PROBLEMS["rastrigin"].fn
    agents, scores, active, _, _ = _fleet(8, torch.float32, "cuda", b=2, n=454, p=1024)
    with pytest.raises(ValueError, match="does not fit the shared memory of a cluster"):
        tdf.de_generation_cluster(fn, agents, scores, (5, 510, 1010), active, seed=0,
                                  generation=0)
