"""nlsolver_torch.parallel.distributed and mesh in this process: the launch
helpers against the JAX package's (tests/test_distributed.py:101-115) and
the one-rank world that ``make_mesh`` builds for itself.  Worlds of 2 and 4
ranks joined by ``distributed.initialize`` are in tests/test_torch_parallel.py.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import nlsolver_torch as nt
from nlsolver_torch.parallel import DP_AXIS, POP_AXIS, distributed, mesh as tmesh
from nlsolver_tpu.parallel import make_mesh as jax_make_mesh
from nlsolver_tpu.parallel import mesh as jmesh

torch.set_num_threads(1)


@pytest.fixture
def no_launcher(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_without_a_launcher_stays_local(no_launcher):
    distributed.initialize()
    assert not dist.is_initialized()
    assert distributed.process_slice(8) == (0, 8)


@pytest.mark.parametrize("kwargs", [
    dict(backend="gloo", world_size=1, rank=3, store="hash"),
    dict(backend="gloo", init_method="env://", world_size=2, rank=0),
])
def test_initialize_propagates_explicit_errors(no_launcher, kwargs):
    """A rank outside the world, and env:// with no launcher's environment."""
    if kwargs.get("store") == "hash":
        kwargs = dict(kwargs, store=dist.HashStore())
    with pytest.raises((ValueError, RuntimeError)):
        distributed.initialize(**kwargs)
    assert not dist.is_initialized()


def test_one_rank_world_needs_no_launcher(no_launcher):
    mesh = tmesh.make_mesh(device_type="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == (DP_AXIS, POP_AXIS) and tuple(mesh.shape) == (1, 1)
    assert tmesh.coordinate(mesh) == (0, 0)
    assert distributed.process_slice(6) == (0, 6)
    assert tuple(distributed.global_mesh(device_type="cpu").shape) == (1, 1)
    # a second mesh joins the group the first made
    res = nt.minimize(lambda x: (x ** 2).sum(), torch.full((2, 4), 0.5, dtype=torch.float64),
                      method="bfgs", layout="sharded",
                      mesh=tmesh.make_mesh(1, dp=1, pop=1, device_type="cpu"))
    assert res.x.shape == (2, 4) and float(res.f_value.max()) < 1e-6


def test_the_mesh_is_on_the_card_unless_asked_for_the_cpu(no_launcher, monkeypatch):
    """``make_mesh``, ``global_mesh`` and ``initialize`` default to CUDA and
    raise without a card, as ``core.start_points`` does; they start no
    group doing so.  ``initialize()`` with no launcher stays local."""
    if torch.cuda.is_available():
        pytest.skip("asks what happens on a machine with no CUDA card")
    for call in (tmesh.make_mesh, distributed.global_mesh,
                 lambda: tmesh.make_mesh(1, dp=1, pop=1)):
        with pytest.raises(RuntimeError, match="no CUDA card for the mesh"):
            call()
        assert not dist.is_initialized()
    distributed.initialize()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA card for the mesh"):
        distributed.initialize(world_size=1, rank=0, store=dist.HashStore())
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA card for the mesh"):
        distributed.initialize()
    assert not dist.is_initialized()
    distributed.initialize(device_type="cpu", world_size=1, rank=0, store=dist.HashStore())
    assert dist.get_backend() == "gloo"
    assert tuple(tmesh.make_mesh(device_type="cpu").shape) == (1, 1)


def test_make_mesh_refuses_as_jax_does(no_launcher):
    got = []
    for kw in (dict(dp=2, pop=1), dict(dp=1, pop=2)):
        with pytest.raises(ValueError) as raised:
            tmesh.make_mesh(1, device_type="cpu", **kw)
        with pytest.raises(ValueError) as want:
            jax_make_mesh(1, **kw)
        got.append(str(raised.value) == str(want.value))
    assert all(got)
    with pytest.raises(ValueError, match="one a device"):
        tmesh.make_mesh(2, device_type="cpu")


def test_mesh_axes_split_and_placements_follow_jax():
    assert (tmesh.DP_AXIS, tmesh.POP_AXIS) == (jmesh.DP_AXIS, jmesh.POP_AXIS)
    for n in (1, 2, 4, 6, 8, 9, 12):
        pop = tmesh._largest_factor_leq(n, int(np.sqrt(n)))
        assert pop == jmesh._largest_factor_leq(n, int(np.sqrt(n)))
    from torch.distributed.tensor import Replicate, Shard

    assert tmesh.population_sharding(None) == (Shard(0), Shard(1))
    assert tmesh.instance_sharding(None) == (Shard(0), Replicate())
    assert [tmesh.block(12, 4, i) for i in range(4)] == [slice(0, 3), slice(3, 6), slice(6, 9),
                                                         slice(9, 12)]


def test_gather_result_is_exact_at_one_rank(no_launcher):
    """The packed float64 gather gives back every field's bits and dtype."""
    mesh = tmesh.make_mesh(device_type="cpu")
    x = torch.tensor([[1.0 + 2.0**-23, np.nan], [-0.0, 3.5]], dtype=torch.float32)
    res = nt.SolverResult(x, torch.tensor([np.inf, -1e-30]), torch.tensor([2**31 - 1, 0],
                          dtype=torch.int32), torch.tensor([5, 6], dtype=torch.int32),
                          torch.zeros((), dtype=torch.int32), torch.tensor([1, 2],
                          dtype=torch.int32), torch.tensor([True, False]))
    for lane_dim in (0, 1):
        got = tmesh.gather_result(res, mesh.get_group(DP_AXIS), x_lane_dim=lane_dim)
        for a, b in zip(got, res):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)


def test_mesh_bench_runs_on_a_one_rank_world(no_launcher, tmp_path):
    """``benches.mesh`` (run under ``torch.distributed.run`` on every rank of
    a world) on a world of one gloo rank at a tiny size: every route equal
    to its unsharded engine bit for bit, the DE on its one split."""
    import json

    from nlsolver_torch.benches import mesh as bench

    out = tmp_path / "mesh.json"
    bench.main(["--device", "cpu", "--scale", "1024", "--out", str(out)])
    got = json.loads(out.read_text())
    assert got["world"] == 1 and not dist.is_initialized()
    assert len(got["routes"]) == 7
    assert all(r["bit_equal"] and r["counters_agree"] == 1.0 for r in got["routes"].values())
    (de,) = [v for k, v in got.items() if k.startswith("de_sharded")]
    assert list(de) == ["1x1"] and de["1x1"]["bit_equal"] and de["1x1"]["generations"] > 0
    # the engines with no unsharded twin, on the one split: the PSO, both
    # forms of the island DE (one island) and the dimension-sharded L-BFGS
    # on both quadratics, the weighted one through its history
    for prefix in ("pso_sharded", "de_island [", "de_island fused", "lbfgs_sharded coupled",
                   "lbfgs_sharded weighted"):
        (rows,) = [v for k, v in got.items() if k.startswith(prefix)]
        row = rows["1x1"]
        assert list(rows) == ["1x1"] and row["ranks_agree"] and row["generations"] > 0
        assert row["converged"] == 1.0 and row.get("bit_equal", True)
        if prefix.startswith("lbfgs"):
            assert row["x_err"] < 1e-4
    (weighted,) = [v for k, v in got.items() if k.startswith("lbfgs_sharded weighted")]
    assert weighted["1x1"]["generations"] > 10


def test_philox_product_probe_on_a_one_rank_world(no_launcher):
    """``benches.mesh.probe_philox_product`` at a tiny size: both products
    give de_sharded and pso_sharded the same bits, each arm timed once a
    pair."""
    from nlsolver_torch.benches import mesh as bench

    distributed.initialize(device_type="cpu")
    try:
        got = bench.probe_philox_product(torch.device("cpu"), scale=1024, pairs=1,
                                         device_type="cpu")
    finally:
        dist.destroy_process_group()
    assert got["bit_equal"] == {"de_sharded": True, "pso_sharded": True}
    assert all(len(v) == 1 and v[0] > 0 for arm in got["ms_a_generation"].values()
               for v in arm.values())
