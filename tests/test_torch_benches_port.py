"""The benches the port took over last: ``ALL_BENCHES`` against the JAX
package's table, ``_knee`` against its ``_knee``, ``bench_qr_batched``,
``bench_qr_shapes`` and ``bench_de_fused_sweep`` at a tiny size on the CPU
(``device="cpu"``: their kernels' arms run the plain twins, so these are
no measurements), and ``bench_saturation``'s sweeps over stand-in benches
(the real ones need a card)."""
import numpy as np
import pytest
import torch

import nlsolver_torch.benches as tb
import nlsolver_tpu.benches as jb

torch.set_num_threads(1)


def test_bench_table_has_every_entry_of_the_jax_table():
    assert set(tb.ALL_BENCHES) == set(jb.ALL_BENCHES)
    assert "roofline_micro" not in tb.ALL_BENCHES
    assert all(callable(f) for f in tb.ALL_BENCHES.values())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("frac", [0.5, 0.8, 1.0])
def test_knee_matches_jax(seed, frac):
    rng = np.random.default_rng(seed)
    rows = [{"B": int(b), "rate": float(r)}
            for b, r in zip(rng.permutation([256, 1024, 4096, 16384, 65536]),
                            rng.uniform(1.0, 10.0, 5))]
    assert tb._knee(rows, "B", "rate", frac) == jb._knee(rows, "B", "rate", frac)


def test_qr_batched_on_the_cpu():
    out = tb.bench_qr_batched(B=16, m=6, n=4, runs=1, reps=2, device="cpu")
    assert out["device"] == "cpu" and (out["B"], out["m"], out["n"]) == (16, 6, 4)
    for k in ("library_qr_per_sec", "parallel_qr_per_sec", "kernel_qr_per_sec",
              "parallel_lstsq_per_sec", "kernel_lstsq_per_sec"):
        assert out[k] > 0, k
    assert out["recon_rel_err"] < 1e-5 and out["kernel_recon_rel_err"] < 1e-5


def test_qr_shapes_on_the_cpu():
    out = tb.bench_qr_shapes(B=8, runs=1, reps=1, device="cpu")
    assert [(r["m"], r["n"]) for r in out["rows"]] == [(16, 16), (16, 8), (32, 8)]
    assert all(r["recon_rel_err"] < 1e-5 for r in out["rows"])


def test_de_fused_sweep_on_the_cpu():
    out = tb.bench_de_fused_sweep(iters=2, runs=1, total_agents=1024, pops=(8, 16), device="cpu")
    rows = out["rows"]
    assert [(r["objective"], r["P"], r["B"]) for r in rows] == [
        ("rastrigin10", 8, 128), ("rastrigin10", 16, 128), ("nlls2x64", 8, 128),
        ("nlls2x64", 16, 128)]
    assert all("fused_us_per_gen" in r and "fused_speedup" in r for r in rows[:2])
    assert all("fused_us_per_gen" not in r and r["plain_us_per_gen"] > 0 for r in rows[2:])


def test_saturation_sweeps_and_knees(monkeypatch):
    """The sweeps' rows and knees from stand-in benches whose rates rise
    with B and level off."""
    def rate(B):
        return 1e6 * B / (B + 4096)

    def bfgs(B, runs, linesearch):
        r = rate(B) * (2 if linesearch == "speculative" else 1)
        return {"device": "stand-in", "iters_per_sec": r, "median_ms": 1e3 / r,
                "solved_frac": 1.0}

    monkeypatch.setattr(tb, "bench_bfgs_fleet", bfgs)
    monkeypatch.setattr(tb, "bench_lm_fleet", lambda B, runs: {
        "fits_per_sec": rate(B), "median_ms": 1.0})
    monkeypatch.setattr(tb, "bench_rootfinder_batch", lambda B, runs: {
        "brent_roots_per_sec": rate(B), "itp_roots_per_sec": rate(B) / 2})
    monkeypatch.setattr(tb, "bench_pso_sann_100d", lambda B, runs, fast: {
        "pso_rastrigin_100d_iters_per_sec": rate(B) * (1 if fast else 0.5),
        "sann_rastrigin_100d_iters_per_sec": rate(B) / 3})
    monkeypatch.setattr(tb, "bench_nlls_fleet", lambda B, runs, solve: {
        "fits_per_sec": rate(B) * {"qr_pallas": 3, "cholesky": 2, "qr": 1}[solve]})
    out = tb.bench_saturation(runs=1)
    sweeps = out["sweeps"]
    assert out["device"] == "stand-in" and set(sweeps) == set(tb.SATURATION_LADDERS)
    # the least B of each ladder whose rate reaches 0.8 of the rate at its
    # largest B
    for name, key, knee in (("bfgs_fleet", "knee_iters_per_sec", 16384),
                            ("lm_fleet", "knee_fits_per_sec", 16384),
                            ("rootfinder", "knee_brent_roots_per_sec", 20000),
                            ("pso_sann_100d", "knee_pso_iters_per_sec", 32768),
                            ("nlls_fleet", "knee_fits_per_sec", 16384)):
        assert [r["B"] for r in sweeps[name]["rows"]][::2 if name == "bfgs_fleet" else 1] \
            == list(tb.SATURATION_LADDERS[name]), name
        assert sweeps[name]["knee_B"] == knee, name
        assert sweeps[name][key] == pytest.approx(rate(knee) * (3 if name == "nlls_fleet" else 1))
    assert sweeps["bfgs_fleet"]["speculative_speedup_at_B"]["1024"] == pytest.approx(2.0)
    assert all(r["best_backend"] == "qr_pallas" for r in sweeps["nlls_fleet"]["rows"])
    rows = sweeps["pso_sann_100d"]["rows"]
    # the row-layout arm runs up to B = 8192
    assert ["row_pso_iters_per_sec" in r for r in rows] == [True, True, True, False]
