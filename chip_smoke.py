#!/usr/bin/env python3
"""Smoke run of nlsolver_torch on one CUDA card: builds the kernels, holds
each against its plain PyTorch twin, drives the batched-DE fleet through
``nlsolver_torch.minimize`` at full size, and times it.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc over nlsolver_torch/csrc for sm_90a;
  3. kernel against twin on injected draws, B=8192, n=10, P=64, f32,
     5 generations, Rastrigin and sphere, a third of the lanes frozen;
  4. the kernel's Philox draws: crossover share, forced dimension, seeds,
     and bit-equality with the twin fed the Python Philox;
  5. the slice: minimize(rastrigin, x0[8192, 10], method="de",
     layout="batched") through the kernel, launches counted; then the
     default DEConfig() route on 1024 lanes;
  6. timing: the fleet for 200 generations through the kernel and through
     the plain step (median of 5 after 2 warm-ups), and the kernel alone
     against its twin from CUDA events.

Prints a JSON line of kernels, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA card or anything fails.
"""
import json
import subprocess
import sys
import time

B, N, P = 8192, 10, 64
RTOL = ATOL = 1e-5  # scores: the same terms summed in another order
TPU_KERNEL = "nlsolver_tpu/ops/de_fused.py:110"


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[1] device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[1] nvidia-smi: {smi.stdout.strip()}")
    return name


def phase_build():
    from nlsolver_torch.ops import _build

    t0 = time.perf_counter()
    path, out = _build.ensure_built()
    _build.load_library()
    log(f"[2] built {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2] ptxas: {line.strip()}")


def phase_injected(torch, dev):
    from nlsolver_torch import PROBLEMS
    from nlsolver_torch.ops import de_fused as tdf
    from nlsolver_torch.solvers.de_batched import ring_offsets

    F, CR = 0.8, 0.9
    worst = 0.0
    for name in ("rastrigin", "sphere"):
        fn = PROBLEMS[name].fn
        g = torch.Generator(device=dev).manual_seed(1)
        agents = (torch.rand((B, N, P), generator=g, device=dev) - 0.5) * 5.0
        scores = tdf.eval_columns(fn, agents)
        active = torch.arange(B, device=dev) % 3 != 0
        inf = torch.full_like(scores, float("inf"))
        for gen in range(5):
            u = torch.rand((B, N, P), generator=g, device=dev)
            fdim = torch.randint(0, N, (B, P), generator=g, device=dev)
            offs = ring_offsets(P, 1, gen)

            def both(s):
                k = tdf.de_generation_fused(fn, agents, s, offs, active, seed=0,
                                            generation=gen, u=u, fdim=fdim)
                torch.cuda.synchronize()
                return k, tdf.de_generation_reference(fn, agents, s, offs, u, fdim,
                                                      active, F, CR)

            # every proposal accepted: proposals bit-equal, scores close
            (pk, psk), (pt, pst) = both(inf)
            check(torch.equal(pk, pt), f"{name} gen {gen}: proposals differ")
            check(torch.allclose(psk[active], pst[active], rtol=RTOL, atol=ATOL),
                  f"{name} gen {gen}: proposal scores differ")
            worst = max(worst, float((psk - pst)[active].abs().max()))

            (ka, ks), (ta, ts) = both(scores)
            same = (ks < scores) == (ts < scores)
            check(torch.equal(ka[same[:, None, :].expand_as(ka)],
                              ta[same[:, None, :].expand_as(ta)]),
                  f"{name} gen {gen}: agents differ where the accept masks agree")
            check(torch.allclose(ks[same], ts[same], rtol=RTOL, atol=ATOL),
                  f"{name} gen {gen}: scores differ")
            near = (pst - scores).abs() <= ATOL + RTOL * scores.abs()
            check(bool(near[~same].all()), f"{name} gen {gen}: accept masks differ off a tie")
            check(torch.equal(ka[~active], agents[~active])
                  and torch.equal(ks[~active], scores[~active]),
                  f"{name} gen {gen}: a frozen lane changed")
            log(f"[3] {name} gen {gen}: accepted {int((ks < scores).sum())}, "
                f"masks differ at {int((~same).sum())}")
            agents, scores = ka, ks
    log(f"[3] kernel == twin on injected draws; max |score diff| {worst:.3e}")
    return worst


def phase_philox(torch, dev):
    from nlsolver_torch import PROBLEMS
    from nlsolver_torch.ops import de_fused as tdf

    fn = PROBLEMS["rastrigin"].fn
    g = torch.Generator(device=dev).manual_seed(2)
    agents = torch.rand((B, N, P), generator=g, device=dev) - 0.5
    inf = torch.full((B, P), float("inf"), device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    offs = (5, 30, 50)
    masks = []
    for seed in (11, 12):
        out, _ = tdf.de_generation_fused(fn, agents, inf, offs, active, seed=seed, generation=3)
        masks.append(out != agents)
    torch.cuda.synchronize()
    share = float(masks[0].float().mean())
    expect = 0.9 + 0.1 / N
    log(f"[4] changed share {share:.5f} (expect {expect:.5f})")
    check(abs(share - expect) < 0.005, "crossover share off")
    check(bool(masks[0].any(dim=1).all()), "an agent changed no coordinate")
    check(not torch.equal(masks[0], masks[1]), "two seeds gave the same masks")
    u, fdim = tdf.philox_draws(11, 3, B, N, P, torch.float32, dev)
    twin, _ = tdf.de_generation_reference(fn, agents, inf, offs, u, fdim, active, 0.8, 0.9)
    out, _ = tdf.de_generation_fused(fn, agents, inf, offs, active, seed=11, generation=3)
    check(torch.equal(out, twin), "kernel's Philox draws differ from the Python Philox")
    log("[4] Philox mode ok; bit-equal to the twin on the Python Philox draws")


def phase_slice(torch, dev):
    import nlsolver_torch
    from nlsolver_torch import DEConfig, PROBLEMS
    from nlsolver_torch.ops import de_fused as tdf
    from nlsolver_torch.solvers import de_batched

    fn = PROBLEMS["rastrigin"].fn
    x0 = torch.full((B, N), -0.5, device=dev)
    cfg = DEConfig(pop_size=P, partner_sampling="rotation", use_fused_kernel=True,
                   max_iter=200, eps=0.0, best_value_no_change=1 << 30)
    tdf.de_generation_fused.launches = 0
    t0 = time.perf_counter()
    res = nlsolver_torch.minimize(fn, x0, method="de", layout="batched", config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tdf.de_generation_fused.launches
    # max_iter generations advance the lanes; one more sees the limit and
    # freezes the fleet
    generations = cfg.max_iter + 1
    log(f"[5] minimize: {wall:.3f} s, kernel launches {launches}, generations {generations}")
    check(launches == generations, f"{launches} launches for {generations} generations")
    check(bool((res.iterations == cfg.max_iter).all()), "not every lane ran max_iter")
    check(tuple(res.x.shape) == (B, N) and bool(torch.isfinite(res.x).all())
          and bool(torch.isfinite(res.f_value).all()), "non-finite or misshapen result")
    med = float(res.f_value.median())
    p99 = float(torch.quantile(res.f_value, 0.99))
    log(f"[5] best f: median {med:.4g}, p99 {p99:.4g}, max {float(res.f_value.max()):.4g}")
    check(med < 0.1 and p99 < 1.0, "the fleet did not converge far enough")

    # the same fleet step by step: the best score of a lane never rises
    g = torch.Generator(device=dev).manual_seed(0)
    state = de_batched.init(fn, x0, cfg, generator=g)
    rose = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(cfg.max_iter):
        prev = state.scores.amin(dim=1)
        state = de_batched.step(fn, state, cfg, generator=g)
        rose |= state.scores.amin(dim=1) > prev
    check(not bool(rose.any()), "a lane's best score rose")

    res = nlsolver_torch.minimize(fn, torch.full((1024, N), -0.5, device=dev),
                                  method="de", layout="batched", config=DEConfig())
    log(f"[5] default DEConfig() route, 1024 lanes: converged {int(res.converged.sum())}, "
        f"iterations max {int(res.iterations.max())}, f max {float(res.f_value.max()):.4g}")
    check(bool(res.converged.all()), "a lane of the default route did not converge")
    return launches


def time_kernel_alone(torch, dev, reps=200):
    from nlsolver_torch import PROBLEMS
    from nlsolver_torch.ops import de_fused as tdf

    fn = PROBLEMS["rastrigin"].fn
    g = torch.Generator(device=dev).manual_seed(3)
    agents0 = torch.rand((B, N, P), generator=g, device=dev) - 0.5
    scores0 = tdf.eval_columns(fn, agents0)
    active = torch.ones(B, dtype=torch.bool, device=dev)

    def kernel(a, s, i):
        return tdf.de_generation_fused(fn, a, s, (5, 30, 50), active, seed=1, generation=i)

    def plain(a, s, i):
        u = torch.rand((B, N, P), generator=g, device=dev)
        fdim = torch.randint(0, N, (B, P), generator=g, device=dev)
        return tdf.de_generation_reference(fn, a, s, (5, 30, 50), u, fdim, active, 0.8, 0.9)

    out = {}
    for name, f in (("plain", plain), ("kernel", kernel), ("kernel", kernel), ("plain", plain)):
        a, s = agents0, scores0
        for i in range(10):
            a, s = f(a, s, i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            a, s = f(a, s, i)
        end.record()
        torch.cuda.synchronize()
        out.setdefault(name, []).append(start.elapsed_time(end))
    return {k: min(v) for k, v in out.items()}, reps


def phase_timing(torch, dev):
    from nlsolver_torch.benches import bench_de_batched

    runs = {}
    for fused in (False, True, True, False):
        r = bench_de_batched(fused=fused)
        runs.setdefault(fused, []).append(r)
        log(f"[6] {r['name']}: median {r['median_ms']:.3f} ms / 200 gens, min "
            f"{r['min_ms']:.3f} ms, {r['iters_per_sec']:.6g} instance generations/s")
    alone, reps = time_kernel_alone(torch, dev)
    log(f"[6] kernel alone: {alone['kernel']:.3f} ms for {reps} generations, "
        f"{alone['kernel'] / reps * 1e3:.2f} us/generation; plain twin "
        f"{alone['plain'] / reps * 1e3:.2f} us/generation (CUDA events, min of 2)")
    for fused, label in ((True, "kernel path"), (False, "plain path")):
        best = max(runs[fused], key=lambda r: r["iters_per_sec"])
        log(f"[6] {label}: {best['iters_per_sec']:.6g} instance generations/s, "
            f"{best['median_ms'] / 200 * 1e3:.2f} us/generation end to end")
    return alone["kernel"] / reps, alone["plain"] / reps


def main():
    import torch

    name = phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    max_err = phase_injected(torch, dev)
    phase_philox(torch, dev)
    launches = phase_slice(torch, dev)
    ms, plain_ms = phase_timing(torch, dev)
    print(json.dumps({"kernels": [{
        "name": "de_generation_fused",
        "route": "cuda",
        "source": "nlsolver_torch/csrc/de_fused.cu",
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
