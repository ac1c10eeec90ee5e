#!/usr/bin/env python3
"""Smoke run of nlsolver_torch on one CUDA card: builds the kernels, holds
each against its plain PyTorch twin, drives the batched-DE fleet through
``nlsolver_torch.minimize`` and the NLLS fleet through
``nlsolver_torch.fit_fleet`` at full size, and times them.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc over nlsolver_torch/csrc for sm_90a, one process per source;
  3. K1 against its twin on injected draws, B=8192, n=10, P=64, f32,
     5 generations, Rastrigin and sphere, a third of the lanes frozen;
  4. K1's Philox draws: crossover share, forced dimension, seeds, and
     bit-equality with the twin fed the Python Philox;
  5. the DE slice: minimize(rastrigin, x0[8192, 10], method="de",
     layout="batched") through K1, launches counted; then the default
     DEConfig() route on 1024 lanes;
  6. DE timing: the fleet for 200 generations through K1 and through the
     plain step (median of 5 after 2 warm-ups), and K1 alone against its
     twin from CUDA events;
  7. K3 (batch-minor Cholesky solve) bit-equal to its twin on SPD systems,
     n=2 at B=262144 and n in {1, 8, 16, 33} at B=16384, f32, and once in
     f64; the residual small; a non-contiguous and an f16 input refused;
  8. K2b (wavefront least squares) bit-equal to its twin on the NLLS
     fleet's augmented system [J; sqrt(lam) I] at [34, 2, 262144] and on
     random systems; K2a (wavefront QR with Q) bit-equal to its twin and a
     factorization; linalg.qr(method="pallas") launches K2a once;
  9. the NLLS slice: fit_fleet on 262144 exp-decay fits through
     solve="qr_pallas" (K2b), "cholesky" (K3) and "qr" (plain), launches
     counted; solved share, recovered parameters, qr_pallas equal to qr
     lane by lane, cholesky close to them;
 10. NLLS timing: bench_nlls_fleet per backend (median of 3 after 1
     warm-up, ABBA order), and K2a, K2b and K3 alone against their twins
     from CUDA events.

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
FLEET_B, FLEET_M = 262144, 32  # the NLLS fleet: fits, points per fit
SLEEP_CYCLES = 400_000_000     # a device sleep of some 0.2 s ahead of a timed chain


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


def max_diff(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def phase_smallchol(torch, dev):
    from nlsolver_torch.ops import smallchol as tsc

    g = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    cases = [(2, FLEET_B, torch.float32)] + [(n, 16384, torch.float32) for n in (1, 8, 16, 33)]
    for n, b, dtype in cases + [(8, 16384, torch.float64)]:
        M = torch.randn((b, n, n), generator=g, device=dev, dtype=dtype)
        A_std = M @ M.transpose(1, 2) + 2.0 * torch.eye(n, device=dev, dtype=dtype)
        A = A_std.permute(1, 2, 0).contiguous()              # [n, n, B]
        rhs = torch.randn((n, b), generator=g, device=dev, dtype=dtype)
        tsc.solve_spd_batchminor.launches = 0
        x = tsc.solve_spd_batchminor(A, rhs)
        torch.cuda.synchronize()
        check(tsc.solve_spd_batchminor.launches == 1, "K3 did not launch")
        twin = tsc._chol_solve_batchminor(A, rhs)
        check(torch.equal(x, twin), f"K3 differs from its twin at n={n}, B={b}, {dtype}: "
              f"max |diff| {max_diff(x, twin):.3e}")
        worst = max(worst, max_diff(x, twin))
        res = (torch.einsum("ijb,jb->ib", A, x) - rhs).abs().max() / rhs.abs().max()
        log(f"[7] K3 n={n} B={b} {str(dtype)[6:]}: bit-equal to the twin; "
            f"max |Ax-b|/max|b| {float(res):.3e}")
        check(float(res) < (1e-4 if dtype == torch.float32 else 1e-12), "K3 residual too large")
    A32 = torch.eye(3, device=dev).reshape(3, 3, 1).expand(3, 3, 64).contiguous()
    for what, args in (("non-contiguous", (A32.transpose(0, 1), torch.ones(3, 64, device=dev))),
                       ("f16", (A32.half(), torch.ones(3, 64, device=dev).half()))):
        try:
            tsc.solve_spd_batchminor(*args)
        except ValueError as e:
            log(f"[7] K3 refuses a {what} input: {e}")
        else:
            check(False, f"K3 took a {what} input")
    return worst


def fleet_system(torch, dev):
    """The NLLS fleet's first augmented system at full size: [J; sqrt(lam) I]
    and [r; 0] at X0 = ones, lam = lambda0."""
    from nlsolver_torch.benches import expfit_scenario
    from nlsolver_torch.solvers import nlls_fleet as nf

    residual, ys, _ = expfit_scenario(FLEET_B, FLEET_M, device=dev)
    X0 = torch.ones(2, FLEET_B, device=dev)
    r, J = nf._residuals_bm(residual, X0, ys)
    lam = torch.full((FLEET_B,), nf.NLLSFleetConfig().lambda0, device=dev)
    return nf._augmented(r, J, lam)


def phase_qr(torch, dev):
    from nlsolver_torch import linalg
    from nlsolver_torch.ops import qr_wavefront as tqw

    g = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    systems = [("fleet", *fleet_system(torch, dev))]
    for m, n, b in ((32, 8, 4096), (64, 16, 4096), (34, 2, 300)):
        systems.append(("random", torch.randn((m, n, b), generator=g, device=dev),
                        torch.randn((m, b), generator=g, device=dev)))
    for what, A, y in systems:
        x = tqw.least_squares_wavefront_kernel(A, y)
        torch.cuda.synchronize()
        twin = tqw.least_squares_wavefront_reference(A, y)
        check(torch.equal(x, twin), f"K2b differs from its twin at {tuple(A.shape)}: "
              f"max |diff| {max_diff(x, twin):.3e}")
        worst = max(worst, max_diff(x, twin))
        check(bool(torch.isfinite(x).all()), "K2b gave a non-finite x")
        log(f"[8] K2b {what} {tuple(A.shape)}: bit-equal to the twin")
    for m, n, b in ((16, 16, 4096), (32, 8, 4096)):
        A = torch.randn((m, n, b), generator=g, device=dev)
        R, Q = tqw.qr_wavefront_kernel(A, compute_q=True)
        torch.cuda.synchronize()
        tR, tQ = tqw.qr_wavefront_reference(A, compute_q=True)
        check(torch.equal(R, tR) and torch.equal(Q, tQ),
              f"K2a differs from its twin at {(m, n, b)}: R {max_diff(R, tR):.3e}, "
              f"Q {max_diff(Q, tQ):.3e}")
        worst = max(worst, max_diff(R, tR), max_diff(Q, tQ))
        eye = torch.eye(m, device=dev)[:, :, None]
        qtq = float((torch.einsum("ikb,ilb->klb", Q, Q) - eye).abs().max())
        rec = float((torch.einsum("ikb,kjb->ijb", Q, R) - A).abs().max() / A.abs().max())
        sub = torch.tril(torch.ones(m, n, device=dev, dtype=torch.bool), -1)
        tri = float(R[sub].abs().max())
        log(f"[8] K2a {(m, n, b)}: bit-equal to the twin; max|QtQ-I| {qtq:.3e}, "
            f"max|QR-A|/max|A| {rec:.3e}, max|tril(R)| {tri:.3e}")
        check(qtq <= 1e-5 and rec <= 1e-5 and tri <= 1e-4, "K2a is not a QR factorization")
    # K2a's path: the qr dispatcher, counted
    A = torch.randn((16, 16, 4096), generator=g, device=dev)
    tqw.qr_wavefront_kernel.launches = 0
    out = linalg.qr(A, method="pallas")
    torch.cuda.synchronize()
    launches = tqw.qr_wavefront_kernel.launches
    check(launches == 1, f"linalg.qr(method='pallas') launched K2a {launches} times")
    check(float(linalg.validate_qr(
        linalg.QR(out.Q.permute(2, 0, 1), out.R.permute(2, 0, 1)), A.permute(2, 0, 1))) < 1e-4,
        "linalg.qr(method='pallas') does not reconstruct A")
    log(f"[8] linalg.qr(A[16, 16, 4096], method='pallas'): K2a launches {launches}")
    return worst, launches


def reset_counts():
    from nlsolver_torch.ops import de_fused, qr_wavefront, smallchol

    for fn in (de_fused.de_generation_fused, qr_wavefront.qr_wavefront_kernel,
               qr_wavefront.least_squares_wavefront_kernel, smallchol.solve_spd_batchminor):
        fn.launches = 0


def phase_nlls_slice(torch, dev):
    import nlsolver_torch
    from nlsolver_torch.benches import expfit_scenario
    from nlsolver_torch.ops import qr_wavefront as tqw
    from nlsolver_torch.ops import smallchol as tsc
    from nlsolver_torch.solvers.nlls_fleet import CHECK_EVERY

    residual, ys, truth = expfit_scenario(FLEET_B, FLEET_M, device=dev)
    kernel_of = {"qr_pallas": "K2b", "cholesky": "K3", "qr": None}
    res, launches = {}, {}
    for solve, kernel in kernel_of.items():
        cfg = nlsolver_torch.NLLSFleetConfig(max_iter=30, solve=solve)
        X0 = torch.ones(2, FLEET_B, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        out = nlsolver_torch.fit_fleet(residual, X0, cfg, data=ys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"K2a": tqw.qr_wavefront_kernel.launches,
                  "K2b": tqw.least_squares_wavefront_kernel.launches,
                  "K3": tsc.solve_spd_batchminor.launches}
        # the host loop reads done.all() every CHECK_EVERY steps; the last
        # lane to finish halts on step iterations + 1
        steps = -(-(int(out.iterations.max()) + 1) // CHECK_EVERY) * CHECK_EVERY
        solved = float((out.f_value < 1e-6).float().mean())
        err = (out.x - truth).abs()
        log(f"[9] fit_fleet {solve}: {wall:.3f} s, host steps {steps}, launches {counts}, "
            f"iterations median {float(out.iterations.float().median()):.0f} max "
            f"{int(out.iterations.max())}, solved {solved:.6f}, median |p-truth| "
            f"{float(err.median()):.3e}, max {float(err.max()):.3e}")
        check(out.x.shape == (2, FLEET_B) and bool(torch.isfinite(out.x).all()),
              f"{solve}: non-finite or misshapen x")
        check(solved >= 0.999, f"{solve}: solved share {solved} below 0.999")
        check(float(err.median()) <= 1e-3, f"{solve}: median |p - truth| above 1e-3")
        for k in counts:  # one launch per host step of this backend's kernel, none of the others
            want = steps if k == kernel else 0
            check(counts[k] == want, f"{solve}: {k} launched {counts[k]} times, "
                  f"expected {want} in {steps} host steps")
        res[solve] = out
        if kernel is not None:
            launches[solve] = counts[kernel]
    same_it = torch.equal(res["qr_pallas"].iterations, res["qr"].iterations)
    same_x = torch.equal(res["qr_pallas"].x, res["qr"].x)
    log(f"[9] qr_pallas against qr: iterations equal on every lane {same_it}, x equal {same_x}")
    check(same_it and same_x, "the K2b fleet differs from the plain wavefront fleet")
    d = (res["cholesky"].x - res["qr"].x).abs()
    log(f"[9] cholesky against qr: max |dx| {float(d.max()):.3e}, median {float(d.median()):.3e}")
    check(float(d.max()) <= 1e-4, "the cholesky fleet's fits differ from the qr fleet's by over 1e-4")
    return launches


def time_alone(torch, fn, reps, device_only):
    """Time of one call of ``fn`` from CUDA events over ``reps`` chained
    calls, after warm-up.  With ``device_only`` a device sleep ahead of the
    start event lets the host queue every call first, so the events see the
    card's time and not the host's pace (a kernel's wrapper costs some
    20-40 us of host time per call).  A plain twin issues more eager ops
    than the launch queue holds, so the host paces it however long the card
    sleeps: it is timed as a plain chain, its real cost per call."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if device_only:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    if device_only:
        slept = time.perf_counter() - t0 - start.elapsed_time(end) / 1e3
        check(queued < slept, f"the host queued for {queued:.3f} s, longer than the card "
              f"slept ({slept:.3f} s): the timing would be the host's")
    return start.elapsed_time(end) / reps


def phase_nlls_timing(torch, dev):
    from nlsolver_torch.benches import bench_nlls_fleet
    from nlsolver_torch.ops import qr_wavefront as tqw
    from nlsolver_torch.ops import smallchol as tsc

    runs = {}
    for solve in ("qr", "qr_pallas", "cholesky", "cholesky", "qr_pallas", "qr"):
        r = bench_nlls_fleet(solve=solve)
        runs.setdefault(solve, []).append(r)
        log(f"[10] {r['name']}: median {r['median_ms']:.3f} ms / {r['steps']} steps, min "
            f"{r['min_ms']:.3f} ms, {r['fits_per_sec']:.6g} fits/s, solved {r['solved_frac']:.6f}")
    g = torch.Generator(device=dev).manual_seed(9)
    A, y = fleet_system(torch, dev)
    times = {"K2b": [(lambda: tqw.least_squares_wavefront_kernel(A, y), 50),
                     (lambda: tqw.least_squares_wavefront_reference(A, y), 5)]}
    for n, b in ((2, FLEET_B), (8, 16384)):
        M = torch.randn((b, n, n), generator=g, device=dev)
        An = (M @ M.transpose(1, 2) + 2.0 * torch.eye(n, device=dev)).permute(1, 2, 0).contiguous()
        bn = torch.randn((n, b), generator=g, device=dev)
        times[f"K3 n={n}"] = [(lambda An=An, bn=bn: tsc.solve_spd_batchminor(An, bn), 50),
                              (lambda An=An, bn=bn: tsc._chol_solve_batchminor(An, bn), 5)]
    Aq = torch.randn((16, 16, 4096), generator=g, device=dev)
    times["K2a"] = [(lambda: tqw.qr_wavefront_kernel(Aq, compute_q=True), 50),
                    (lambda: tqw.qr_wavefront_reference(Aq, compute_q=True), 5)]
    alone = {}
    for name, ((kern, kreps), (plain, preps)) in times.items():
        # ABBA: plain, kernel, kernel, plain; the least of each pair
        p1, k1, k2, p2 = (time_alone(torch, f, r, device_only=f is kern) for f, r in
                          ((plain, preps), (kern, kreps), (kern, kreps), (plain, preps)))
        alone[name] = (min(k1, k2), min(p1, p2))
        log(f"[10] {name} alone: kernel {min(k1, k2) * 1e3:.2f} us of device time, plain twin "
            f"{min(p1, p2) * 1e3:.2f} us per chained call (CUDA events; kernel "
            f"{k1 * 1e3:.2f}/{k2 * 1e3:.2f}, twin {p1 * 1e3:.2f}/{p2 * 1e3:.2f})")
    for solve, rs in runs.items():
        best = max(rs, key=lambda r: r["fits_per_sec"])
        log(f"[10] fleet {solve}: {best['fits_per_sec']:.6g} fits/s "
            f"({best['median_ms']:.3f} ms per {best['steps']}-step fit of {FLEET_B} lanes)")
    return alone


def kernel_row(name, source, replaces, launches, max_err, ms, plain_ms):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def main():
    import torch

    name = phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    max_err = phase_injected(torch, dev)
    phase_philox(torch, dev)
    launches = phase_slice(torch, dev)
    ms, plain_ms = phase_timing(torch, dev)
    chol_err = phase_smallchol(torch, dev)
    qr_err, qr_launches = phase_qr(torch, dev)
    fleet_launches = phase_nlls_slice(torch, dev)
    alone = phase_nlls_timing(torch, dev)
    print(json.dumps({"kernels": [
        kernel_row("de_generation_fused", "nlsolver_torch/csrc/de_fused.cu", TPU_KERNEL,
                   launches, max_err, ms, plain_ms),
        kernel_row("qr_wavefront_kernel", "nlsolver_torch/csrc/qr_wavefront.cu",
                   "nlsolver_tpu/ops/qr_wavefront.py:150", qr_launches, qr_err, *alone["K2a"]),
        kernel_row("least_squares_wavefront_kernel", "nlsolver_torch/csrc/qr_wavefront.cu",
                   "nlsolver_tpu/ops/qr_wavefront.py:207", fleet_launches["qr_pallas"], qr_err,
                   *alone["K2b"]),
        kernel_row("solve_spd_batchminor", "nlsolver_torch/csrc/smallchol.cu",
                   "nlsolver_tpu/ops/smallchol.py:101", fleet_launches["cholesky"], chol_err,
                   *alone["K3 n=2"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
