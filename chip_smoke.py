#!/usr/bin/env python3
"""Smoke run of nlsolver_torch on one CUDA card: builds the kernels, holds
each against its plain PyTorch twin, drives the batched-DE fleet, the BFGS
fleet, the CMA-ES fleet, the PSO and SANN lane fleets and the
single-instance solvers on lanes (with derivatives and without, the
default method and the multistart) through ``nlsolver_torch.minimize``, the
NLLS fleet through
``nlsolver_torch.fit_fleet`` and the root finders through
``nlsolver_torch.root`` at full size, the mesh engines (``layout="sharded"``,
``fit_fleet_sharded``, ``fit_sharded``) on a world of one rank, and times
them.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc over nlsolver_torch/csrc for sm_90a, one process per source;
     no register kernel of K5, K2b or K3 (one per n and dtype each), and no
     kernel of K2b's warp form, of the cluster and distributed forms of K2b,
     K3 and K2a (K3-c's probes' kernel too), of the panel forms of K2a and
     K2b (K2b-p's back solve too) or of K3-b (its main path's kernel), may
     spill or keep a stack frame; the issue
     floors of K1's staged form, K2b's register and warp forms, K2a's warp
     form, K4b-c and K3's register and warp forms from their SASS, and of
     K1c, K1g, K4b-t and K4b (benches.issue_floors);
  3. K1 in its three forms against its twin on injected draws, B=8192,
     n=10, P=64, f32, 5 generations, Rastrigin and sphere, a third of the
     lanes frozen; the forms at the edges of the staged form's plan (n = 16
     and 17 at P = 64, n * P no multiple of 4, n = 28 at P = 1024), the
     cluster form (K1c) past it at the wide fleet's [256, 29, 1024], at the
     last n its largest cluster takes ([3, 453, 1024]) and with rows staged
     by plain loads (P = 1022), its proposals bit-equal to the twin's and
     its agents and scores to the global form's (K1g), K1g past it (n =
     454), and the dispatcher's choice at each;
  4. K1's Philox draws: crossover share, forced dimension, seeds, and
     bit-equality of every form with the twin fed the Python Philox, K1c
     also at [256, 29, 1024] and [3, 453, 1024] and bit-equal to K1g;
  5. the DE slice: minimize(rastrigin, x0[8192, 10], method="de",
     layout="batched") through K1's staged form, launches counted; the
     default DEConfig() route on 1024 lanes; a wide fleet (256 instances,
     n=29, P=1024) through the cluster form, K1g once by a direct call;
  6. DE timing: the fleet for 200 generations through K1 and through the
     plain step (median of 5 after 2 warm-ups), and each form of K1 alone
     behind a device sleep against its twin from CUDA events (K1c and K1g
     at the wide fleet's shape);
  7. K3 (batch-minor Cholesky solve) in its forms (registers, a warp a
     lane, a cluster a lane, a lane over the whole card, device memory)
     bit-equal to its twin on SPD
     systems by direct call, each form that takes n, at n in {1, 2, 8, 12,
     16, 30, 33} at B=16384 in f32 and n=8 in f64, at the shapes phase 10
     times ([2, 2, 262144], [12, 12, 16384], [30, 30, 4096]) and on the
     first damped normal equations of the exp fleet and the two Chebyshev
     fleets of phase 9; the dispatcher's choice at each edge of K3-r's,
     K3-w's and K3-c's ranges in f32 and f64, its x bit-equal to the twin
     (past n = 64 to chol_solve_right_looking, the twin's operations in its
     order as whole blocks); its path past K3-w's range, [240, 240, 16] in
     f64 through K3-c (clusters of 8), launches counted, x bit-equal to
     chol_solve_right_looking and the residual |Ax - b| / |b| below 1e-12;
     past K3-c's range K3-b (a lane over the card, its triangle packed in
     device memory, factored by panels, the back solve by columns), K3-d's
     old range included: the plan's hand-over from K3-c to K3-b and K3-d's
     last n, and the dispatcher at the first n, [646, 646, 2] f64 and [928,
     928, 2] f32, and at the first n past K3-d's range, [2458, 2458, 2] f64
     and [3600, 3600, 2] f32, each K3-b once and no other form, x bit-equal
     to its plain version on the card and |Ax - b| / (|A| |x|) within 10x
     the twin's order's; on the same systems at the first n, K3-d (a lane
     over P CTAs of the card, one barrier in device memory a step) by direct
     calls, counted, bit-equal to the twin's order, and at [646, 646, 2] f64
     K3-g (device memory), bit-equal, timed once, and K3-b, bit-equal to its
     plain version, by direct calls; a non-contiguous and an f16 input
     refused;
  8. K2b (wavefront least squares) in its seven forms (registers, shared
     memory, a warp a lane, a cluster a lane, a lane over the whole card,
     panels over the whole card, device memory) bit-equal to
     its twin on the NLLS fleet's augmented system [J; sqrt(lam) I] at [34,
     2, 262144] in f32 and f64, the shared, warp, cluster and device-memory
     forms on the Chebyshev fleets' first systems, [44, 12, 16384], [78,
     30, 4096] and [248, 120, 256] in f64, and on random systems, each form
     but the device-memory one at the first and last n it takes, square and
     with one row more, and the dispatcher's choice at each boundary; past
     the cluster form's range, [330, 330, 2] in f64 through the dispatcher
     to the distributed form (66 CTAs a lane), counted, bit-equal, and its
     first n in f32 the same way, its last n by the dispatcher's choice
     alone; the device-memory form, past the distributed form's range, by a
     direct call on the same f64 systems, counted, bit-equal, timed once;
     K2b-p (R over the card as K2a-p forms it, y carried as one more
     column, then a back solve a CTA a lane) by a direct call there, and
     through the dispatcher past K2b-d's range, at [1263, 1263, 2] f64,
     [1848, 1848, 2] f32, [1849, 1849, 1] f64 (two panels) and the
     augmented system of a Chebyshev fit of 1263 coefficients on 1280
     points, [2543, 1263, 2] f64, each counted (a kernel a panel and the
     back solve), x bit-equal to the twin run on the card at [1263, 1263,
     2] f64 and to the twin's order (the twin's stages on the card, its
     back solve on the host; bit-equal to the twin there and at [330, 330,
     2]) at the other three; the dispatcher's ends of K2b-d and K2b-p; K2a (wavefront QR) in its warp form (K2a-w)
     and its device-memory form (K2a-g) bit-equal to its twin at [16, 16, 4096] and [32, 8, 4096] with
     Q, and a factorization; K2a-w, its cluster form (K2a-c) and its form
     over P CTAs of the card (K2a-d) at the first and last square shapes
     of their ranges and with one row more, with and without Q, in f32 and
     f64, a zero column, each through the dispatcher (K2a-w and K2a-c on
     32 lanes, K2a-d on 2), and the dispatcher's end of K2a-d;
     linalg.qr(method="pallas") launches K2a-w once at [16, 16, 4096],
     K2a-c once at [170, 170, 32] and K2a-d once at [333, 333, 2] f64, the
     first square shape past K2a-c's range, and no other form of K2a, each
     reconstructing A within 1e-4; K2a-g by a direct call at [170, 170, 32],
     counted, bit-equal; linalg.qr(method="pallas") launches K2a-p (R over
     the card with each rotation logged, Q^T rebuilt from the log; a kernel
     a panel, then a replay of the log a panel but the last and one for
     Q^T, each counted) and no other form of K2a at the first square shapes
     past K2a-d's range with Q, [1875, 1875, 2] f32
     and [1321, 1321, 2] f64, at [1817, 1817, 1] f64 and at its first shape
     in two panels, [1849, 1849, 1] f64, R and Q bit-equal to the twin on
     the card; K2a-p by a direct call at [333, 333, 2] f64, bit-equal;
  9. the NLLS slice: fit_fleet on 262144 exp-decay fits through
     solve="qr_pallas" (K2b's register form), "cholesky" (K3's register
     form) and "qr" (plain), launches counted; solved share, recovered
     parameters, qr_pallas equal to qr lane by lane, cholesky close to them;
     Chebyshev fits of 12 and 30 coefficients through K2b's shared-memory
     and warp forms, and of 120 in f64 through its cluster form; the
     same fits of 12 and 30 coefficients through solve="cholesky" (K3 in
     the form its plan names, K3-w at 30), K3 launched once a host step;
     two fits of 1263 coefficients on 1280 points in f64 through
     "qr_pallas" (K2b-p once a host step) and "cholesky" (K3-b once a host
     step), each recovering its coefficients, the two within 1e-9 of each
     other;
     numpy start points and data land on the card;
 10. NLLS timing: bench_nlls_fleet per backend (median of 3 after 1
     warm-up, ABBA order), and K2a in its four forms (K2a-w at [16, 16,
     4096], K2a-c and K2a-g at linalg.qr's [170, 170, 32], K2a-d at [333,
     333, 2] f64 beside K2a-g there, timed once with no warm-up, and the
     twin, timed once), each form of K2b (the device-memory form
     also on the shared and warp forms' Chebyshev systems, and beside the
     cluster form on the float64 fleet's) and K3's forms (K3-r at [2, 2,
     262144], the planned form at [12, 12, 16384], K3-w at [30, 30, 4096],
     K3-c at [240, 240, 16] f64, K3-g beside each) alone against their
     twins from CUDA events, beside the one PyTorch call that computes the
     same function (torch.linalg.qr, torch.linalg.lstsq, Cholesky factor
     and solve); K2b-g at [330, 330, 2] f64 and K3-g at [646, 646, 2] f64
     (the first n past the cluster forms' ranges), and beside each the form
     that takes those shapes now, K2b-d and K3-d; K2a-p at [333, 333, 2]
     f64, [1321, 1321, 2] f64 and [1875, 1875, 2] f32 with Q beside
     torch.linalg.qr, and K3-b through the dispatcher at [646, 646, 2] f64,
     [1263, 1263, 2] f64 (K3-d beside both by a direct call), [2458, 2458,
     2] f64 and [3600, 3600, 2] f32 beside cholesky_ex + cholesky_solve,
     K2b-p at
     [1263, 1263, 2] f64 and [1848, 1848, 2] f32 beside torch.linalg.lstsq
     and at [330, 330, 2] f64 beside K2b-d, the median of 5 calls after 2
     warm-ups from CUDA events around each;
 11. K4a (resident rank-2 update + direction) against its twin at
     [16, 16, 65536] f32 with a third of the lanes on reset and a fifth at
     rho = 0, at n in {1, 2, 8, 33} with a ragged B, and once in f64; K4b-c
     (the update over a thread-block cluster) at [128, 128, 4096] and at the
     first and last n of its range in f32 and f64 (B = 1001 and 4096), each
     equal to K4b (row-split) bit for bit; K4b-t (a cluster of 16 whose rows
     are streamed twice, the second read hinted to L2) at the first n past
     K4b-c's range ([225, 225, 256] in f32, 153 in f64), at n = 304 and 305,
     at n = 320, at the dispatcher's last n and at its plan's last n, each
     equal to K4b bit for bit;
     K4b at n = 16 where it must equal K4a bit for bit, at n = 45 and at
     the first n past K4b-t's range; the dispatcher's choice at both ends of
     K4b-c's range and of K4b-t's on 5, 256 and 4096 lanes (it shrinks as B
     grows); K4c (leading-batch update) through the dispatcher in each
     of its forms, each against its twin and, by a direct call of another
     form that takes n, bit for bit: K4c-r (a thread a row in registers)
     at the single-instance BFGS's [10000, 16, 16] f32, at [65536, 16, 16]
     f32 (equal to K4a off the reset lanes), at the restarts' [8, 2, 2] f32
     and at [8, 2, 2] f64, each equal to K4c-w (a warp an instance) and to
     its own other way (rows staged or straight); K4c-w at [1001, 16,
     16] f64, equal to K4c-r, and at [1001, 33, 33] f64, equal to K4c-g
     (two passes through device memory); K4c-g at [4096, 64, 64] f32,
     equal to K4c-w, and at [256, 256, 256] f32 and [64, 200, 200] f64; a
     non-contiguous and an f16 input refused;
 12. the BFGS slice: minimize(method="bfgs", layout="fleet") on 65536
     16-D bowls with more_thuente and with speculative, K4a launches equal
     to the host steps, every lane halted by a tolerance before max_iter,
     converged share at least 0.98 and 0.92, converged lanes within 5e-3
     of their centers and every lane within 1e-2, solved share at least
     0.999; a numpy x0 lands on the card; a Rosenbrock fleet; a wide fleet
     (n=128, B=4096) that reaches K4b-c through the dispatcher, and two past
     K4b-c's range (n=225 and n=320, B=256) that reach K4b-t; K4b once by a
     direct call at [225, 225, 256];
     one leading-batch update through ops.rank2_update_batched (K4c-r);
     K4c-w by a direct call at [10000, 16, 16];
 13. BFGS timing: bench_bfgs_fleet per line search (median of 3 after 1
     warm-up, ABBA order), and K4a, K4b-c (at [128, 128, 4096], and on
     clusters of 16 at [225, 225, 256]), K4b-t and K4b (at [225, 225, 256]
     and [320, 320, 256], and K4b beside K4b-c), K4c-r (both of its ways,
     staged and straight) and K4c-w at [10000, 16, 16] and [65536, 16,
     16] and K4c-g at [256, 256, 256] alone against their twins from CUDA
     events;
 14. K5 (batched Jacobi eigensolver) equal to its twin bit for bit in all
     four forms: K5r (registers) at [16, 16, 65536] f32 with 8 sweeps,
     [17, 17, 4096], [2, 2, 65536], [8, 8, 4096] f64, [16, 16, 4099] in f32
     and f64, [31, 31, 512] and [32, 32, 512]; K5a (shared memory) at the
     same shapes, at [56, 56, 4096], [64, 64, 4096] and at its edge
     [169, 169, 64]; K5b (device memory) at all of these up to n = 64;
     K5c (a cluster's shared memory) at [169, 169, 64] and at the wide
     fleets' shapes past K5a, [170, 170, 256] (with K5b there) and [300,
     300, 256] (clusters of 4); against torch.linalg.eigh in f64 on the
     same matrices (eigenvalues, V diag(w) V^T - A and V^T V - I within
     1e-5 in f32 up to n = 16 and 1e-5 n / 16 beyond, 1e-11 in f64); K5b
     at its fleet's [473, 473, 16] with 2 sweeps; K5c at the first and
     last n of each cluster size (f32: 170, 238, 239, 336, 337, 472; f64:
     120, 167, 168, 236, 237, 329) and K5b at 330 in f64 on 4 lanes with 2
     sweeps; the clusters the card holds at once; a diagonal matrix; the
     dispatcher takes K5r at n = 32, K5a at 33 and 169, K5c at 170 and
     472, K5b at 473 (f32), K5r at 16, K5a at 17 and 119, K5c at 120 and
     329, K5b at 330 (f64); a non-contiguous and an f16 input refused;
 15. the CMA-ES slice: the bench scenario (16-D Rastrigin, 65536 lanes,
     lam = 12, 50 generations) with eigh_method="pallas", K5r launches
     equal to the generations, and with eigen_interval=5 and
     defer_covariance=True, launches equal to the refreshes of the
     schedule; minimize(method="cmaes", layout="fleet") on 65536 8-D bowls
     until every lane halts, K5r launched once per host step; a numpy x0
     lands on the card; a bounded fleet stays in its box; wide fleets at
     n = 56 and n = 64 (K5a), short ones at n = 170 and n = 300 (K5c, with
     clusters of 2 and 4) and one generation at n = 473 with 2 sweeps
     (K5b), each through the dispatcher;
 16. CMA-ES timing: bench_cmaes_fleet per eigh_method and for the lazy
     deferred mode (ABBA order); K5r and K5a at [16, 16, 65536], K5a at
     [56, 56, 4096] and [64, 64, 4096], K5c at [170, 170, 256] and K5b at
     [473, 473, 16] with 2 sweeps (the shapes each serves) alone against
     their twins from CUDA events, beside torch.linalg.eigh on [B, n, n].
 17. the root finders (no kernel): nt.root with every method, and
     false_position's reference variant, on 103072 lanes of a cos(x) - c x + d
     in float32 and float64: the bench problem (cos(x) - c x on [0, 2], c
     from 0.1 to 1.9, 100000 lanes), 1024 lanes of it on [3, 5] (no root),
     1024 decreasing d - x on [0, 3] and 1024 increasing c x - cos(x);
     bracketed and NaN x exactly on the unbracketed lanes, 2 calls there,
     every converged lane's |f(x)| within its finder's tolerance, the first
     4096 lanes against the same call on the host (ROOT_DX, and the share
     of lanes whose counters may differ), Brent on 2,000,000 lanes; no
     kernel launched;
 18. root-finder timing: bench_rootfinder_batch (Brent and ITP at B =
     100000, f32: roots/s, trips a run, host time a trip), one Brent run
     under torch.profiler (wall against device busy time a trip);
 19. the PSO and SANN slice (no kernel): minimize(method="pso" and "sann",
     layout="batched") on a small fleet until every lane halts, the 100-D
     Rastrigin fleets for 200 iterations at B = 256 and 8192, a bounded PSO
     fleet that stays in its box at its corner, numpy start points landing
     on the card, and init plus 5 steps on the card against the host on the
     same injected draws in float64 (vanilla, accelerated and clamped PSO,
     both SANN Metropolis modes; rtol 1e-10, atol 1e-12, counters equal);
 20. PSO and SANN timing: bench_pso_sann_100d at B = 256 and 8192 (PSO on
     Rastrigin and Ackley, SANN on Rastrigin, 200 iterations), each fleet
     traced over 20 iterations (wall against device busy time);
 21. the single-instance solvers on lane tensors: minimize(method="bfgs",
     layout="batched") on config #4a's 10000 16-D bowls (f32, max_iter=30,
     the centers and scales through data=), K4c launched once a host step
     in its form K4c-r and no other kernel, solved share at least 0.999,
     its first 2048 lanes against the same call on the host; a wide arm of
     256 bowls of 256 dimensions, K4c-g once a host step and no other
     kernel, 4 lanes against the host; lbfgs, lbfgsb (in a box that
     binds), gd, cgd, lm and coordinate on 1024 of the bowls, each to its
     minimum, and on 256 in f64 against the host (counters equal but
     coordinate's function calls, which are reported); brent on 1024 1-D
     bowls and on 256 in f64 against the host; F2: the SANN, PSO and plain
     DE routes on Rosenbrock written on one point at B = n = 2, f_value
     the objective at x;
 22. timing: bench_bfgs_batch (median of 5 after 2 warm-ups) beside
     bench_bfgs_fleet on the same 10000 bowls, profile_bfgs_batch, and
     its wide arm (256 bowls of 256 dimensions, K4c-g);
 23. the derivative-free single-instance solvers on lane tensors (no
     kernel): nelder_mead (both variants), the row-layout de, pso (vanilla,
     and accelerated in a box), sann and nmpso on 384 lanes of 4-D bowls,
     Rosenbrock and Rastrigin in float32 and float64 (the reference variant
     in float64), the draws made from one seed: the card against the same
     call on the host, by route and kind of problem (the lanes whose
     counters differ and x, where they agree and where they differ, within
     free_limits of the readings in FREE_READ32), and lane 0 alone through
     minimize(fn, x0[n]) against the batch's; minimize(rosen, [-0.5, -0.5])
     with no method named; restarts=8 on Halton starts for nelder_mead and
     bfgs against the host, K4c (K4c-r) launched once a host step of the
     bfgs restart lanes;
 24. timing (the median of 2 runs): bench_nm_rosenbrock and
     bench_latency_single (NM, DE, BFGS) as chains of 4 dependent solves
     (the benches' default is 64), a
     profile of each single solve, bench_lm_fleet (fit_fleet against
     fit_batched at B = 4096) and the row-layout arm of bench_pso_sann_100d
     at B = 256 with its profile;
 25. the CMA-ES on lane tensors (no kernel): minimize(rastrigin,
     x0[65536, 16] = -0.5, method="cmaes", layout="batched") with
     pop_size=12, 50 generations and every other termination rule off, in
     float32, under eigh_method="xla" and "jacobi" (the median best value
     from 324, below the fleet's limit of 80), and cmaes.step on the same
     lanes timed (ms a generation over 50 generations, 10 with "jacobi",
     beside the fleet's); 256 lanes of 4-D bowls, Rosenbrock and bounded bowls in
     float64 with "jacobi", pop_size=8 and injected draws for 30
     generations, against the same call on the host (counters equal, the
     floats within rtol 1e-10); restarts=8 on the CMA-ES as one batch (one
     drive, B = 8);
 26. the reference replays and trajectories (no kernel): every pair of
     tests/data/reference_trajectories.tsv on the card through
     nlsolver_torch.parity (trace.trajectory for the traced families,
     minimize per k for gd_anneal, brent_min and the root finders) under
     the JAX suite's DX_TOL and counter rules, the 30 exact pairs bit-exact;
     the first 4096 variates of each reference generator in float32 and
     float64 and of mt19937(42) bit-equal to the host's; a DE replay on
     10-D Rosenbrock (pop_size=50, 20 generations) bit-equal to the host's,
     with the seconds a generation of each replay on the card and on the
     host; how often the card's log, exp, cos, sin and sqrt part from the
     C library's (which the replays, and McCormick's golden runs, take);
 27. the mesh engines on a world of one NCCL rank (parallel.distributed,
     make_mesh(dp=1, pop=1); gloo beside it for the host's mesh), each after
     a warm-up against its unsharded engine on the same inputs (unsharded,
     sharded, sharded, unsharded; the result bit-equal, the same launches,
     no plain twin called, the wrapper's (sharded - unsharded) / unsharded
     printed; benches.mesh.run_routes): minimize(method="bfgs",
     layout="sharded") on 65536 16-D bowls (a scale a coordinate, the
     centers as start points; K4a), fit_fleet_sharded on the 262144 exp fits through
     "qr_pallas" (K2b-r) and "cholesky" (K3-r), minimize(method="cmaes",
     layout="sharded") on 65536 16-D Rastrigin strategies for 50
     generations (K5r), the PSO and SANN sharded fleets on 8192 100-D
     Rastrigin instances for 100 iterations, fit_sharded on 8192 exp fits
     (no kernel), and de_sharded on 8192 10-D Rastrigin instances of 64
     agents (Philox draws, no kernel) to convergence, its 256 first lanes
     in float64 against the same run on the host; then at full width with
     no kernel and no plain twin (benches.mesh.run_pso, run_islands,
     run_lbfgs): the population-sharded PSO on the same instances in their
     box of width 10.24 (PSOConfig(n_particles=64, max_iter=1000)), the
     island DE on them, eager and fused (DEConfig(pop_size=64,
     max_iter=1000), a migration every 10 generations), each in float32
     and on its first lanes in float64 (256 for the PSO, 128 for the
     islands; to max_iter) against the same run on the host, and the dimension-sharded L-BFGS on the coupled
     quadratic and its weighted form at n = 2^23 in float64 (max |x - t|
     < 1e-4), against the host at n = 2^16; each engine is timed after a
     short warm-up; the process group is destroyed at the end;
 28. bench_qr_shapes (K2a-w, K2b's register and shared forms, the library's
     QR and the plain wavefront; 5 chained calls a run) and
     bench_de_fused_sweep (P = 128, 256, 512 at 2^18 agents, 50 generations,
     K1's staged form against the plain step), their launches counted.

Every kernel's line also gives its bound: the larger of its compulsory
bytes over 3.35 TB/s and its floating-point operations over 67 TFLOP/s
(f32 outside the tensor cores; f64 too, the FP64 tensor cores' rate),
computed from the run's shapes; K1's
staged, cluster and global forms, K2b's register and warp forms, K2a-w,
K4b-c, K4b-t, K4b and K3's register and warp forms also the floor of their
instruction issue (``issue_ms``), which must lie below their time.

The rows of K4a, K2b-r, K3-r, K5r, K2a-w and K1s also name the launches of
phases 27 and 28, those of K2b-p and K3-b the dispatcher calls of phases 8
and 7 (``more_launches``); those of K2a-p, K2b-p and K3-b their times at
their other shapes (``more_shapes``).

Prints a JSON line of kernels, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA card or anything fails.
"""
import dataclasses
import functools
import json
import subprocess
import sys
import time

B, N, P = 8192, 10, 64
DE_WIDE = (256, 29, 1024, 20)  # a DE fleet past K1's staged form: instances, n, P, generations
RTOL = ATOL = 1e-5  # scores: the same terms summed in another order
TPU_KERNEL = "nlsolver_tpu/ops/de_fused.py:110"
FLEET_B, FLEET_M = 262144, 32  # the NLLS fleet: fits, points per fit
BFGS_B, BFGS_N = 65536, 16     # the BFGS fleet: bowls, dimensions
WIDE_B, WIDE_N = 4096, 128     # the wide BFGS fleet, beyond K4a's resident slab (K4b-c)
WIDE_K4B_B, WIDE_K4B_N = 256, 225  # a wide BFGS fleet past K4b-c's range in f32 (K4b-t)
STREAM_N = 320                 # a wide BFGS fleet past a cluster of 16's rows (B = WIDE_K4B_B)
K4CG_N, K4CG_B = 256, 256      # the single-instance BFGS's wide arm, past K4c-w's block (K4c-g)
K4C = {"rows": "K4c-r", "warp": "K4c-w", "global": "K4c-g"}  # K4c's forms by batched_form's names
CHEB_SHARED = (12, 32, 16384)  # Chebyshev NLLS fleets: coefficients, points, fits; through
CHEB_WARP = (30, 48, 4096)     # K2b's shared-memory and warp forms (float32), and past the
CHEB_CLUSTER = (120, 128, 256)  # warp form's range in float64 through its cluster form
K3G_N, K3G_B = 240, 16         # an SPD solve past K3-w's range in float64 (K3-c)
K3D_N, K2BD_N = 646, 330       # the first n past K3-c's and K2b-c's ranges in float64 (K3-d, K2b-d)
K2AD_N = 333                   # the first square m = n past K2a-c's range in float64 with Q (K2a-d)
# the first square m = n past K2a-d's range with Q (K2a-p), by dtype, and
# the first that K2a-p forms in two panels in float64 (on one lane)
K2AP_N = {"float32": 1875, "float64": 1321}
K2AP_PANELS_N = 1849
K3B_N = {"float64": 2458, "float32": 3600}  # the first n past K3-d's range (K3-b), by dtype
# the first n past K2b-d's range (K2b-p), by dtype; K2b-p's first square
# shape in two panels in float64 (on one lane); a Chebyshev fleet of 1263
# coefficients on 1280 points in float64, its augmented system [2543, 1263,
# 2] through K2b-p: coefficients, points, fits
K2BP_N = {"float64": 1263, "float32": 1848}
K2BP_PANELS_N = 1849
CHEB_PANEL = (1263, 1280, 2)
CMA_B, CMA_N, CMA_GENS = 65536, 16, 50   # the CMA-ES fleet: strategies, dimensions, generations
CMA_WIDE_B = 4096              # the wide CMA-ES fleets: n = 56 and n = 64 (K5a)
CMA_EDGE_N, CMA_EDGE_B = 170, 256  # the first n that K5a refuses in f32 (K5c), the fleet's B there
CMA_C4_N = 300                 # a wide fleet on clusters of 4 CTAs
K5B_N, K5B_B, K5B_SWEEPS = 473, 16, 2  # the first n that K5c refuses in f32, few lanes and sweeps
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside the tensor cores
F64_FLOPS = 67e12              # H100 SXM float64 rate of the tensor cores (DMMA)


# the SM clock's maximum in MHz (nvidia-smi), read in phase 1 for the issue floors
FLOORS = {}
# the seconds each phase took, by its number (phase)
PHASE_SECONDS = {}


def issue_floor(instructions, threads):
    """The least time in ms in which the card issues ``instructions`` a
    thread for ``threads`` threads: 4 warp-instructions a clock on each of
    its 132 SMs at the SM clock's maximum."""
    return instructions * -(-threads // 32) / (4 * 132 * FLOORS["mhz"] * 1e6) * 1e3


def bound(nbytes, flops, f64=False):
    """The least time the card could take, in ms, and what sets it: every
    input byte read once and every output byte written once over the
    memory rate, against the operations over the float32 (``f64``: the
    float64) rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / (F64_FLOPS if f64 else F32_FLOPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def givens_ops(m, n, extra):
    """Operations of the Givens wavefront on one [m, n] system: per zeroed
    entry (i, j) some 10 for the coefficients and 6 per rotated column
    pair, over the n - j columns of R left and ``extra`` more (Q's m
    columns, or the right-hand side)."""
    return sum((m - 1 - j) * (10 + 6 * (n - j + extra)) for j in range(min(n, m - 1)))


def de_bound(b, n, p):
    """K1's bound: agents and scores in and out, the active mask; 30
    floating-point operations a coordinate."""
    return bound((2 * n * p + 2 * p) * b * 4 + b, 30 * n * p * b)


def lstsq_bound(m, n, b, f64=False):
    """K2b's bound in f32 (or f64): A and y in, x out; givens_ops a lane."""
    return bound((m * n + m + n) * b * (8 if f64 else 4), givens_ops(m, n, 1) * b, f64)


def qr_bound(n, b, f64=False):
    """K2a's bound with Q on [n, n, b] in f32 (or f64): A in, R and Q out;
    givens_ops a lane with Q's n columns."""
    return bound(3 * n * n * b * (8 if f64 else 4), givens_ops(n, n, n) * b, f64)


def spd_bound(n, b, f64=False):
    """K3's bound in f32 (or f64): A's lower triangle and b in, x out; n^3 /
    3 + 2 n^2 operations a lane."""
    return bound((n * (n + 1) // 2 + 2 * n) * b * (8 if f64 else 4),
                 (n ** 3 / 3 + 2 * n * n) * b, f64)


def rank2_bound(n, b, direction=True):
    """K4's bound in f32: H in and out, the vectors, rho (and reset); some
    13 n^2 operations a lane with the direction, 11 n^2 without."""
    words = 2 * n * n + (4 * n if direction else 2 * n) + 1
    return bound(words * b * 4 + (b if direction else 0), (13 if direction else 11) * n * n * b)


def jacobi_bound(n, b, sweeps):
    """K5's bound in f32: A in, w and V out; per round 9 n^2 operations on
    A's rows and the columns of A and V and some 12 n for the rotations,
    over ``sweeps`` sweeps of n - 1 rounds (n for odd n)."""
    rounds = n - 1 if n % 2 == 0 else n
    return bound((2 * n * n + n) * b * 4, sweeps * rounds * (9 * n * n + 12 * n) * b)


def log(msg):
    print(msg, flush=True)


def phase(number, fn, *args):
    """Runs phase ``number`` (``fn(*args)``) and keeps the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[number] = round(time.perf_counter() - t0, 1)
    return out


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
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
    check(clock.returncode == 0, f"nvidia-smi failed: {clock.stderr.strip()}")
    FLOORS["mhz"] = float(clock.stdout.split()[0])
    return name


def loop_opcodes(ins, h, e):
    """The opcodes (no modifiers) of SASS ``ins`` from index h to e."""
    return [op.split()[1 if op.startswith("@") else 0].split(".")[0] for _, op in ins[h:e + 1]]


def warp_floor(ins, m, n, b):
    """The issue floor of K2b's warp form on [m, n, b], n < 32 (one word a
    thread a row), from its SASS ``ins``: its stage loop, the one loop that
    holds a block barrier, passes back m + n - 3 times, and its rotation
    loop, the one loop within it that stores to shared memory, once less
    than the stage's columns every stage; every other loop is counted on no
    pass back.  Returns (instructions, way, stage body, rotation body)."""
    from nlsolver_torch.benches import backward_branches, issue_instructions

    way, bodies = issue_instructions(ins)
    spans = backward_branches(ins)

    def opcodes(h, e):
        return set(loop_opcodes(ins, h, e))

    stage = [i for i, (h, e) in enumerate(spans) if "BAR" in opcodes(h, e) and bodies[i]]
    check(len(stage) == 1, f"K2b-w's SASS has loops {bodies}, {len(stage)} with a block barrier")
    h0, e0 = spans[stage[0]]
    turn = [i for i, (h, e) in enumerate(spans) if h0 < h and e < e0 and "STS" in opcodes(h, e)
            and "BAR" not in opcodes(h, e) and bodies[i]]
    check(len(turn) == 1, f"K2b-w's SASS has loops {bodies}, {len(turn)} rotation loops")
    stages = m + n - 2
    passes = sum(max(0, min(n - 1, k // 2) - max(0, k - m + 2)) for k in range(stages))
    body_s, body_t = bodies[stage[0]], bodies[turn[0]]
    return way + (stages - 1) * body_s + passes * body_t, way, body_s, body_t


def qr_warp_floor(ins, m, n):
    """The issue floor of K2a-w on [m, n] with Q, m + n <= 32 (one column
    a thread a row), from its SASS ``ins``: its stage loop, the one loop
    that holds another, passes back m + n - 3 times, and its rotation loop,
    the one loop within it, once less than the stage's rotations every
    stage; every other loop is counted on no pass back.  Returns
    (instructions a warp, way, stage body, rotation body)."""
    from nlsolver_torch.benches import backward_branches, issue_instructions

    way, bodies = issue_instructions(ins)
    spans = backward_branches(ins)
    live = [i for i, b in enumerate(bodies) if b]
    inside = {i: [j for j in live if j != i and spans[i][0] <= spans[j][0]
                  and spans[j][1] <= spans[i][1]] for i in live}
    outer = [i for i in live if inside[i]]
    check(len(outer) == 1 and len(inside[outer[0]]) == 1,
          f"K2a-w's SASS has loops {bodies}, {len(outer)} holding others")
    body_s, body_t = bodies[outer[0]], bodies[inside[outer[0]][0]]
    stages = m + n - 2
    passes = sum(max(0, min(n - 1, k // 2) - max(0, k - m + 2)) for k in range(stages))
    return way + (stages - 1) * body_s + passes * body_t, way, body_s, body_t


def cluster_floor(ins, n):
    """The issue floor of K4b-c on n rows a lane, a thread a row and lane,
    from its SASS ``ins`` (float32): every iteration of its sums over j (Hy
    and y^T Hy, 2 n a thread: the innermost loops that add (FADD) what they
    read from shared memory and store nothing) and of its row updates (n a
    thread: the innermost loops that store to shared memory and add) costs
    at least the least instructions an iteration of its kind's loops take
    (a loop's body over its FADDs, or its STSs, one an iteration); one pass
    of each loop is left to the way through.  Returns (instructions a
    thread, way, [(kind, body, iterations a pass)])."""
    from nlsolver_torch.benches import backward_branches, issue_instructions

    way, bodies = issue_instructions(ins)
    spans = backward_branches(ins)
    live = [i for i, b in enumerate(bodies) if b]
    innermost = [i for i in live if not any(j != i and spans[i][0] <= spans[j][0]
                                            and spans[j][1] <= spans[i][1] for j in live)]
    kinds = {"sum": [], "row": []}
    for i in innermost:
        ops = loop_opcodes(ins, *spans[i])
        if "FADD" in ops and "LDS" in ops and not {"STS", "STG", "LDGSTS", "LD"} & set(ops):
            kinds["sum"].append((bodies[i], ops.count("FADD")))
        elif "FADD" in ops and "FMUL" in ops and "STS" in ops and not {"STG", "LDGSTS"} & set(ops):
            kinds["row"].append((bodies[i], ops.count("STS")))
    check(kinds["sum"] and kinds["row"], f"K4b-c's SASS has no loops of each kind: {kinds}")
    count = way
    for kind, iterations in (("sum", 2 * n), ("row", n)):
        loops = kinds[kind]
        cheapest = min(body / per for body, per in loops)
        count += max(0, iterations - sum(per for _, per in loops)) * cheapest
    return int(count), way, kinds


def spd_warp_floor(ins, n, b, lanes):
    """The issue floor of K3-w on [n, n, b] with ``lanes`` warps a block,
    from its SASS ``ins``: every warp passes back through its fetch loop
    (the outer loop that holds LDGSTS) once less than the 32-entry strides
    of the n (n + 3) / 2 entries it takes, through its step loop (the outer
    loop with a warp barrier) n - 1 times, and each step through the
    trailing update's two loops (those in it that add: FADD; the one that
    holds a loop walks the rows past the table's 32) once less than thread
    0's passes through each; warp 0 of each block passes back through the
    back solve's row loop (the outer loop after the step loop that holds
    two) n - 1 times and through its four-term loop (the first of the two)
    once less than row i's whole passes.  Every other loop is counted on no
    pass back.  Returns (warp-instructions in all, way, {loop: body})."""
    from nlsolver_torch.benches import backward_branches, issue_instructions

    way, bodies = issue_instructions(ins)
    spans = backward_branches(ins)
    live = [i for i, body in enumerate(bodies) if body]
    inside = {i: [k for k in live if k != i and spans[i][0] <= spans[k][0]
                  and spans[k][1] <= spans[i][1]] for i in live}
    outer = [i for i in live if not any(i in inside[k] for k in live)]
    fetch = [i for i in outer if "LDGSTS" in loop_opcodes(ins, *spans[i])]
    step = [i for i in outer if any(".DIV" in op for _, op in ins[spans[i][0]:spans[i][1] + 1])]
    check(len(fetch) == 1 and len(step) == 1, f"K3-w's SASS has outer loops {outer}: "
          f"{len(fetch)} fetching, {len(step)} with a warp barrier")
    adds = [k for k in inside[step[0]] if "FADD" in loop_opcodes(ins, *spans[k])]
    table = [k for k in adds if not inside[k]]
    walk = [k for k in adds if inside[k]]
    back = [i for i in outer if spans[i][0] > spans[step[0]][1] and len(inside[i]) == 2]
    check(len(table) == 1 and len(walk) == 1 and len(back) == 1,
          f"K3-w's SASS: {len(table)} and {len(walk)} trailing loops, {len(back)} back solves")
    four = min(inside[back[0]], key=lambda k: spans[k][0])
    rows32 = 32 * 33 // 2  # the table's entries; thread 0 walks on from the next stride, 544
    passes = [0, 0]
    for j in range(n):
        count = (n - j) * (n - j + 1) // 2 - 1
        passes[0] += max(0, -(-min(count, rows32) // 32) - 1)
        passes[1] += max(0, -(-(count - rows32 - 16) // 32) - 1)
    entries = n * (n + 3) // 2
    per_warp = (way + max(0, -(-(entries - 31) // 32) - 1) * bodies[fetch[0]]
                + (n - 1) * bodies[step[0]] + passes[0] * bodies[table[0]]
                + passes[1] * bodies[walk[0]])
    per_block = ((n - 1) * bodies[back[0]]
                 + sum(max(0, (n - 1 - i) // 4 - 1) for i in range(n)) * bodies[four])
    count = per_warp * b + per_block * -(-b // lanes)
    return count, way, {"fetch": bodies[fetch[0]], "step": bodies[step[0]],
                        "table": bodies[table[0]], "walk": bodies[walk[0]],
                        "back": bodies[back[0]], "four terms": bodies[four]}


def phase_build():
    import torch

    from nlsolver_torch.benches import floor_plans, issue_floors, issue_instructions, sass_functions
    from nlsolver_torch.ops import _build

    t0 = time.perf_counter()
    path, out = _build.ensure_built()
    _build.load_library()
    log(f"[2] built {path.name} in {time.perf_counter() - t0:.2f} s")
    t1 = time.perf_counter()
    sass = sass_functions(path)
    log(f"[2] the library's SASS, {len(sass)} kernels, listed in {time.perf_counter() - t1:.1f} s")
    # the issue floors of the timed launches (benches.issue_instructions).
    # K1's staged form at the headline, Rastrigin on Philox draws (the
    # kernel built for them): at n = 10 a lane passes back through no loop.
    # K2b's register form at the NLLS fleet, m = 34, n = 2: its three stage
    # loops, the ramp where column 1 waits, the stages where every column
    # rotates and the ramp where column 0 is done, run 2 n - 2, m - 2 n + 1
    # and n - 1 stages, so their backward branches are taken at least 1, 30
    # and 0 times
    m = FLEET_M + 2
    # K3-r at the NLLS fleet, n = 2: no loop
    for kid, key, back, threads in (
            ("K1s", ("de_staged_kernel", "Rastrigin", f"Li{N}ELb1E"), (), B * P),
            ("K2b-r", ("least_squares_registers_kernelIfLi2E",), (1, m - 4, 0), FLEET_B),
            ("K3-r", ("chol_registers_kernelIfLi2E",), (), FLEET_B)):
        name = next(k for k in sass if all(part in k for part in key))
        way, bodies = issue_instructions(sass[name])
        if kid == "K2b-r":
            check(len(bodies) == len(back) and None not in bodies and bodies[1] == max(bodies),
                  f"K2b-r's SASS has loops {bodies}, expected 3, the unguarded one the dearest")
        count = way + sum(t * body for t, body in zip(back, bodies))
        FLOORS[kid] = issue_floor(count, threads)
        log(f"[2] issue floor of {kid}: {count} SASS instructions a thread ({len(sass[name])} in "
            f"the kernel; {way} on its shortest way through, loop bodies {bodies} taken again "
            f"{list(back)} times), {threads} threads, {FLOORS['mhz']:.0f} MHz: "
            f"{FLOORS[kid] * 1e3:.2f} us")
    # K2b's warp form at the Chebyshev fleet of CHEB_WARP coefficients, a
    # warp a lane
    n, pts, b = CHEB_WARP
    name = next(k for k in sass if "least_squares_warp_kernelIfLi1E" in k)
    count, way, body_s, body_t = warp_floor(sass[name], pts + n, n, b)
    FLOORS["K2b-w"] = issue_floor(count, 32 * b)
    log(f"[2] issue floor of K2b-w: {count} SASS instructions a warp ({len(sass[name])} in the "
        f"kernel; {way} on its shortest way through, the stage loop's body {body_s} and the "
        f"rotation loop's {body_t}), {b} warps, {FLOORS['mhz']:.0f} MHz: "
        f"{FLOORS['K2b-w'] * 1e3:.2f} us")
    # K3-w at the Chebyshev fleet of CHEB_WARP coefficients, a warp a lane
    from nlsolver_torch.ops.smallchol import warp_lanes

    n, b = CHEB_WARP[0], CHEB_WARP[2]
    name = next(k for k in sass if "chol_warp_kernelIfE" in k)
    count, way, loops = spd_warp_floor(sass[name], n, b, warp_lanes(n, torch.float32))
    FLOORS["K3-w"] = issue_floor(count, 32)
    log(f"[2] issue floor of K3-w: {count} SASS warp-instructions at [{n}, {n}, {b}] "
        f"({len(sass[name])} in the kernel; {way} on its shortest way through, loop bodies "
        f"{loops}), {FLOORS['mhz']:.0f} MHz: {FLOORS['K3-w'] * 1e3:.2f} us")
    # K2a-w at the timed [16, 16, 4096] with Q, a warp a lane (one column a
    # thread); K4b-c at the wide fleet's [128, 128, 4096], a thread a row
    # and lane, 16-byte copies
    name = next(k for k in sass if "qr_warp_kernelIfLb1ELi1E" in k)
    count, way, body_s, body_t = qr_warp_floor(sass[name], 16, 16)
    FLOORS["K2a-w"] = issue_floor(count, 32 * 4096)
    log(f"[2] issue floor of K2a-w: {count} SASS instructions a warp ({len(sass[name])} in the "
        f"kernel; {way} on its shortest way through, the stage loop's body {body_s} and the "
        f"rotation loop's {body_t}), 4096 warps, {FLOORS['mhz']:.0f} MHz: "
        f"{FLOORS['K2a-w'] * 1e3:.2f} us")
    name = next(k for k in sass if "rank2_cluster_kernelIfLi4E" in k)
    count, way, kinds = cluster_floor(sass[name], WIDE_N)
    FLOORS["K4b-c"] = issue_floor(count, WIDE_N * WIDE_B)
    log(f"[2] issue floor of K4b-c: {count} SASS instructions a thread ({len(sass[name])} in the "
        f"kernel; {way} on its shortest way through; loops (body, iterations a pass) of the sums "
        f"{kinds['sum']} and the row updates {kinds['row']}), {WIDE_N * WIDE_B} threads, "
        f"{FLOORS['mhz']:.0f} MHz: {FLOORS['K4b-c'] * 1e3:.2f} us")
    # K1c and K1g at the wide DE fleet's shape, K4b-t and K4b at [225, 225,
    # 256]: the fewest instructions on a way through each launch that
    # passes the marked instructions a thread must issue
    # (benches.floor_plans, benches.unit_floor)
    plans = floor_plans(WIDE_K4B_N, WIDE_K4B_B, DE_WIDE[:3])
    t1 = time.perf_counter()
    floors = issue_floors(("K1c", "K1g", "K4b-t", "K4b"), plans, path, FLOORS["mhz"])
    for kid, floor in floors.items():
        FLOORS[kid] = floor["us"] / 1e3
        log(f"[2] issue floor of {kid}: " + "; ".join(
            f"{x['kernel']} {x['instructions']} SASS instructions a thread ({x['in_kernel']} in "
            f"the kernel; {x['units']} marked), {x['threads']} threads" for x in floor["launches"])
            + f"; {FLOORS['mhz']:.0f} MHz: {floor['us']:.2f} us")
    log(f"[2] the four floors above took {time.perf_counter() - t1:.1f} s")
    # ptxas names a kernel, then its stack frame and spills, then its registers.
    # The register forms of K5, K2b and K3 are one kernel per width (K5r also
    # per parity): no word of theirs may live in local memory
    import re

    from nlsolver_torch.ops.qr_wavefront import REGISTER_MAX_N, warp_fits
    from nlsolver_torch.ops.smallchol import REGISTER_MAX_N as SPD_REGISTER_MAX_N

    entries = []  # [short name, stack and spill line, registers line]
    for line in out.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            # the identifier after the anonymous namespace, then its template arguments
            m_id = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            short = mangled
            if m_id:
                at = m_id.end()
                size = int(m_id.group(1))
                short = mangled[at:at + size] + " " + mangled[at + size:].split("Ev")[0]
            entries.append([short, "", ""])
        elif entries and "spill" in line:
            entries[-1][1] = line.strip()
        elif entries and "Used" in line:
            entries[-1][2] = line.strip()
    kinds = {"eigh_jacobi_registers_kernel": ("K5r", f"IfLi{CMA_N}ELb0E"),  # <float, n, even>
             "least_squares_registers_kernel": ("K2b", "IfLi2E"),         # <float, the fleet's n>
             "least_squares_warp_kernel": ("K2b-w", "IfLi1E"),            # <float, a word a row>
             "chol_registers_kernel": ("K3-r", "IfLi2E"),                 # <float, the fleet's n>
             "least_squares_cluster_kernel": ("K2b-c", "IdE"),            # <double>, its fleet's
             "chol_cluster_kernel": ("K3-c", "IdLb0E"),                   # <double, main path's>
             "least_squares_distributed_kernel": ("K2b-d", "IdE"),        # <double>, its path's
             "chol_distributed_kernel": ("K3-d", "IdE"),                  # <double>, its path's
             "qr_cluster_kernel": ("K2a-c", "IfE"),                       # <float>, its path's
             "qr_distributed_kernel": ("K2a-d", "IdE"),                   # <double>, its path's
             "qr_panel_kernel": ("K2a-p", "IdE"),                         # <double>, its path's
             "qr_replay_kernel": ("K2a-p's replay", "IdE"),               # <double>, its path's
             "lstsq_panel_kernel": ("K2b-p", "IdE"),                      # <double>, its path's
             "lstsq_backsolve_kernel": ("K2b-p's back solve", "IdE"),     # <double>, its path's
             "chol_blocked_kernel": ("K3-b", "IdLb0E"),                   # <double, main path's>
             "rank2_batched_rows_kernel": ("K4c-r", "IfLi16ELi4ELb0E")}   # <float, 16, float4, straight>
    used, main, local = {"K5r": [], "K2b": [], "K2b-w": [], "K3-r": [], "K2b-c": [],
                         "K3-c": [], "K2b-d": [], "K3-d": [], "K2a-c": [], "K2a-d": [],
                         "K2a-p": [], "K2a-p's replay": [], "K2b-p": [], "K2b-p's back solve": [],
                         "K3-b": [], "K4c-r": []}, {}, []
    for short, spill, regs in entries:
        kind = next((v for k, v in kinds.items() if short.startswith(k)), None)
        count = int(regs.split("Used")[1].split()[0]) if "Used" in regs else -1
        if kind is None or kind[0] != "K5r":
            log(f"[2] ptxas: {short}: {count} registers; {spill}")
        if kind is None:
            continue
        used[kind[0]].append(count)
        if kind[1] in short:
            main[kind[0]] = count
        # K3-b's probes' kernel (<T, true>) is not held
        probe = kind[0] == "K3-b" and "Lb1E" in short
        if not probe and "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" not in spill:
            local.append(f"{short}: {spill}")
    if out:
        check(not local, "register kernels of K5, K2b, K3 or K4c, or the warp, cluster, "
              "distributed or panel form of K2b, the cluster, distributed or panel form of K2a "
              "or the cluster, distributed or blocked form of K3 use local memory: "
              + "; ".join(local))
        for kid in ("K3-b", "K3-c"):
            check(len(used[kid]) == 4, f"ptxas reported {len(used[kid])} kernels of {kid}, "
                  "expected the main path's and the probes' per dtype")
            log(f"[2] ptxas: {kid}, 4 kernels (float32, float64; the main path's and the "
                f"probes'): {min(used[kid])} to {max(used[kid])} registers a thread, "
                f"{main.get(kid)} in the main path's float64; "
                + ("the main path's" if kid == "K3-b" else "each") + " 0 bytes of stack frame, "
                "0 bytes spilled")
        # K4c-r: one kernel per room of 4, 8, 16 or 32 words a row, way in
        # (straight by 16-byte or one-word accesses, or staged), and dtype
        k4cr = used["K4c-r"]
        check(len(k4cr) == 24, f"ptxas reported {len(k4cr)} kernels of K4c-r, expected 24")
        log(f"[2] ptxas: rank2_batched_rows_kernel, {len(k4cr)} kernels: {min(k4cr)} to "
            f"{max(k4cr)} registers a thread, {main.get('K4c-r')} at n = {BFGS_N} in float32, "
            "0 bytes of stack frame, 0 bytes spilled")
        for kid in ("K2b-c", "K2b-d", "K3-d", "K2a-c", "K2a-d", "K2a-p", "K2a-p's replay",
                    "K2b-p", "K2b-p's back solve"):
            check(len(used[kid]) == 2, f"ptxas reported {len(used[kid])} kernels of {kid}, "
                  "expected one per dtype")
            log(f"[2] ptxas: {kid}, {len(used[kid])} kernels (float32, float64): "
                f"{min(used[kid])} to {max(used[kid])} registers a thread, {main.get(kid)} in "
                f"{'float32' if kid == 'K2a-c' else 'float64'}, 0 bytes of stack frame, 0 bytes "
                "spilled")
        k5r, k2b, k2bw, k3r = used["K5r"], used["K2b"], used["K2b-w"], used["K3-r"]
        check(len(k3r) == sum(SPD_REGISTER_MAX_N.values()),
              f"ptxas reported {len(k3r)} register kernels of K3, expected one per n and dtype")
        check(len(k5r) > 0, "ptxas reported no register kernel of K5")
        check(len(k2b) == sum(REGISTER_MAX_N.values()),
              f"ptxas reported {len(k2b)} register kernels of K2b, expected one per n and dtype")
        # one kernel of the warp form per dtype and words a thread a row
        words = [-(-(max(n for n in range(1, 512) if warp_fits(n, dt)) + 1) // 32)
                 for dt in (torch.float32, torch.float64)]
        check(len(k2bw) == sum(words),
              f"ptxas reported {len(k2bw)} kernels of K2b's warp form, expected {sum(words)}")
        log(f"[2] ptxas: eigh_jacobi_registers_kernel, {len(k5r)} kernels (float32 and float64, "
            f"every even width, both parities of n): {min(k5r)} to {max(k5r)} registers a "
            f"thread, {main.get('K5r')} at n = {CMA_N} in float32, 0 bytes of stack frame, "
            "0 bytes spilled")
        log(f"[2] ptxas: least_squares_registers_kernel, {len(k2b)} kernels (n = 1 to "
            f"{REGISTER_MAX_N[torch.float32]} in float32, 1 to {REGISTER_MAX_N[torch.float64]} in "
            f"float64): {min(k2b)} to {max(k2b)} registers a thread, {main.get('K2b')} at n = 2 "
            "in float32, 0 bytes of stack frame, 0 bytes spilled")
        log(f"[2] ptxas: chol_registers_kernel, {len(k3r)} kernels (n = 1 to "
            f"{SPD_REGISTER_MAX_N[torch.float32]} in float32, 1 to "
            f"{SPD_REGISTER_MAX_N[torch.float64]} in float64): {min(k3r)} to {max(k3r)} registers "
            f"a thread, {main.get('K3-r')} at n = 2 in float32, 0 bytes of stack frame, 0 bytes "
            "spilled")
        log(f"[2] ptxas: least_squares_warp_kernel, {len(k2bw)} kernels (1 to {words[0]} words a "
            f"thread a row in float32, 1 to {words[1]} in float64): {min(k2bw)} to {max(k2bw)} "
            f"registers a thread, {main.get('K2b-w')} at one word in float32, 0 bytes of stack "
            "frame, 0 bytes spilled")


def de_forms():
    from nlsolver_torch.ops import de_fused as tdf

    return {"K1s": tdf.de_generation_staged, "K1c": tdf.de_generation_cluster,
            "K1g": tdf.de_generation_global}


def phase_injected(torch, dev):
    from nlsolver_torch import PROBLEMS
    from nlsolver_torch.ops import de_fused as tdf
    from nlsolver_torch.solvers.de_batched import ring_offsets

    F, CR = 0.8, 0.9
    worst = 0.0
    forms = de_forms()

    def hold(fn, agents, scores, offs, active, u, fdim, kids, label):
        """Each form of ``kids`` on injected draws against the twin: the
        proposals bit-equal where the accept masks agree, the scores within
        RTOL / ATOL, frozen lanes unchanged.  Returns the first form's
        result and the twin's, and the lanes whose masks differ."""
        nonlocal worst
        twin = tdf.de_generation_reference(fn, agents, scores, offs, u, fdim, active, F, CR)
        first, differ = None, 0
        for kid in kids:
            before = forms[kid].launches
            ka, ks = forms[kid](fn, agents, scores, offs, active, seed=0, generation=0, u=u,
                                fdim=fdim)
            torch.cuda.synchronize()
            check(forms[kid].launches == before + 1, f"{kid} {label}: no launch counted")
            same = (ks < scores) == (twin[1] < scores)
            check(torch.equal(ka[same[:, None, :].expand_as(ka)],
                              twin[0][same[:, None, :].expand_as(ka)]),
                  f"{kid} {label}: agents differ where the accept masks agree")
            check(torch.allclose(ks[same], twin[1][same], rtol=RTOL, atol=ATOL),
                  f"{kid} {label}: scores differ")
            near = (twin[1] - scores).abs() <= ATOL + RTOL * scores.abs()
            check(bool(near[~same].all()), f"{kid} {label}: accept masks differ off a tie")
            check(torch.equal(ka[~active], agents[~active])
                  and torch.equal(ks[~active], scores[~active]), f"{kid} {label}: a frozen lane changed")
            worst = max(worst, float((ks - twin[1])[same & active[:, None]].abs().max()))
            first = first or (ka, ks)
            differ = max(differ, int((~same).sum()))
        return first, twin, differ

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
            # every proposal accepted: proposals bit-equal, scores close
            (pk, _), (pt, _), _ = hold(fn, agents, inf, offs, active, u, fdim, list(forms),
                                       f"{name} gen {gen}, all accepted")
            check(torch.equal(pk, pt), f"{name} gen {gen}: proposals differ")
            (ka, ks), _, differ = hold(fn, agents, scores, offs, active, u, fdim, list(forms),
                                       f"{name} gen {gen}")
            log(f"[3] {name} gen {gen}: accepted {int((ks < scores).sum())}, "
                f"masks differ at {differ}")
            agents, scores = ka, ks
    # the forms at the edges of the staged one's plan, and the dispatcher's
    # choice: the proposal in registers up to n = 16 and in shared memory
    # beyond, the slab staged by plain loads where n * P is no multiple of
    # 4, the last n that one block holds at P = 1024, the cluster form past
    # it at the wide fleet's shape (phase 5) and at the last n its largest
    # cluster takes, CTAs' rows staged by plain loads (P = 1022), the global
    # form past the cluster form
    g = torch.Generator(device=dev).manual_seed(4)
    wide = (DE_WIDE[1], DE_WIDE[2], DE_WIDE[0])
    forms_of = {"staged": ["K1s", "K1g"], "cluster": ["K1c", "K1g"], "global": ["K1g"]}
    for n, p, b in ((16, 64, 999), (17, 64, 999), (3, 7, 5000), (28, 1024, 9), wide,
                    (453, 1024, 3), (40, 1022, 5), (454, 1024, 2)):
        fn = PROBLEMS["rastrigin"].fn
        agents = (torch.rand((b, n, p), generator=g, device=dev) - 0.5) * 5.0
        scores = tdf.eval_columns(fn, agents)
        active = torch.arange(b, device=dev) % 3 != 0
        u = torch.rand((b, n, p), generator=g, device=dev)
        fdim = torch.randint(0, n, (b, p), generator=g, device=dev)
        offs = (1, p // 3 + 1, p - 1)
        kids = forms_of[tdf.generation_form(n, p)]
        (ka, ks), _, _ = hold(fn, agents, scores, offs, active, u, fdim, kids, f"[{b}, {n}, {p}]")
        if kids[0] == "K1c":
            # every proposal accepted: the proposals bit-equal to the twin's,
            # and agents and scores bit-equal to K1g's (the same sums)
            inf = torch.full_like(scores, float("inf"))
            every = torch.ones_like(active)
            twin = tdf.de_generation_reference(fn, agents, inf, offs, u, fdim, every, F, CR)[0]
            got = tdf.de_generation_cluster(fn, agents, inf, offs, every, seed=0, generation=0,
                                            u=u, fdim=fdim)[0]
            check(torch.equal(got, twin), f"K1c [{b}, {n}, {p}]: proposals differ from the twin")
            glob = tdf.de_generation_global(fn, agents, scores, offs, active, seed=0, generation=0,
                                            u=u, fdim=fdim)
            check(torch.equal(ka, glob[0]) and torch.equal(ks, glob[1]),
                  f"K1c [{b}, {n}, {p}]: agents or scores differ from K1g")
        before = forms[kids[0]].launches
        tdf.de_generation_fused(fn, agents, scores, offs, active, seed=0, generation=0)
        check(forms[kids[0]].launches == before + 1,
              f"the dispatcher did not take {kids[0]} at n={n}, P={p}")
        plan = tdf.staged_plan(n, p) if kids[0] == "K1s" else tdf.cluster_plan(n, p)
        log(f"[3] {' and '.join(kids)} [{b}, {n}, {p}] (plan {plan}): equal to the twin"
            f"{', K1c to K1g bit for bit' if kids[0] == 'K1c' else ''}; the dispatcher takes "
            f"{kids[0]}")
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
    for kid, form in de_forms().items():
        out, _ = form(fn, agents, inf, offs, active, seed=11, generation=3)
        check(torch.equal(out, twin), f"{kid}'s Philox draws differ from the Python Philox")
    # K1c at the first shape past the staged form (the wide fleet's) and at
    # the last n its largest cluster takes: its proposals the twin's on the
    # Python Philox draws, its agents and scores K1g's
    for b, n, p in ((DE_WIDE[0], DE_WIDE[1], DE_WIDE[2]), (3, 453, 1024)):
        agents = torch.rand((b, n, p), generator=g, device=dev) - 0.5
        scores = tdf.eval_columns(fn, agents)
        every, inf = torch.ones(b, dtype=torch.bool, device=dev), torch.full_like(scores, float("inf"))
        u, fdim = tdf.philox_draws(11, 3, b, n, p, torch.float32, dev)
        twin, _ = tdf.de_generation_reference(fn, agents, inf, offs, u, fdim, every, 0.8, 0.9)
        got, _ = tdf.de_generation_cluster(fn, agents, inf, offs, every, seed=11, generation=3)
        check(torch.equal(got, twin), f"K1c [{b}, {n}, {p}]: Philox proposals differ from the twin")
        got = tdf.de_generation_cluster(fn, agents, scores, offs, every, seed=11, generation=3)
        want = tdf.de_generation_global(fn, agents, scores, offs, every, seed=11, generation=3)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"K1c [{b}, {n}, {p}]: Philox generation differs from K1g")
    log("[4] Philox mode ok; K1s, K1c and K1g bit-equal to the twin on the Python Philox draws "
        "(K1c also at [256, 29, 1024] and [3, 453, 1024], and to K1g there)")


def phase_slice(torch, dev):
    import nlsolver_torch
    from nlsolver_torch import DEConfig, PROBLEMS
    from nlsolver_torch.ops import de_fused as tdf
    from nlsolver_torch.solvers import de_batched

    fn = PROBLEMS["rastrigin"].fn
    x0 = torch.full((B, N), -0.5, device=dev)
    cfg = DEConfig(pop_size=P, partner_sampling="rotation", use_fused_kernel=True,
                   max_iter=200, eps=0.0, best_value_no_change=1 << 30)
    reset_counts()
    t0 = time.perf_counter()
    res = nlsolver_torch.minimize(fn, x0, method="de", layout="batched", config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {kid: f.launches for kid, f in de_forms().items()}
    # max_iter generations advance the lanes; one more sees the limit and
    # freezes the fleet
    generations = cfg.max_iter + 1
    log(f"[5] minimize: {wall:.3f} s, kernel launches {counts}, generations {generations}")
    check(counts == {"K1s": generations, "K1c": 0, "K1g": 0},
          f"launches {counts} for {generations} generations (K1s expected)")
    launches = {"K1s": counts["K1s"]}
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

    # a wide population past the staged form's plan: DE_WIDE's fleet
    # through the cluster form; K1g, the form it took before, by a direct
    # call on its last agents
    b, n, p, gens = DE_WIDE
    cfg = DEConfig(pop_size=p, partner_sampling="rotation", use_fused_kernel=True,
                   max_iter=gens, eps=0.0, best_value_no_change=1 << 30)
    check(tdf.staged_plan(n, p) is None, f"the staged form takes n={n}, P={p}")
    reset_counts()
    x0 = torch.full((b, n), -0.5, device=dev)
    res = nlsolver_torch.minimize(fn, x0, method="de", layout="batched", config=cfg)
    torch.cuda.synchronize()
    counts = {kid: f.launches for kid, f in de_forms().items()}
    start = float(fn(x0[:1])[0])
    log(f"[5] wide fleet [{b}, {n}], P={p}, {gens} generations: launches {counts}, best f median "
        f"{float(res.f_value.median()):.4g} from {start:.4g}")
    check(counts == {"K1s": 0, "K1c": gens + 1, "K1g": 0}, f"wide fleet: launches {counts}")
    check(bool(torch.isfinite(res.f_value).all()) and float(res.f_value.max()) < start,
          "the wide fleet did not descend")
    launches["K1c"] = counts["K1c"]
    agents = torch.rand((b, n, p), generator=torch.Generator(device=dev).manual_seed(5),
                        device=dev) - 0.5
    tdf.de_generation_global(fn, agents, tdf.eval_columns(fn, agents), (5, p // 2 - 2, p - 14),
                             torch.ones(b, dtype=torch.bool, device=dev), seed=1, generation=0)
    torch.cuda.synchronize()
    launches["K1g"] = tdf.de_generation_global.launches
    check(launches["K1g"] == 1, f"K1g's direct call counted {launches['K1g']}")
    return launches


def de_case(torch, dev, b, n, p, kernel):
    """(kernel call, twin call) of one DE generation on ``b`` instances of
    ``p`` agents in [-0.5, 0.5)^n, scored: ``kernel`` on Philox draws, the
    twin on draws from torch.rand as the plain step makes them."""
    from nlsolver_torch import PROBLEMS
    from nlsolver_torch.ops import de_fused as tdf

    fn = PROBLEMS["rastrigin"].fn
    g = torch.Generator(device=dev).manual_seed(3)
    agents = torch.rand((b, n, p), generator=g, device=dev) - 0.5
    scores = tdf.eval_columns(fn, agents)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    offs = (5, p // 2 - 2, p - 14)

    def plain():
        u = torch.rand((b, n, p), generator=g, device=dev)
        fdim = torch.randint(0, n, (b, p), generator=g, device=dev)
        tdf.de_generation_reference(fn, agents, scores, offs, u, fdim, active, 0.8, 0.9)

    return (lambda: kernel(fn, agents, scores, offs, active, seed=1, generation=0)), plain


def phase_timing(torch, dev):
    from nlsolver_torch.benches import bench_de_batched, profile_de_batched

    runs = {}
    for fused in (False, True, True, False):
        r = bench_de_batched(fused=fused)
        runs.setdefault(fused, []).append(r)
        log(f"[6] {r['name']}: median {r['median_ms']:.3f} ms / 200 gens, min "
            f"{r['min_ms']:.3f} ms, {r['iters_per_sec']:.6g} instance generations/s")
    # each form alone behind a device sleep, the twin as a plain chain: the
    # staged form at the headline's shape, the global form there too (the
    # form every shape took before the staged one), the cluster form at
    # DE_WIDE's and the global form beside it (the form that shape took
    # before the cluster one)
    forms, alone = de_forms(), {}
    b, n, p, _ = DE_WIDE
    for name, kid, shape, reps in (("K1s", "K1s", (B, N, P), 200), ("K1g n=10", "K1g", (B, N, P), 200),
                                   ("K1c", "K1c", (b, n, p), 50), ("K1g", "K1g", (b, n, p), 50)):
        kern, plain = de_case(torch, dev, *shape, forms[kid])
        (k, pl), (k1, k2, p1, p2) = abba(torch, kern, reps, plain, 10)
        alone[name] = (k, pl, None)  # no single PyTorch call computes a generation
        log(f"[6] {name} alone at {list(shape)}: kernel {k * 1e3:.2f} us of device time, plain twin "
            f"{pl * 1e3:.2f} us per chained call (CUDA events; kernel {k1 * 1e3:.2f}/"
            f"{k2 * 1e3:.2f}, twin {p1 * 1e3:.2f}/{p2 * 1e3:.2f})")
    for fused, label in ((True, "kernel path"), (False, "plain path")):
        best = max(runs[fused], key=lambda r: r["iters_per_sec"])
        log(f"[6] {label}: {best['iters_per_sec']:.6g} instance generations/s, "
            f"{best['median_ms'] / 200 * 1e3:.2f} us/generation end to end")
    # the cross-check: K1's device time a launch as torch.profiler records it
    # inside the headline fleet
    prof = profile_de_batched()
    check(prof.get("k1_launches") == 200, f"the profiled fleet shows K1 launches {prof.get('k1_launches')}")
    log(f"[6] profiled fleet: K1 {prof['k1_us']:.2f} us a launch in the trace, device busy "
        f"{prof['device_busy_ms']:.3f} of {prof['wall_ms']:.3f} ms ({prof['busy_share']:.1%}), "
        f"{prof['launches_per_generation']:.2f} device launches a generation")
    return alone


def last_fitting(fits, n):
    """The last order that ``fits`` takes, from ``n`` on, which it takes (it
    takes every order up to its last), by bisection."""
    hi = 2 * n
    while fits(hi):
        n, hi = hi, 2 * hi
    while hi - n > 1:
        mid = (n + hi) // 2
        n, hi = (mid, hi) if fits(mid) else (n, mid)
    return n


def max_diff(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def spd_forms():
    from nlsolver_torch.ops import smallchol as tsc

    return {"K3-r": tsc.solve_spd_registers, "K3-w": tsc.solve_spd_warp,
            "K3-c": tsc.solve_spd_cluster, "K3-d": tsc.solve_spd_distributed,
            "K3-b": tsc.solve_spd_blocked, "K3-g": tsc.solve_spd_batchminor_global}


K3_OF_PLAN = {"registers": "K3-r", "warp": "K3-w", "cluster": "K3-c", "distributed": "K3-d",
              "blocked": "K3-b", "global": "K3-g"}


def spd_takes(kid, n, dtype):
    """Whether ``kid`` takes order n and gives the twin's x there, by a
    direct call (K3-d up to its last n, though the dispatcher gives its
    range to K3-b): K3-b, whose back solve is not the twin's order, is held
    against its own plain version apart, past K3-c's range."""
    from nlsolver_torch.ops import smallchol as tsc

    return {"K3-r": tsc.registers_fit, "K3-w": tsc.warp_fits, "K3-c": tsc.cluster_fits,
            "K3-d": tsc.distributed_fits,
            "K3-b": lambda n, d: False}.get(kid, lambda n, d: True)(n, dtype)


def spd_residual(torch, A, x, rhs):
    """max over lanes of |A x - b| / (|A| |x|), the 2-norm of vectors and
    Frobenius norm of A."""
    r = torch.einsum("ijb,jb->ib", A, x) - rhs
    return float((r.norm(dim=0) / (A.flatten(0, 1).norm(dim=0) * x.norm(dim=0))).max())


def spd_case(torch, dev, n, b, dtype=None, seed=7):
    """``b`` SPD systems M M^T + 2 I, batch-minor [n, n, b], and b [n, b]."""
    from nlsolver_torch.benches import spd_systems

    return spd_systems(n, b, seed=seed, device=dev, dtype=dtype or torch.float32)


def normal_system(torch, dev, scenario, n, X0_value):
    """A fleet's first damped normal equations at X0: J^T J + lam I and
    J^T r, lam = lambda0, for ``scenario``'s (residual, ys, truth): the
    systems its cholesky backend hands K3."""
    from nlsolver_torch.solvers import nlls_fleet as nf

    residual, ys, _ = scenario
    B = ys.shape[0]
    r, J = nf._residuals_bm(residual, torch.full((n, B), X0_value, device=dev, dtype=ys.dtype), ys)
    lam = nf.NLLSFleetConfig().lambda0
    eye = torch.eye(n, device=dev, dtype=ys.dtype)[:, :, None]
    A = torch.einsum("mib,mjb->ijb", J, J) + lam * eye
    return A.contiguous(), torch.einsum("mib,mb->ib", J, r).contiguous()


def phase_smallchol(torch, dev):
    """K3's forms bit for bit against the twin, the dispatcher's choice at
    each boundary, its path past K3-w's range (K3-c) and past K3-c's (K3-b,
    K3-d's range included, its x bit-equal to its plain version), K3-d and
    K3-g by direct calls there, refusals.  Returns the largest difference
    from the twin (K3-b: from its plain version) per form, the launches of
    each form on its path or direct call, and the times in ms of the twin's
    order (chol_solve_right_looking) at K3-c's path and at [646, 646, 2]
    f64, and of K3-b's plain version at its first shapes."""
    from nlsolver_torch.benches import chebyshev_scenario, expfit_scenario
    from nlsolver_torch.ops import smallchol as tsc

    forms = spd_forms()
    worst = dict.fromkeys(forms, 0.0)

    def hold(kids, A, rhs, label):
        twin = tsc._chol_solve_batchminor(A, rhs)
        for kid in kids:
            before = forms[kid].launches
            x = forms[kid](A, rhs)
            torch.cuda.synchronize()
            check(forms[kid].launches == before + 1, f"{kid} {label}: no launch counted")
            check(torch.equal(x, twin), f"{kid} differs from the twin at {label}: "
                  f"max |diff| {max_diff(x, twin):.3e}")
            worst[kid] = max(worst[kid], max_diff(x, twin))
        res = (torch.einsum("ijb,jb->ib", A, twin) - rhs).abs().max() / rhs.abs().max()
        log(f"[7] {' and '.join(kids)} {label}: bit-equal to the twin; max |Ax-b|/max|b| "
            f"{float(res):.3e}")
        check(float(res) < (1e-3 if A.dtype == torch.float32 else 1e-10), "K3 residual too large")

    # by direct call, every form that takes n
    cases = [(n, 16384, torch.float32) for n in (1, 2, 8, 12, 16, 30, 33)]
    cases.append((8, 16384, torch.float64))
    for n, b, dtype in cases:
        A, rhs = spd_case(torch, dev, n, b, dtype)
        hold([k for k in forms if spd_takes(k, n, dtype)], A, rhs,
             f"[{n}, {n}, {b}] {str(dtype)[6:]}")
    # the shapes phase 10 times, and the fleets' first systems through the
    # forms that time them there and the form each fleet runs
    for n, b in ((2, FLEET_B), (12, 16384), (30, 4096)):
        A, rhs = spd_case(torch, dev, n, b)
        hold([k for k in forms if spd_takes(k, n, A.dtype)], A, rhs, f"[{n}, {n}, {b}] float32")
    systems = [("the exp fleet's", expfit_scenario(FLEET_B, FLEET_M, device=dev), 2, 1.0)]
    systems += [(f"Chebyshev fleet [{n}, {b}]'s", chebyshev_scenario(b, n, m, device=dev), n, 0.0)
                for n, m, b in (CHEB_SHARED, CHEB_WARP)]
    for what, scenario, n, x0 in systems:
        A, rhs = normal_system(torch, dev, scenario, n, x0)
        hold([k for k in forms if spd_takes(k, n, A.dtype)], A, rhs,
             f"{what} first normal equations {tuple(A.shape)}")
    # the dispatcher's choice at the edges of each form's range, its x the
    # twin's; past n = 64 the twin's eager ops (some n^3 / 6) would take
    # minutes, and chol_solve_right_looking, the twin's operations in its
    # order as whole trailing blocks (tests/test_torch_smallchol.py holds it
    # bit-equal to the twin, on the card at K3-c's path too), stands in for it
    def dispatch(kid, A, rhs, label):
        n = A.shape[0]
        t0 = time.perf_counter()
        twin = (tsc._chol_solve_batchminor if n <= 64
                else tsc.chol_solve_right_looking)(A, rhs).cpu()
        twin_ms = (time.perf_counter() - t0) * 1e3
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        x = tsc.solve_spd_batchminor(A, rhs)
        end.record()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in forms.items()}
        check(counts == {k: int(k == kid) for k in forms},
              f"solve_spd_batchminor({label}) launched {counts}, not {kid} once")
        check(torch.equal(x.cpu(), twin), f"solve_spd_batchminor({label}) through {kid} differs "
              f"from the twin: max |diff| {max_diff(x.cpu(), twin):.3e}")
        worst[kid] = max(worst[kid], max_diff(x.cpu(), twin))
        return x, counts, twin_ms, start.elapsed_time(end)

    def dispatch_blocked(A, rhs, label):
        """The dispatcher past K3-c's range: K3-b once and no other form,
        its x bit-equal to its plain version run on the card (the twin's L
        and z, the back solve by columns), its |Ax - b| / (|A| |x|) within
        10x that of the twin's order (chol_solve_right_looking: the twin's
        factor on the card, its back solve, ascending in k, on the host).
        Returns x, the launches, the dispatcher's ms, the plain version's,
        and the twin's order's x and ms."""
        dtype = A.dtype
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        x = tsc.solve_spd_batchminor(A, rhs)
        end.record()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in forms.items()}
        check(counts == {k: int(k == "K3-b") for k in forms},
              f"solve_spd_batchminor({label}) launched {counts}, not K3-b once")
        t0 = time.perf_counter()
        want = tsc.solve_spd_blocked_reference(A, rhs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(x, want), f"K3-b differs from its plain version at {label}: max "
              f"|diff| {max_diff(x, want):.3e}")
        worst["K3-b"] = max(worst["K3-b"], max_diff(x, want))
        t0 = time.perf_counter()
        xt = tsc.chol_solve_right_looking(A, rhs)
        twin_ms = (time.perf_counter() - t0) * 1e3
        res, res_t = spd_residual(torch, A, x, rhs), spd_residual(torch, A, xt, rhs)
        log(f"[7] solve_spd_batchminor({label}): launches {counts}; through K3-b "
            f"({tsc.blocked_plan(A.shape[0], dtype, A.shape[2])} CTAs a lane, panels of "
            f"{tsc.BLOCKED_NB}) bit-equal to its plain version ({plain_ms:.0f} ms), "
            f"{start.elapsed_time(end):.3f} ms; max over lanes of |Ax-b| / (|A| |x|) {res:.3e}, "
            f"the twin's order's {res_t:.3e}, max |x - x_twin| {max_diff(x, xt):.3e}")
        check(bool(torch.isfinite(x).all())
              and res < (1e-5 if dtype == torch.float32 else 1e-13) and res < 10 * res_t + 1e-16,
              f"K3-b's residual at {label} is too large")
        return {"x": x, "counts": counts, "ms": start.elapsed_time(end), "plain_ms": plain_ms,
                "twin": xt, "twin_ms": twin_ms}

    launches, first = {"K3-b": 0}, {}
    for dtype in (torch.float32, torch.float64):
        kind = str(dtype)[6:]
        reg = tsc.REGISTER_MAX_N[dtype]
        warp = max(n for n in range(1, 400) if tsc.warp_fits(n, dtype))
        last = max(n for n in range(1, 1000) if tsc.cluster_fits(n, dtype))
        far = last_fitting(lambda n: tsc.distributed_fits(n, dtype), last + 1)
        for n, kid in ((1, "K3-r"), (reg, "K3-r"), (reg + 1, "K3-w")):
            A, rhs = spd_case(torch, dev, n, 999, dtype)
            hold([kid], A, rhs, f"[{n}, {n}, 999] {kind}")
            dispatch(kid, A, rhs, f"[{n}, {n}, 999] {kind}")
        # the ends of K3-w's and K3-c's ranges on a few lanes (clusters of 8
        # there)
        for n, kid in ((warp, "K3-w"), (warp + 1, "K3-c"), (last, "K3-c")):
            A, rhs = spd_case(torch, dev, n, 3, dtype)
            _, _, _, ms = dispatch(kid, A, rhs, f"[{n}, {n}, 3] {kind}")
            log(f"[7] solve_spd_batchminor([{n}, {n}, 3] {kind}) through {kid}: bit-equal to "
                f"the twin, {ms:.3f} ms")
        # past K3-c's range K3-b, K3-d's range (now a direct call's) included:
        # the dispatcher at the first n on 2 lanes (in float64 K3-d's path
        # before, [646, 646, 2]; K3-d and K3-g by direct calls below)
        check(tsc.plan(last, dtype) == "cluster" and tsc.plan(last + 1, dtype) == "blocked",
              f"the plan does not hand K3-c's last n, {last}, to K3-b in {kind}")
        check(tsc.plan(far, dtype) == "blocked" and tsc.distributed_fits(far, dtype)
              and not tsc.distributed_fits(far + 1, dtype),
              f"K3-d's range does not end at n={far} in {kind}, or the plan does not give it K3-b")
        n = last + 1
        A, rhs = spd_case(torch, dev, n, 2, dtype)
        first[kind] = (A, rhs, dispatch_blocked(A, rhs, f"[{n}, {n}, 2] {kind}"))
        launches["K3-b"] += first[kind][2]["counts"]["K3-b"]
        log(f"[7] the dispatcher takes K3-r for n <= {reg}, K3-w for {reg + 1} <= n <= {warp}, "
            f"K3-c for {warp + 1} <= n <= {last}, K3-b beyond, K3-d's range {last + 1} <= n <= "
            f"{far} included ({kind})")
    # K3-c's path: the dispatcher past K3-w's range in float64, counted and
    # held bit for bit against the twin's order on the card (the twin's
    # square roots taken there: the host's float64 torch.sqrt may be off by
    # an ulp where the card's is not)
    n, b = K3G_N, K3G_B
    A, rhs = spd_case(torch, dev, n, b, torch.float64)
    x, counts, path_twin_ms, _ = dispatch("K3-c", A, rhs, f"[{n}, {n}, {b}] float64")
    twin_ms = {}
    res = float(((torch.einsum("ijb,jb->ib", A, x) - rhs).norm(dim=0) / rhs.norm(dim=0)).max())
    log(f"[7] solve_spd_batchminor([{n}, {n}, {b}] float64): launches {counts}; bit-equal to "
        f"the twin's order (chol_solve_right_looking, {path_twin_ms:.0f} ms); max over lanes of "
        f"|Ax-b|/|b| {res:.3e}")
    check(bool(torch.isfinite(x).all()) and res < 1e-12, "K3-c's residual above 1e-12")
    launches["K3-c"] = counts["K3-c"]
    # K3-d, the dispatcher's at the first n past K3-c's range until K3-b took
    # its range, by a direct call on the same 2 lanes as the dispatcher's
    # K3-b above in float32 and float64 ([646, 646, 2], its path before),
    # counted, bit-equal to the twin's order
    check(tsc.cluster_fits(K3D_N - 1, torch.float64) and not tsc.cluster_fits(K3D_N, torch.float64),
          f"K3-c's range in float64 does not end at n={K3D_N - 1}")
    launches["K3-d"] = 0
    for kind in ("float32", "float64"):
        A, rhs, found = first[kind]
        n, twin = A.shape[0], found["twin"]
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        x = tsc.solve_spd_distributed(A, rhs)
        end.record()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in forms.items()}
        check(counts == {k: int(k == "K3-d") for k in forms},
              f"solve_spd_distributed([{n}, {n}, 2] {kind}) launched {counts}")
        check(torch.equal(x, twin), f"K3-d differs from the twin's order at [{n}, {n}, 2] {kind}: "
              f"max |diff| {max_diff(x, twin):.3e}")
        worst["K3-d"] = max(worst["K3-d"], max_diff(x, twin))
        log(f"[7] solve_spd_distributed([{n}, {n}, 2] {kind}) (K3-d) by a direct call "
            f"({tsc.distributed_plan(n, A.dtype, 2)} CTAs a lane): bit-equal to the twin's order "
            f"(chol_solve_right_looking, {found['twin_ms']:.0f} ms), "
            f"{start.elapsed_time(end):.3f} ms")
        launches["K3-d"] += counts["K3-d"]
    n, far_twin_ms = K3D_N, first["float64"][2]["twin_ms"]
    # K3-g, the dispatcher's past K3-c's range before K3-d (minutes a lane
    # past K3-d's range), by a direct call on the same systems, counted,
    # timed once
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    xg = tsc.solve_spd_batchminor_global(A, rhs)
    end.record()
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in forms.items()}
    check(counts == {k: int(k == "K3-g") for k in forms},
          f"solve_spd_batchminor_global([{n}, {n}, 2] float64) launched {counts}")
    check(torch.equal(xg, x), f"K3-g differs from the twin at [{n}, {n}, 2] float64: "
          f"max |diff| {max_diff(xg, x):.3e}")
    log(f"[7] solve_spd_batchminor_global([{n}, {n}, 2] float64) (K3-g): bit-equal to the "
        f"twin, {start.elapsed_time(end):.3f} ms")
    launches["K3-g"] = counts["K3-g"]
    # K3-b by a direct call on the same systems: its x bit-equal to its
    # plain version's (L and z the twin's, the back solve by columns,
    # descending), and within a few ulps of the twin's
    reset_counts()
    xb = tsc.solve_spd_blocked(A, rhs)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in forms.items()}
    check(counts == {k: int(k == "K3-b") for k in forms},
          f"solve_spd_blocked([{n}, {n}, 2] float64) launched {counts}")
    want = tsc.solve_spd_blocked_reference(A, rhs)
    check(torch.equal(xb, want), f"K3-b differs from its plain version at [{n}, {n}, 2] float64: "
          f"max |diff| {max_diff(xb, want):.3e}")
    log(f"[7] solve_spd_blocked([{n}, {n}, 2] float64) (K3-b) by a direct call: bit-equal to "
        f"its plain version, max |x - x_twin| / max |x_twin| {max_diff(xb, x) / max_diff(x, 0 * x):.3e}")
    worst["K3-b"] = max(worst["K3-b"], max_diff(xb, want))
    # K3-b's range past K3-d's: the first n in float64 and in float32, on 2
    # lanes, through the dispatcher, as at its first n above
    for dtype in (torch.float64, torch.float32):
        kind = str(dtype)[6:]
        n = K3B_N[kind]
        check(tsc.plan(n, dtype) == "blocked" and not tsc.distributed_fits(n, dtype)
              and tsc.distributed_fits(n - 1, dtype),
              f"K3-d's range in {kind} does not end at n={n - 1}")
        A, rhs = spd_case(torch, dev, n, 2, dtype)
        found = dispatch_blocked(A, rhs, f"[{n}, {n}, 2] {kind}")
        twin_ms[f"K3-b {kind}"] = found["plain_ms"]
        launches["K3-b"] += found["counts"]["K3-b"]
    A32 = torch.eye(3, device=dev).reshape(3, 3, 1).expand(3, 3, 64).contiguous()
    for what, args in (("non-contiguous", (A32.transpose(0, 1), torch.ones(3, 64, device=dev))),
                       ("f16", (A32.half(), torch.ones(3, 64, device=dev).half()))):
        try:
            tsc.solve_spd_batchminor(*args)
        except ValueError as e:
            log(f"[7] K3 refuses a {what} input: {e}")
        else:
            check(False, f"K3 took a {what} input")
    twin_ms.update({"K3-c": path_twin_ms, "K3-d": far_twin_ms,
                    f"K3-b n={K3D_N}": first["float64"][2]["plain_ms"]})
    return worst, launches, twin_ms


def first_system(torch, dev, scenario, n, X0_value):
    """A fleet's first augmented system: [J; sqrt(lam) I] and [r; 0] at X0,
    lam = lambda0, for ``scenario``'s (residual, ys, truth)."""
    from nlsolver_torch.solvers import nlls_fleet as nf

    residual, ys, _ = scenario
    B = ys.shape[0]
    r, J = nf._residuals_bm(residual, torch.full((n, B), X0_value, device=dev, dtype=ys.dtype), ys)
    lam = torch.full((B,), nf.NLLSFleetConfig().lambda0, device=dev, dtype=ys.dtype)
    return nf._augmented(r, J, lam)


def fleet_system(torch, dev):
    """The NLLS fleet's first augmented system at full size, [34, 2, 262144]."""
    from nlsolver_torch.benches import expfit_scenario

    return first_system(torch, dev, expfit_scenario(FLEET_B, FLEET_M, device=dev), 2, 1.0)


def chebyshev_system(torch, dev, n, m, b, dtype=None):
    """The first augmented system of a Chebyshev fleet, [m + n, n, b]."""
    from nlsolver_torch.benches import chebyshev_scenario

    scenario = chebyshev_scenario(b, n, m, device=dev, dtype=dtype or torch.float32)
    return first_system(torch, dev, scenario, n, 0.0)


def lstsq_forms():
    from nlsolver_torch.ops import qr_wavefront as tqw

    return {"K2b-r": tqw.least_squares_wavefront_registers,
            "K2b-s": tqw.least_squares_wavefront_shared,
            "K2b-w": tqw.least_squares_wavefront_warp,
            "K2b-c": tqw.least_squares_wavefront_cluster,
            "K2b-d": tqw.least_squares_wavefront_distributed,
            "K2b-p": tqw.least_squares_wavefront_panel,
            "K2b-g": tqw.least_squares_wavefront_global}


def lstsq_calls(torch, kid, A):
    """The launches that one call of K2b's form ``kid`` counts on ``A``: one,
    but K2b-p's ``lstsq_panel_launches`` (a kernel a panel and the back
    solve)."""
    from nlsolver_torch.ops import qr_wavefront as tqw

    if kid != "K2b-p":
        return 1
    m, n, _ = A.shape
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    return tqw.lstsq_panel_launches(m, n, A.dtype, sms)


def lstsq_takes(kid, n, dtype):
    from nlsolver_torch.ops import qr_wavefront as tqw

    return {"K2b-r": tqw.registers_fit, "K2b-s": tqw.shared_fits, "K2b-w": tqw.warp_fits,
            "K2b-c": tqw.cluster_fits,
            "K2b-d": tqw.distributed_fits}.get(kid, lambda n, d: True)(n, dtype)


def phase_qr(torch, dev):
    from nlsolver_torch import linalg
    from nlsolver_torch.benches import least_squares_twin_order
    from nlsolver_torch.ops import qr_wavefront as tqw

    g = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    forms = lstsq_forms()

    def hold(kids, A, y, label):
        """Each K2b form of ``kids`` on (A, y), counted, bit for bit
        against the twin."""
        nonlocal worst
        twin = tqw.least_squares_wavefront_reference(A, y)
        for kid in kids:
            kernel = forms[kid]
            before = kernel.launches
            x = kernel(A, y)
            torch.cuda.synchronize()
            check(kernel.launches == before + lstsq_calls(torch, kid, A),
                  f"{kid} {label}: {kernel.launches - before} launches counted")
            check(bool(torch.isfinite(x).all()), f"{kid} {label}: non-finite x")
            check(torch.equal(x, twin), f"{kid} differs from the twin at {label}: "
                  f"max |diff| {max_diff(x, twin):.3e}")
            worst = max(worst, max_diff(x, twin))
        log(f"[8] {' and '.join(kids)} {label}: bit-equal to the twin")

    # the NLLS fleet's first system, every form, in float32 and float64
    A, y = fleet_system(torch, dev)
    for dtype in (torch.float32, torch.float64):
        hold(list(forms), A.to(dtype), y.to(dtype), f"fleet {tuple(A.shape)} {str(dtype)[6:]}")
    # the Chebyshev fleets' first systems (phase 9), each through the forms
    # that time it in phase 10 and the form its fleet runs
    for shape, kids, dtype in ((CHEB_SHARED, ["K2b-s", "K2b-g"], torch.float32),
                               (CHEB_WARP, ["K2b-w", "K2b-g"], torch.float32),
                               (CHEB_CLUSTER, ["K2b-c", "K2b-g"], torch.float64)):
        A, y = chebyshev_system(torch, dev, *shape, dtype)
        hold(kids, A, y, f"Chebyshev fleet {tuple(A.shape)} {str(dtype)[6:]}")
    for m, n, b in ((32, 8, 4096), (64, 16, 4096), (34, 2, 300), (70, 40, 999)):
        A, y = (torch.randn((m, n, b), generator=g, device=dev),
                torch.randn((m, b), generator=g, device=dev))
        hold([k for k in forms if lstsq_takes(k, n, A.dtype)], A, y, f"random {(m, n, b)}")
    # each form at the first and last n it takes, square and with one row
    # more (the cluster form's last on 33 lanes); the dispatcher's choice at
    # each boundary
    for dtype in (torch.float32, torch.float64):
        reg = tqw.REGISTER_MAX_N[dtype]
        shared = max(n for n in range(1, 64) if tqw.shared_fits(n, dtype))
        warp = max(n for n in range(1, 512) if tqw.warp_fits(n, dtype))
        last = max(n for n in range(1, 512) if tqw.cluster_fits(n, dtype))
        edges = {"K2b-r": (1, reg), "K2b-s": (reg + 1, shared), "K2b-w": (shared + 1, warp),
                 "K2b-c": (warp + 1, last)}
        for kid, ns in edges.items():
            for n in ns:
                for m in (n, n + 1):
                    b = 33 if n == last else 999
                    A, y = (torch.randn((m, n, b), generator=g, device=dev, dtype=dtype),
                            torch.randn((m, b), generator=g, device=dev, dtype=dtype))
                    hold([kid], A, y, f"[{m}, {n}, {b}] {str(dtype)[6:]}"
                         + (f" (C = {tqw.cluster_plan(n, dtype, b)[0]})" if kid == "K2b-c" else ""))
                    before = forms[kid].launches
                    tqw.least_squares_wavefront_kernel(A, y)
                    check(forms[kid].launches == before + 1,
                          f"the dispatcher did not take {kid} at n={n} in {dtype}")
        far = last_fitting(lambda n: tqw.distributed_fits(n, dtype), last + 1)
        check(far + 1 == K2BP_N[str(dtype)[6:]], f"K2b-d's range in {dtype} ends at n={far}")
        check(tqw.least_squares_form(far, far, dtype) == "distributed"
              and tqw.least_squares_form(far + 1, far + 1, dtype) == "panel",
              f"the dispatcher does not end K2b-d at n={far} in {dtype}")
        end = last_fitting(lambda n: tqw.qr_panel_fits(n, n, dtype, False), far + 1)
        check(tqw.least_squares_form(end, end, dtype) == "panel"
              and tqw.least_squares_form(end + 1, end + 1, dtype) == "global",
              f"the dispatcher does not end K2b-p at [{end}, {end}] in {dtype}")
        log(f"[8] the dispatcher takes K2b-r for n <= {reg}, K2b-s for {reg + 1} <= n <= {shared}, "
            f"K2b-w for {shared + 1} <= n <= {warp}, K2b-c for {warp + 1} <= n <= {last}, K2b-d "
            f"for {last + 1} <= n <= {far}, K2b-p for [m, n] past it whose column fits a CTA "
            f"(square to [{end}, {end}]), K2b-g beyond ({str(dtype)[6:]})")

    def path(A, y, twin, kid, label, ref="the twin"):
        """One counted launch of ``kid`` on (A, y) through the dispatcher
        (K2b-g: by a direct call, minutes a lane at its first n), bit for
        bit against ``twin``, the twin's x (or ``ref``'s); its launches."""
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        x = (forms[kid] if kid == "K2b-g" else tqw.least_squares_wavefront_kernel)(A, y)
        end.record()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in forms.items()}
        want = lstsq_calls(torch, kid, A)
        check(counts == {k: want * (k == kid) for k in forms}, f"{kid} {label}: launched {counts}")
        check(torch.equal(x, twin), f"{kid} differs from {ref} at {label}: "
              f"max |diff| {max_diff(x, twin):.3e}")
        log(f"[8] {kid} {label}: launches {counts}, bit-equal to {ref}, "
            f"{start.elapsed_time(end):.3f} ms")
        return counts[kid]

    # K2b-d's path: the first n past K2b-c's range, square, on 2 lanes,
    # through the dispatcher, in float64 and in float32; K2b-g past K2b-d's
    # range, by a direct call on the float64 systems, timed once (a thread a
    # lane: seconds)
    path_launches = {}
    for dtype, kids in ((torch.float32, ("K2b-d",)), (torch.float64, ("K2b-d", "K2b-g"))):
        n = max(k for k in range(1, 512) if tqw.cluster_fits(k, dtype)) + 1
        check(dtype == torch.float32 or n == K2BD_N, f"K2b-c's range in float64 ends at n={n - 1}")
        A, y = (torch.randn((n, n, 2), generator=g, device=dev, dtype=dtype),
                torch.randn((n, 2), generator=g, device=dev, dtype=dtype))
        t0 = time.perf_counter()
        twin = tqw.least_squares_wavefront_reference(A, y)
        torch.cuda.synchronize()
        twin_ms = (time.perf_counter() - t0) * 1e3
        for kid in kids:
            path_launches[kid] = path(A, y, twin, kid, f"[{n}, {n}, 2] {str(dtype)[6:]}" + (
                f" ({tqw.distributed_plan(n, dtype, 2)} CTAs a lane)" if kid == "K2b-d" else ""))
    log(f"[8] the twin at [{n}, {n}, 2] float64: {twin_ms:.0f} ms")
    # K2b-p by a direct call at K2b-d's path, [330, 330, 2] f64; there the
    # twin's order with its back solve on the host (least_squares_twin_order,
    # K2b-p's reference at its later shapes below) gives the twin's bits too
    kid = "K2b-p"
    before = forms[kid].launches
    x = forms[kid](A, y)
    torch.cuda.synchronize()
    want = lstsq_calls(torch, kid, A)
    check(forms[kid].launches == before + want and torch.equal(x, twin),
          f"K2b-p by a direct call at [{n}, {n}, 2] float64: {forms[kid].launches - before} "
          f"launches, max |diff| {max_diff(x, twin):.3e}")
    check(torch.equal(least_squares_twin_order(A, y), twin),
          f"least_squares_twin_order differs from the twin at [{n}, {n}, 2] float64")
    log(f"[8] K2b-p by a direct call at [{n}, {n}, 2] float64: {want} launches, bit-equal to the "
        "twin; least_squares_twin_order bit-equal to the twin there")
    twin_ms = {"K2b": twin_ms}
    # K2b-p's path: the dispatcher at the first n past K2b-d's range in
    # float64 and float32 (one panel, 2 lanes), at its first square shape
    # in two panels (1 lane), and at a Chebyshev fit's augmented system of
    # 1263 coefficients on 1280 points (phase 9's), each counted; x
    # bit-equal to the twin run on the card at the first, [1263, 1263, 2]
    # f64, where least_squares_twin_order must give the twin's bits too, and
    # to least_squares_twin_order at the other three (the twin's stages on
    # the card, its back solve on the host: the twin's own, some n^2 eager
    # launches, takes 30-60 s a shape there)
    for k, ((m, n, b), dtype) in enumerate((
            ((K2BP_N["float64"],) * 2 + (2,), torch.float64),
            ((K2BP_N["float32"],) * 2 + (2,), torch.float32),
            ((K2BP_PANELS_N, K2BP_PANELS_N, 1), torch.float64),
            ((CHEB_PANEL[0] + CHEB_PANEL[1], CHEB_PANEL[0], 2), torch.float64))):
        kind = str(dtype)[6:]
        check(tqw.least_squares_form(m, n, dtype) == "panel", f"K2b-p does not take [{m}, {n}] {kind}")
        if m == n:
            A, y = (torch.randn((m, n, b), generator=g, device=dev, dtype=dtype),
                    torch.randn((m, b), generator=g, device=dev, dtype=dtype))
        else:
            A, y = chebyshev_system(torch, dev, *CHEB_PANEL, dtype)
        first = k == 0
        ref = "the twin" if first else "the twin's order"
        t0 = time.perf_counter()
        twin = (tqw.least_squares_wavefront_reference if first else least_squares_twin_order)(A, y)
        torch.cuda.synchronize()
        label = f"[{m}, {n}, {b}] {kind}"
        twin_ms[f"K2b-p {label}"] = (time.perf_counter() - t0) * 1e3
        panels = tqw.lstsq_panel_plan(m, n, dtype, b)
        path_launches[kid] = path_launches.get(kid, 0) + path(
            A, y, twin, kid, f"{label} ({len(panels)} panel{'s' * (len(panels) > 1)} over "
            f"{panels[0][2]} CTAs a lane)", ref)
        log(f"[8] {ref} at {label}: {twin_ms[f'K2b-p {label}']:.0f} ms")
        if first:
            check(torch.equal(least_squares_twin_order(A, y), twin),
                  f"least_squares_twin_order differs from the twin at {label}")
            log(f"[8] least_squares_twin_order bit-equal to the twin at {label}")
        del A, y, twin
    # K2a-w and K2a-g, bit for bit against the twin, and a factorization
    qr_forms = qr_forms_of()

    def hold_qr(kid, qr, A, compute_q, label, launches=1):
        """``launches`` counted launches of K2a's form ``kid`` through ``qr``
        (the form itself, or the dispatcher) against the twin."""
        nonlocal worst
        tR, tQ = tqw.qr_wavefront_reference(A, compute_q)
        before = qr_forms[kid].launches
        R, Q = qr(A, compute_q=compute_q)
        torch.cuda.synchronize()
        check(qr_forms[kid].launches == before + launches,
              f"{kid} {label}: {qr_forms[kid].launches - before} launches counted, not {launches}")
        check(torch.equal(R, tR) and (not compute_q or torch.equal(Q, tQ)),
              f"{kid} differs from its twin at {label}: R {max_diff(R, tR):.3e}"
              + (f", Q {max_diff(Q, tQ):.3e}" if compute_q else ""))
        worst = max(worst, max_diff(R, tR), max_diff(Q, tQ) if compute_q else 0.0)
        return R, Q

    for m, n, b in ((16, 16, 4096), (32, 8, 4096)):
        A = torch.randn((m, n, b), generator=g, device=dev)
        hold_qr("K2a-g", qr_forms["K2a-g"], A, True, f"{(m, n, b)}")
        R, Q = hold_qr("K2a-w", qr_forms["K2a-w"], A, True, f"{(m, n, b)}")
        eye = torch.eye(m, device=dev)[:, :, None]
        qtq = float((torch.einsum("ikb,ilb->klb", Q, Q) - eye).abs().max())
        rec = float((torch.einsum("ikb,kjb->ijb", Q, R) - A).abs().max() / A.abs().max())
        sub = torch.tril(torch.ones(m, n, device=dev, dtype=torch.bool), -1)
        tri = float(R[sub].abs().max())
        log(f"[8] K2a-w and K2a-g {(m, n, b)}: bit-equal to the twin; max|QtQ-I| {qtq:.3e}, "
            f"max|QR-A|/max|A| {rec:.3e}, max|tril(R)| {tri:.3e}")
        check(qtq <= 1e-5 and rec <= 1e-5 and tri <= 1e-4, "K2a is not a QR factorization")
    # each form of K2a at the first and last square shapes that the
    # dispatcher gives it and its first and last with one row more, with
    # and without Q, a zero column among the random ones, in float32 and
    # float64, through the dispatcher: K2a-w and K2a-c on 32 lanes, K2a-d on
    # 2; the dispatcher ends K2a-d where K2a-g (a thread a lane, seconds)
    # takes over
    for dtype in (torch.float32, torch.float64):
        for q in (True, False):
            ends = {}
            for kid, form, b in (("K2a-w", "warp", 32), ("K2a-c", "cluster", 32),
                                 ("K2a-d", "distributed", 2)):
                shapes = qr_form_edges(form, dtype, q)
                ends[kid] = shapes
                for m, n in shapes:
                    A = torch.randn((m, n, b), generator=g, device=dev, dtype=dtype)
                    A[:, n // 2] = 0.0
                    hold_qr(kid, tqw.qr_wavefront_kernel, A, q,
                            f"[{m}, {n}, {b}] {str(dtype)[6:]}{' with Q' if q else ''}, the "
                            "dispatcher")
            last = ends["K2a-d"][1][0]
            check(tqw.qr_form(last + 1, last + 1, dtype, q) == "panel",
                  f"the dispatcher does not end K2a-d at [{last}, {last}] in {dtype}")
            log(f"[8] {str(dtype)[6:]}{' with Q' if q else ''}: bit-equal to the twin through the "
                "dispatcher, each form at its first and last square shape and with one row more: "
                + "; ".join(f"{kid} {[list(e) for e in shapes]}" for kid, shapes in ends.items())
                + f"; K2a-p from [{last + 1}, {last + 1}]")
    # K2a's path: linalg.qr(method="pallas"), counted, through K2a-w at the
    # timed shape, K2a-c past K2a-w's range, K2a-d at the first square shape
    # past K2a-c's in float64; K2a-g by a direct call at K2a-c's shape
    launches = {}
    n = max(k for k in range(1, 512) if tqw.qr_cluster_fits(k, k, torch.float64, True)) + 1
    check(n == K2AD_N, f"K2a-c's range in float64 with Q ends at [{n - 1}, {n - 1}]")
    for kid, (m, n, b), dtype in (("K2a-w", (16, 16, 4096), torch.float32),
                                  ("K2a-c", (170, 170, 32), torch.float32),
                                  ("K2a-d", (K2AD_N, K2AD_N, 2), torch.float64),
                                  ("K2a-g", (170, 170, 32), torch.float32)):
        A = torch.randn((m, n, b), generator=g, device=dev, dtype=dtype)
        reset_counts()
        if kid == "K2a-g":
            tR, tQ = tqw.qr_wavefront_reference(A, True)
            out = linalg.QR(*reversed(qr_forms[kid](A, compute_q=True)))
            check(torch.equal(out.R, tR) and torch.equal(out.Q, tQ),
                  f"K2a-g differs from its twin at [{m}, {n}, {b}]")
        else:
            out = linalg.qr(A, method="pallas")
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in qr_forms.items()}
        check(counts == {k: int(k == kid) for k in qr_forms},
              f"{kid} [{m}, {n}, {b}]: launched {counts}")
        err = float(linalg.validate_qr(
            linalg.QR(out.Q.permute(2, 0, 1), out.R.permute(2, 0, 1)), A.permute(2, 0, 1)))
        check(err < 1e-4, f"{kid} [{m}, {n}, {b}] does not reconstruct A ({err:.3e})")
        log(f"[8] " + ("K2a-g by a direct call" if kid == "K2a-g" else "linalg.qr")
            + f"(A[{m}, {n}, {b}] {str(dtype)[6:]}): launches {counts}, max|QR - A| {err:.3e}"
            + (", bit-equal to the twin" if kid == "K2a-g" else ""))
        launches[kid] = counts[kid]
    launches.update(path_launches)
    # K2a-p's path: linalg.qr(method="pallas") at the first square shapes
    # past K2a-d's range with Q (one panel; 2 lanes), counted, R and Q
    # bit-equal to the twin run on the card; then at [1817, 1817, 1] f64,
    # past K2a-d's range without Q, and at the first shape that K2a-p forms
    # in two panels, [1849, 1849, 1] f64
    launches["K2a-p"] = 0
    for (m, n, b), dtype in (((K2AP_N["float32"],) * 2 + (2,), torch.float32),
                             ((K2AP_N["float64"],) * 2 + (2,), torch.float64),
                             ((1817, 1817, 1), torch.float64),
                             ((K2AP_PANELS_N, K2AP_PANELS_N, 1), torch.float64)):
        kind = str(dtype)[6:]
        check(tqw.qr_form(m, n, dtype, True) == "panel", f"K2a-p does not take [{m}, {n}] {kind}")
        A = torch.randn((m, n, b), generator=g, device=dev, dtype=dtype)
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = linalg.qr(A, method="pallas")
        end.record()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in qr_forms.items()}
        want = tqw.qr_panel_launches(m, n, dtype, True)
        check(counts == {k: want * (k == "K2a-p") for k in qr_forms},
              f"linalg.qr([{m}, {n}, {b}] {kind}) launched {counts}, not K2a-p's {want} kernels")
        t0 = time.perf_counter()
        tR, tQ = tqw.qr_wavefront_reference(A, True)
        torch.cuda.synchronize()
        twin_ms[f"K2a-p [{m}, {n}, {b}] {kind}"] = (time.perf_counter() - t0) * 1e3
        check(torch.equal(out.R, tR) and torch.equal(out.Q, tQ),
              f"K2a-p differs from its twin at [{m}, {n}, {b}] {kind}: R "
              f"{max_diff(out.R, tR):.3e}, Q {max_diff(out.Q, tQ):.3e}")
        err = float(linalg.validate_qr(
            linalg.QR(out.Q.permute(2, 0, 1), out.R.permute(2, 0, 1)), A.permute(2, 0, 1)))
        check(err < (1e-3 if dtype == torch.float32 else 1e-10),
              f"K2a-p [{m}, {n}, {b}] {kind} does not reconstruct A ({err:.3e})")
        panels = tqw.qr_panel_plan(m, n, dtype, b)
        log(f"[8] linalg.qr(A[{m}, {n}, {b}] {kind}): launches {counts}; through K2a-p "
            f"({len(panels)} panel{'s' * (len(panels) > 1)} over {panels[0][2]} CTAs a lane), "
            f"bit-equal to the twin ({twin_ms[f'K2a-p [{m}, {n}, {b}] {kind}']:.0f} ms), "
            f"{start.elapsed_time(end):.3f} ms, max|QR - A| {err:.3e}")
        if b == 2:
            launches["K2a-p"] += counts["K2a-p"]
        del A, out, tR, tQ
    # K2a-p by a direct call at K2a-d's path, [333, 333, 2] f64 with Q
    A = torch.randn((K2AD_N, K2AD_N, 2), generator=g, device=dev, dtype=torch.float64)
    want = tqw.qr_panel_launches(K2AD_N, K2AD_N, torch.float64, True)
    hold_qr("K2a-p", qr_forms["K2a-p"], A, True, f"[{K2AD_N}, {K2AD_N}, 2] float64, a direct call",
            want)
    log(f"[8] K2a-p by a direct call at [{K2AD_N}, {K2AD_N}, 2] float64 with Q: {want} launches, "
        "bit-equal to the twin")
    return worst, launches, twin_ms


def qr_form_edges(form, dtype, compute_q):
    """(m, n): the first and last square shapes that the dispatcher gives
    K2a's ``form``, and its first and last with one row more."""
    from nlsolver_torch.ops import qr_wavefront as tqw

    square = [n for n in range(1, 2700) if tqw.qr_form(n, n, dtype, compute_q) == form]
    tall = [n for n in range(1, 2700) if tqw.qr_form(n + 1, n, dtype, compute_q) == form]
    return [(square[0], square[0]), (square[-1], square[-1]), (tall[0] + 1, tall[0]),
            (tall[-1] + 1, tall[-1])]


def qr_forms_of():
    from nlsolver_torch.ops import qr_wavefront as tqw

    return {"K2a-w": tqw.qr_wavefront_warp, "K2a-c": tqw.qr_wavefront_cluster,
            "K2a-d": tqw.qr_wavefront_distributed, "K2a-p": tqw.qr_wavefront_panel,
            "K2a-g": tqw.qr_wavefront_global}


def kernel_wrappers():
    """Every kernel's wrapper, each with its ``launches`` count."""
    from nlsolver_torch.ops import de_fused, eigh_jacobi, qr_wavefront, rank2, smallchol

    return (eigh_jacobi.eigh_jacobi_registers, eigh_jacobi.eigh_jacobi_resident,
            eigh_jacobi.eigh_jacobi_cluster, eigh_jacobi.eigh_jacobi_global,
            de_fused.de_generation_staged, de_fused.de_generation_cluster,
            de_fused.de_generation_global,
            qr_wavefront.qr_wavefront_warp, qr_wavefront.qr_wavefront_cluster,
            qr_wavefront.qr_wavefront_distributed, qr_wavefront.qr_wavefront_panel,
            qr_wavefront.qr_wavefront_global,
            qr_wavefront.least_squares_wavefront_registers,
            qr_wavefront.least_squares_wavefront_shared,
            qr_wavefront.least_squares_wavefront_warp,
            qr_wavefront.least_squares_wavefront_cluster,
            qr_wavefront.least_squares_wavefront_distributed,
            qr_wavefront.least_squares_wavefront_panel,
            qr_wavefront.least_squares_wavefront_global, smallchol.solve_spd_registers,
            smallchol.solve_spd_warp, smallchol.solve_spd_cluster,
            smallchol.solve_spd_distributed, smallchol.solve_spd_blocked,
            smallchol.solve_spd_batchminor_global,
            rank2.rank2_direction_batchminor_resident, rank2.rank2_direction_batchminor_cluster,
            rank2.rank2_direction_batchminor_streamed, rank2.rank2_direction_batchminor_rowsplit,
            rank2.rank2_update_batched_kernel, rank2.rank2_update_batched_rows,
            rank2.rank2_update_batched_warp, rank2.rank2_update_batched_global)


def reset_counts():
    for fn in kernel_wrappers():
        fn.launches = 0


def launched():
    """The kernels launched since the last ``reset_counts``."""
    return {fn.__name__: fn.launches for fn in kernel_wrappers() if fn.launches}


def nlls_counts():
    return {**{kid: f.launches for kid, f in qr_forms_of().items()},
            **{kid: f.launches for kid, f in lstsq_forms().items()},
            **{kid: f.launches for kid, f in spd_forms().items()}}


def fit_counted(torch, residual, X0, cfg, ys, kernel, label, per_step=1):
    """One NLLS fleet through fit_fleet: ``kernel`` called once per host
    step, ``per_step`` launches a call (K2b-p: a kernel a panel and the back
    solve), the other solve kernels never.  Returns the result and
    launches."""
    import nlsolver_torch
    from nlsolver_torch.solvers.nlls_fleet import CHECK_EVERY

    reset_counts()
    t0 = time.perf_counter()
    out = nlsolver_torch.fit_fleet(residual, X0, cfg, data=ys)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = nlls_counts()
    # the host loop reads done.all() every CHECK_EVERY steps; the last lane
    # to finish halts on step iterations + 1
    steps = -(-(int(out.iterations.max()) + 1) // CHECK_EVERY) * CHECK_EVERY
    log(f"[9] {label}: {wall:.3f} s, host steps {steps}, launches {counts}, iterations median "
        f"{float(out.iterations.float().median()):.0f} max {int(out.iterations.max())}")
    for k in counts:  # one call per host step of this backend's kernel, none of the others
        want = steps * per_step if k == kernel else 0
        check(counts[k] == want, f"{label}: {k} launched {counts[k]} times, "
              f"expected {want} in {steps} host steps")
    return out, steps * per_step


def phase_nlls_slice(torch, dev):
    import numpy as np

    import nlsolver_torch
    from nlsolver_torch.benches import chebyshev_scenario, expfit_scenario

    from nlsolver_torch.ops import smallchol as tsc

    residual, ys, truth = expfit_scenario(FLEET_B, FLEET_M, device=dev)
    kernel_of = {"qr_pallas": "K2b-r", "cholesky": "K3-r", "qr": None}
    res, launches = {}, {}
    for solve, kernel in kernel_of.items():
        cfg = nlsolver_torch.NLLSFleetConfig(max_iter=30, solve=solve)
        out, steps = fit_counted(torch, residual, torch.ones(2, FLEET_B, device=dev), cfg, ys,
                                 kernel, f"fit_fleet {solve}")
        solved = float((out.f_value < 1e-6).float().mean())
        err = (out.x - truth).abs()
        log(f"[9] fit_fleet {solve}: solved {solved:.6f}, median |p-truth| "
            f"{float(err.median()):.3e}, max {float(err.max()):.3e}")
        check(out.x.shape == (2, FLEET_B) and bool(torch.isfinite(out.x).all()),
              f"{solve}: non-finite or misshapen x")
        check(solved >= 0.999, f"{solve}: solved share {solved} below 0.999")
        check(float(err.median()) <= 1e-3, f"{solve}: median |p - truth| above 1e-3")
        res[solve] = out
        if kernel is not None:
            launches[kernel] = steps
    same_it = torch.equal(res["qr_pallas"].iterations, res["qr"].iterations)
    same_x = torch.equal(res["qr_pallas"].x, res["qr"].x)
    log(f"[9] qr_pallas against qr: iterations equal on every lane {same_it}, x equal {same_x}")
    check(same_it and same_x, "the K2b fleet differs from the plain wavefront fleet")
    d = (res["cholesky"].x - res["qr"].x).abs()
    log(f"[9] cholesky against qr: max |dx| {float(d.max()):.3e}, median {float(d.median()):.3e}")
    check(float(d.max()) <= 1e-4, "the cholesky fleet's fits differ from the qr fleet's by over 1e-4")
    # wide fleets past the register form: Chebyshev fits of CHEB_SHARED
    # and CHEB_WARP coefficients through K2b's shared and warp forms, and of
    # CHEB_CLUSTER in float64, past the warp form's range, through its
    # cluster form
    for (n, m, b), kernel, dtype in ((CHEB_SHARED, "K2b-s", torch.float32),
                                     (CHEB_WARP, "K2b-w", torch.float32),
                                     (CHEB_CLUSTER, "K2b-c", torch.float64)):
        residual, ys, truth = chebyshev_scenario(b, n, m, device=dev, dtype=dtype)
        cfg = nlsolver_torch.NLLSFleetConfig(max_iter=30, solve="qr_pallas")
        out, steps = fit_counted(torch, residual, torch.zeros(n, b, device=dev, dtype=dtype), cfg,
                                 ys, kernel, f"Chebyshev fits [{n}, {b}], {m} points, "
                                 f"{str(dtype)[6:]}")
        solved = float((out.f_value < 1e-6).float().mean())
        err = float((out.x - truth).abs().max())
        log(f"[9] Chebyshev fits [{n}, {b}] {str(dtype)[6:]}: solved {solved:.6f}, "
            f"max |c - truth| {err:.3e}")
        check(bool(torch.isfinite(out.x).all()) and solved >= 0.999 and err <= 1e-4,
              f"the Chebyshev fleet at n={n} did not recover its coefficients")
        launches[kernel] = steps
    # the same Chebyshev fits through the default backend, the damped normal
    # equations solved by K3 in the form its plan names (K3-r at 12
    # coefficients, K3-w at 30)
    for n, m, b in (CHEB_SHARED, CHEB_WARP):
        residual, ys, truth = chebyshev_scenario(b, n, m, device=dev)
        kernel = K3_OF_PLAN[tsc.plan(n, torch.float32)]
        cfg = nlsolver_torch.NLLSFleetConfig(max_iter=30, solve="cholesky")
        out, steps = fit_counted(torch, residual, torch.zeros(n, b, device=dev), cfg, ys, kernel,
                                 f"Chebyshev fits [{n}, {b}], {m} points, cholesky")
        solved = float((out.f_value < 1e-6).float().mean())
        err = float((out.x - truth).abs().max())
        log(f"[9] Chebyshev fits [{n}, {b}] cholesky ({kernel}): solved {solved:.6f}, "
            f"max |c - truth| {err:.3e}")
        check(bool(torch.isfinite(out.x).all()) and solved >= 0.999 and err <= 1e-4,
              f"the cholesky Chebyshev fleet at n={n} did not recover its coefficients")
        launches[f"K3 n={n}"] = steps
    # two Chebyshev fits of CHEB_PANEL's 1263 coefficients in float64, past
    # K2b-d's range: through solve="qr_pallas" (K2b-p on the augmented
    # systems [2543, 1263, 2], two launches a host step) and through
    # "cholesky" (K3-b on the damped normal equations, the form the plan
    # names past K3-c's range); each recovers the
    # coefficients within 1e-9 and the two fits agree within 1e-9 (the
    # Chebyshev basis is orthogonal on the nodes: J^T J is diagonal, its
    # condition number 2)
    from nlsolver_torch.ops import qr_wavefront as tqw

    n, m, b = CHEB_PANEL
    residual, ys, truth = chebyshev_scenario(b, n, m, device=dev, dtype=torch.float64)
    fits = {}
    for solve, kernel in (("qr_pallas", "K2b-p"),
                          ("cholesky", K3_OF_PLAN[tsc.plan(n, torch.float64)])):
        per = tqw.lstsq_panel_launches(m + n, n, torch.float64, torch.cuda.get_device_properties(
            dev).multi_processor_count) if kernel == "K2b-p" else 1
        cfg = nlsolver_torch.NLLSFleetConfig(max_iter=30, solve=solve)
        out, count = fit_counted(torch, residual, torch.zeros(n, b, device=dev, dtype=torch.float64),
                                 cfg, ys, kernel, f"Chebyshev fits [{n}, {b}], {m} points, float64, "
                                 f"{solve}", per)
        err = float((out.x - truth).abs().max())
        log(f"[9] Chebyshev fits [{n}, {b}] float64 {solve} ({kernel}): max |c - truth| {err:.3e}, "
            f"cost {float(out.f_value.max()):.3e}")
        check(bool(torch.isfinite(out.x).all()) and err <= 1e-9,
              f"the {solve} Chebyshev fleet at n={n} did not recover its coefficients ({err:.3e})")
        fits[solve] = out.x
        launches[kernel if kernel == "K2b-p" else f"K3 n={n}"] = count
    d = float((fits["qr_pallas"] - fits["cholesky"]).abs().max())
    log(f"[9] Chebyshev fits [{n}, {b}] float64: qr_pallas (K2b-p) against cholesky, max |dc| "
        f"{d:.3e}")
    check(d <= 1e-9, f"the K2b-p and K3 Chebyshev fits of {n} coefficients differ by {d:.3e}")
    # start points and data given as numpy arrays land on the card
    residual, ys, truth = expfit_scenario(1024, FLEET_M, device=dev)
    out = nlsolver_torch.fit_fleet(residual, np.ones((2, 1024), np.float32),
                                   nlsolver_torch.NLLSFleetConfig(max_iter=30),
                                   data=ys.cpu().numpy())
    log(f"[9] fit_fleet with numpy X0 and data: x on {out.x.device}, max |p-truth| "
        f"{float((out.x - truth).abs().max()):.3e}")
    check(out.x.device.type == "cuda" and float((out.x - truth).abs().max()) <= 1e-3,
          "fit_fleet did not put numpy start points on the card")
    return launches


def abba(torch, kern, kreps, plain, preps, warmup=3):
    """(kernel ms, twin ms): plain, kernel, kernel, plain in one go, the
    least of each pair (``benches.device_ms``).  The kernel's is device time
    behind a device sleep; a plain twin runs more eager ops than the launch
    queue holds, so the host paces it however long the card sleeps: it is
    timed as a plain chain, its real cost per call.  A twin given as a
    number of ms (one timed where its launch was held against it) is not
    run again."""
    from nlsolver_torch.benches import device_ms

    if not callable(plain):
        k1, k2 = (device_ms(kern, kreps, warmup=warmup) for _ in range(2))
        return (min(k1, k2), plain), (k1, k2, plain, plain)
    p1, k1, k2, p2 = (device_ms(f, r, warmup=warmup, sleep=f is kern) for f, r in
                      ((plain, preps), (kern, kreps), (kern, kreps), (plain, preps)))
    return (min(k1, k2), min(p1, p2)), (k1, k2, p1, p2)


def phase_nlls_timing(torch, dev, spd_twin_ms, qr_twin_ms):
    """NLLS fleets per backend, and K2a, K2b and K3 alone against their
    twins and library calls; ``spd_twin_ms`` holds the times at K3-c's and
    K3-d's paths of the twin's order as whole trailing blocks
    (chol_solve_right_looking) and at K3-b's of its plain version, taken in
    phase 7, ``qr_twin_ms`` the twin's at K2b-d's path and at K2a-p's,
    taken in phase 8.  K2a-p and K3-b are timed by ``median_ms``."""
    from nlsolver_torch.benches import bench_nlls_fleet, device_ms
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
    Aq = torch.randn((16, 16, 4096), generator=g, device=dev)
    # the one PyTorch call that computes the same function, on the same
    # systems in the leading-batch layout the library takes
    Aql = Aq.permute(2, 0, 1).contiguous()
    forms = lstsq_forms()
    k3 = spd_forms()

    def spd_timing(kid, n, b, kreps, dtype=torch.float32, twin=None):
        """K3's form ``kid`` on SPD systems [n, n, b] (seed 9), its twin (or
        the twin's time ``twin``), Cholesky factor and solve of the library
        on [b, n, n]."""
        As, bs = spd_case(torch, dev, n, b, dtype, seed=9)
        Al, bl = As.permute(2, 0, 1).contiguous(), bs.t().contiguous()[:, :, None]
        return (lambda: k3[kid](As, bs), kreps,
                twin if twin is not None else (lambda: tsc._chol_solve_batchminor(As, bs)),
                3 if n > 8 else 5,
                lambda: torch.cholesky_solve(bl, torch.linalg.cholesky_ex(Al).L))

    def lstsq_case(kid, A, y, kreps, preps=3, twin=None):
        Al, yl = A.permute(2, 0, 1).contiguous(), y.t().contiguous()[:, :, None]
        return (lambda: forms[kid](A, y), kreps,
                twin if twin is not None else (lambda: tqw.least_squares_wavefront_reference(A, y)),
                preps, lambda: torch.linalg.lstsq(Al, yl))

    # K2b: each form at the NLLS fleet's system, then the shared, warp and
    # cluster forms at the Chebyshev fleets' systems they serve, with the
    # device-memory form beside each (its row takes the float64 fleet's
    # time, where K2b-c took its place)
    sys_s, sys_w = (chebyshev_system(torch, dev, *shape) for shape in (CHEB_SHARED, CHEB_WARP))
    sys_c = chebyshev_system(torch, dev, *CHEB_CLUSTER, torch.float64)
    # K2b-d and K2b-g at the first n past K2b-c's range, [330, 330, 2] f64
    # (phase 8)
    n = K2BD_N
    sys_d = (torch.randn((n, n, 2), generator=g, device=dev, dtype=torch.float64),
             torch.randn((n, 2), generator=g, device=dev, dtype=torch.float64))
    # K2a past its warp form's range: K2a-c and K2a-g at linalg.qr's [170,
    # 170, 32], K2a-d and K2a-g at the first square shape past K2a-c's
    # range in float64, [333, 333, 2] (phase 8)
    A170 = torch.randn((170, 170, 32), generator=g, device=dev)
    A170l = A170.permute(2, 0, 1).contiguous()
    A333 = torch.randn((K2AD_N, K2AD_N, 2), generator=g, device=dev, dtype=torch.float64)
    A333l = A333.permute(2, 0, 1).contiguous()
    # the twin at [333, 333, 2] f64 takes a second or more a call: timed
    # once here, beside K2a-d and K2a-g
    t0 = time.perf_counter()
    tqw.qr_wavefront_reference(A333, compute_q=True)
    torch.cuda.synchronize()
    twin333_ms = (time.perf_counter() - t0) * 1e3
    # K2a-g's float64 kernel loaded ahead: a first launch's lazy load would
    # wait out the device sleep
    tqw.qr_wavefront_global(A333[:2, :2, :1].contiguous(), compute_q=True)
    # name: kernel and repeats, twin and repeats, library call
    times = {
        "K2b-r": lstsq_case("K2b-r", A, y, 50),
        "K2b-s n=2": lstsq_case("K2b-s", A, y, 50),
        "K2b-w n=2": lstsq_case("K2b-w", A, y, 50),
        "K2b-g n=2": lstsq_case("K2b-g", A, y, 50),
        "K2b-s": lstsq_case("K2b-s", *sys_s, 20),
        "K2b-w n=12": lstsq_case("K2b-w", *sys_s, 20),
        "K2b-g n=12": lstsq_case("K2b-g", *sys_s, 20),
        "K2b-w": lstsq_case("K2b-w", *sys_w, 20),
        "K2b-g n=30": lstsq_case("K2b-g", *sys_w, 5),
        "K2b-c": lstsq_case("K2b-c", *sys_c, 10, preps=1),
        "K2b-g n=120": lstsq_case("K2b-g", *sys_c, 1, preps=1),
        # K2b-g at its first n past K2b-c's range, and K2b-d, which takes it
        "K2b-g": lstsq_case("K2b-g", *sys_d, 1, twin=qr_twin_ms["K2b"]),
        "K2b-d": lstsq_case("K2b-d", *sys_d, 10, twin=qr_twin_ms["K2b"]),
        # K3: K3-r at the exp fleet's shape, the planned form at the 12-
        # coefficient Chebyshev fleet's, K3-w at the 30-coefficient one's,
        # each beside K3-g (the form every shape took before the others)
        "K3-r": spd_timing("K3-r", 2, FLEET_B, 50),
        "K3-g n=2": spd_timing("K3-g", 2, FLEET_B, 50),
        "K3 n=12": spd_timing(K3_OF_PLAN[tsc.plan(12, torch.float32)], 12, 16384, 50),
        "K3-g n=12": spd_timing("K3-g", 12, 16384, 20),
        "K3-w": spd_timing("K3-w", 30, 4096, 20),
        "K3-g n=30": spd_timing("K3-g", 30, 4096, 5),
        # K3-c at its path's [240, 240, 16] f64 (phase 7), beside K3-g
        "K3-c": spd_timing("K3-c", K3G_N, K3G_B, 20, torch.float64, spd_twin_ms["K3-c"]),
        "K3-g n=240": spd_timing("K3-g", K3G_N, K3G_B, 1, torch.float64, spd_twin_ms["K3-c"]),
        # K3-g at its first n past K3-c's range, [646, 646, 2] f64 (K3-d by a
        # direct call is timed there beside the dispatcher, below)
        "K3-g": spd_timing("K3-g", K3D_N, 2, 1, torch.float64, spd_twin_ms["K3-d"]),
        "K2a-g n=16": (lambda: tqw.qr_wavefront_global(Aq, compute_q=True), 50,
                       lambda: tqw.qr_wavefront_reference(Aq, compute_q=True), 5,
                       lambda: torch.linalg.qr(Aql, mode="complete")),
        "K2a-c": (lambda: tqw.qr_wavefront_cluster(A170, compute_q=True), 20,
                  lambda: tqw.qr_wavefront_reference(A170, compute_q=True), 1,
                  lambda: torch.linalg.qr(A170l, mode="complete")),
        "K2a-g": (lambda: tqw.qr_wavefront_global(A170, compute_q=True), 1,
                  lambda: tqw.qr_wavefront_reference(A170, compute_q=True), 1,
                  lambda: torch.linalg.qr(A170l, mode="complete")),
        "K2a-d": (lambda: tqw.qr_wavefront_distributed(A333, compute_q=True), 10, twin333_ms, 1,
                  lambda: torch.linalg.qr(A333l, mode="complete")),
        "K2a-g n=333": (lambda: tqw.qr_wavefront_global(A333, compute_q=True), 1, twin333_ms, 1,
                        lambda: torch.linalg.qr(A333l, mode="complete")),
        "K2a-w": (lambda: tqw.qr_wavefront_warp(Aq, compute_q=True), 50,
                  lambda: tqw.qr_wavefront_reference(Aq, compute_q=True), 5,
                  lambda: torch.linalg.qr(Aql, mode="complete")),
    }
    alone = {}
    for name, (kern, kreps, plain, preps, library) in times.items():
        # the forms that take a tenth of a second and more, launched in
        # phases 7 and 8 already: no warm-up; K2a-g at [333, 333, 2] f64,
        # seconds a launch, timed once
        slow = name in ("K2b-c", "K2b-g n=120", "K2b-g", "K3-g n=240", "K3-g", "K2a-g")
        if name == "K2a-g n=333":
            k1 = k2 = k = device_ms(kern, 1, warmup=0)
            p1 = p2 = p = plain
        else:
            (k, p), (k1, k2, p1, p2) = abba(torch, kern, kreps, plain, preps, 0 if slow else 3)
        lib = None
        if library is not None:
            # a library call may wait for the card inside (an error check):
            # its time then stands as that of a chained call
            lib = min(device_ms(library, 5, strict=False) for _ in range(2))
        alone[name] = (k, p, lib)
        log(f"[10] {name} alone: kernel {k * 1e3:.2f} us of device time, plain twin "
            f"{p * 1e3:.2f} us per chained call (CUDA events; kernel "
            f"{k1 * 1e3:.2f}/{k2 * 1e3:.2f}, twin {p1 * 1e3:.2f}/{p2 * 1e3:.2f})"
            + ("" if lib is None else f"; library call {lib * 1e3:.2f} us"))
    alone.update(time_past_distributed(torch, dev, spd_twin_ms, qr_twin_ms))
    # K3-d at its old path is timed once, in the dispatcher's loop
    alone["K3-d"] = alone.pop(f"K3-d n={K3D_N}")
    for new, old in (("K3-r", "K3-g n=2"), ("K3 n=12", "K3-g n=12"), ("K3-w", "K3-g n=30"),
                     ("K3-c", "K3-g n=240"), ("K2b-c", "K2b-g n=120"), ("K3-d", "K3-g"),
                     ("K2b-d", "K2b-g"), ("K2a-c", "K2a-g"), ("K2a-d", "K2a-g n=333")):
        log(f"[10] {new}: {alone[new][0] * 1e3:.2f} us against {old.split()[0]}'s "
            f"{alone[old][0] * 1e3:.2f} us at the same shape ({alone[old][0] / alone[new][0]:.2f}x), "
            f"the library call's {alone[new][2] * 1e3:.2f} us")
    # the rows past their forms' old shapes, each against its library call
    for name in ("K2a-g", "K2a-g n=333", "K2b-g", "K3-g", "K2b-c", "K3-c", "K2b-d", "K3-d",
                 "K2a-c", "K2a-d"):
        k, _, lib = alone[name]
        log(f"[10] {name} at its path's shape: {k:.3f} ms, the library call {lib:.3f} ms, "
            f"{k / lib:.2f}x")
    for solve, rs in runs.items():
        best = max(rs, key=lambda r: r["fits_per_sec"])
        log(f"[10] fleet {solve}: {best['fits_per_sec']:.6g} fits/s "
            f"({best['median_ms']:.3f} ms per {best['steps']}-step fit of {FLEET_B} lanes)")
    for new, old in (("K2a-p n=333", "K2a-g n=333"), ("K2a-p n=333", "K2a-d"),
                     ("K3-b n=646", "K3-g"), ("K3-b n=646", "K3-d"),
                     (f"K3-b n={CHEB_PANEL[0]}", f"K3-d n={CHEB_PANEL[0]}"),
                     ("K2b-p n=330", "K2b-g"), ("K2b-p n=330", "K2b-d")):
        log(f"[10] {new}: {alone[new][0]:.3f} ms against {old.split()[0]}'s {alone[old][0]:.3f} "
            f"ms at the same shape ({alone[old][0] / alone[new][0]:.2f}x)")
    return alone


def median_ms(torch, fn, reps=5, warmup=2):
    """The median over ``reps`` calls of ``fn`` of its time in ms, from CUDA
    events around each call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def time_past_distributed(torch, dev, spd_twin_ms, qr_twin_ms):
    """K2a-p and K2b-p, each at its direct call's shape (K2a-d's and K2b-d's
    paths, [333, 333, 2] and [330, 330, 2] f64), and K3-b through the
    dispatcher at K3-d's old path, [646, 646, 2] f64, and at [1263, 1263, 2]
    f64 (K3-d beside both by a direct call), each also at the first shapes
    of its range, beside the library call that computes the same function
    (torch.linalg.qr, complete; cholesky_ex + cholesky_solve;
    torch.linalg.lstsq), each the median of 5 calls after 2 warm-ups; the
    plain version timed once there (phases 7 and 8 at the first shapes;
    K2b-d's twin at [330, 330, 2]).  Returns (ms, plain ms, library ms) by
    name: "K2a-p", "K3-b" and "K2b-p" at the float64 first shape, "... n=N"
    at the others, "K3-d n=N" beside K3-b."""
    from nlsolver_torch.ops import qr_wavefront as tqw
    from nlsolver_torch.ops import smallchol as tsc

    g = torch.Generator(device=dev).manual_seed(10)
    out = {}

    def once_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for n, b, dtype in ((K2AD_N, 2, torch.float64), (K2AP_N["float64"], 2, torch.float64),
                        (K2AP_N["float32"], 2, torch.float32)):
        kind = str(dtype)[6:]
        A = torch.randn((n, n, b), generator=g, device=dev, dtype=dtype)
        Al = A.permute(2, 0, 1).contiguous()
        ms = median_ms(torch, lambda: tqw.qr_wavefront_panel(A, compute_q=True))
        lib = median_ms(torch, lambda: torch.linalg.qr(Al, mode="complete"))
        plain = qr_twin_ms.get(f"K2a-p [{n}, {n}, {b}] {kind}") or once_ms(
            lambda: tqw.qr_wavefront_reference(A, True))
        name = "K2a-p" if n == K2AP_N["float64"] else f"K2a-p n={n}"
        out[name] = (ms, plain, lib)
        log(f"[10] {name} ([{n}, {n}, {b}] {kind} with Q): {ms:.3f} ms (median of 5 after 2), "
            f"the twin {plain:.1f} ms, torch.linalg.qr {lib:.3f} ms: {ms / lib:.2f}x the library")
        del A, Al
    # K3-b through the dispatcher at K3-d's old path, [646, 646, 2] f64, and
    # at the Chebyshev fits' 1263 coefficients inside K3-d's old range,
    # [1263, 1263, 2] f64, each beside K3-d by a direct call; at the first n
    # past K3-d's range in float64 and float32
    for n, dtype in ((K3D_N, torch.float64), (CHEB_PANEL[0], torch.float64),
                     (K3B_N["float64"], torch.float64), (K3B_N["float32"], torch.float32)):
        kind = str(dtype)[6:]
        A, rhs = spd_case(torch, dev, n, 2, dtype, seed=9)
        Al, bl = A.permute(2, 0, 1).contiguous(), rhs.t().contiguous()[:, :, None]
        check(tsc.plan(n, dtype) == "blocked", f"the plan does not give n={n} in {kind} to K3-b")
        ms = median_ms(torch, lambda: tsc.solve_spd_batchminor(A, rhs))
        lib = median_ms(torch, lambda: torch.cholesky_solve(bl, torch.linalg.cholesky_ex(Al).L))
        name = "K3-b" if n == K3B_N["float64"] else f"K3-b n={n}"
        plain = (spd_twin_ms.get(f"K3-b {kind}") if n in K3B_N.values()
                 else spd_twin_ms.get(name)) or once_ms(
                     lambda: tsc.solve_spd_blocked_reference(A, rhs))
        out[name] = (ms, plain, lib)
        d_ms = ""
        if tsc.distributed_fits(n, dtype):
            d = median_ms(torch, lambda: tsc.solve_spd_distributed(A, rhs))
            out[f"K3-d n={n}"] = (d, spd_twin_ms["K3-d"] if n == K3D_N else None, lib)
            d_ms = f", K3-d by a direct call {d:.3f} ms"
        log(f"[10] {name} ([{n}, {n}, 2] {kind}, solve_spd_batchminor): {ms:.3f} ms (median of 5 "
            f"after 2), its plain version {plain:.1f} ms, cholesky_ex + cholesky_solve "
            f"{lib:.3f} ms{d_ms}: {ms / lib:.2f}x the library")
        del A, rhs, Al, bl
    # K2b-p at the first n past K2b-d's range in float64 and float32 beside
    # torch.linalg.lstsq on the same systems as [B, m, n], the twin (float64)
    # and the twin's order (least_squares_twin_order, float32) timed in
    # phase 8; at K2b-d's path, [330, 330, 2] f64, beside K2b-d, the twin
    # timed there
    for n, dtype in ((K2BP_N["float64"], torch.float64), (K2BP_N["float32"], torch.float32),
                     (K2BD_N, torch.float64)):
        kind = str(dtype)[6:]
        A = torch.randn((n, n, 2), generator=g, device=dev, dtype=dtype)
        y = torch.randn((n, 2), generator=g, device=dev, dtype=dtype)
        Al, yl = A.permute(2, 0, 1).contiguous(), y.t().contiguous()[:, :, None]
        ms = median_ms(torch, lambda: tqw.least_squares_wavefront_panel(A, y))
        lib = median_ms(torch, lambda: torch.linalg.lstsq(Al, yl))
        plain = qr_twin_ms.get(f"K2b-p [{n}, {n}, 2] {kind}") or qr_twin_ms["K2b"]
        name = "K2b-p" if n == K2BP_N["float64"] else f"K2b-p n={n}"
        out[name] = (ms, plain, lib)
        ref = "the twin" if dtype == torch.float64 else "the twin's order"
        log(f"[10] {name} ([{n}, {n}, 2] {kind}): {ms:.3f} ms (median of 5 after 2), {ref} "
            f"{plain:.1f} ms, torch.linalg.lstsq {lib:.3f} ms: {ms / lib:.2f}x the library")
        if n == K2BD_N:
            d_ms = median_ms(torch, lambda: tqw.least_squares_wavefront_distributed(A, y))
            log(f"[10] K2b-p at K2b-d's path [{n}, {n}, 2] {kind}: {ms:.3f} ms against K2b-d's "
                f"{d_ms:.3f} ms (medians of 5 after 2; K2b-d {ms / d_ms:.2f}x faster)")
        del A, y, Al, yl
    return out


def rank2_case(torch, dev, n, b, dtype=None, seed=11):
    """A batch-minor update's inputs on the card: H [n, n, b] symmetric
    positive definite, s, y, g [n, b], rho [b] in [0.1, 2) with every fifth
    lane 0 (no curvature), reset [b] on every third lane."""
    dtype = dtype or torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    M = torch.randn((b, n, n), generator=g, device=dev, dtype=dtype)
    H = (M @ M.transpose(1, 2) / n + torch.eye(n, device=dev, dtype=dtype))
    s, y, grad = (torch.randn((n, b), generator=g, device=dev, dtype=dtype) for _ in range(3))
    rho = 0.1 + 1.9 * torch.rand(b, generator=g, device=dev, dtype=dtype)
    lane = torch.arange(b, device=dev)
    rho[lane % 5 == 0] = 0.0
    return H.permute(1, 2, 0).contiguous(), s, y, grad, rho, lane % 3 == 0


def leading_batch(case):
    """The same update's inputs in K4c's layout: H [b, n, n], s, y [b, n], rho."""
    H, s, y, _, rho, _ = case
    return H.permute(2, 0, 1).contiguous(), s.t().contiguous(), y.t().contiguous(), rho


def phase_rank2(torch, dev):
    from nlsolver_torch.ops import rank2 as tr

    worst = {}  # (kid, label) -> the largest |kernel - twin| there

    def hold(kid, kernel, twin, args, n, label):
        """One counted launch of ``kernel`` (or of the wrapper a partial
        binds) on ``args`` against ``twin``: within KERNEL_TOL_ULPS * n * eps
        of the twin's largest entry (the sums run in ascending order, not
        torch.sum's), bit for bit at n <= 2."""
        counted = getattr(kernel, "func", kernel)
        before = counted.launches
        got = kernel(*args)
        torch.cuda.synchronize()
        check(counted.launches == before + 1, f"{kid} {label}: no launch counted")
        want = twin(*args)
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        notes = []
        for what, a, b in zip(("H'", "d'"), got, want):
            check(bool(torch.isfinite(a).all()), f"{kid} {label}: non-finite {what}")
            err = max_diff(a, b)
            limit = (0.0 if n <= 2 else
                     tr.KERNEL_TOL_ULPS * n * torch.finfo(b.dtype).eps * float(b.abs().max()))
            check(err <= limit, f"{kid} {label}: {what} differs from the twin by {err:.3e}, "
                  f"limit {limit:.3e}")
            worst[kid, label] = max(worst.get((kid, label), 0.0), err)
            notes.append(f"max |{what} - twin| {err:.3e} (limit {limit:.3e})")
        log(f"[11] {kid} {label}: " + ", ".join(notes))
        return got

    def same_bits(kid, got, want, label):
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{kid} and K4b differ at {label} (both take K4b's sums in its order)")
        log(f"[11] {kid} == K4b bit for bit at {label}")

    bm_twin = tr.rank2_direction_batchminor_reference
    resident, rowsplit = tr.rank2_direction_batchminor_resident, tr.rank2_direction_batchminor_rowsplit
    cluster, streamed = tr.rank2_direction_batchminor_cluster, tr.rank2_direction_batchminor_streamed
    main = rank2_case(torch, dev, BFGS_N, BFGS_B)
    Hn, d = hold("K4a", resident, bm_twin, main, BFGS_N, f"[{BFGS_N}, {BFGS_N}, {BFGS_B}] f32")
    H, rho, reset = main[0], main[4], main[5]
    kept = (rho == 0) & ~reset
    check(bool(kept.any()) and torch.equal(Hn[:, :, kept], H[:, :, kept]),
          "K4a changed H on a lane with rho = 0 and no reset")
    for n in (1, 2, 8, 33):
        hold("K4a", resident, bm_twin, rank2_case(torch, dev, n, 16389), n, f"[{n}, {n}, 16389] f32")
    hold("K4a", resident, bm_twin, rank2_case(torch, dev, 16, 4099, torch.float64), 16,
         "[16, 16, 4099] f64")
    # K4b-c and K4b at the wide fleet's shape, bit for bit alike
    wide = rank2_case(torch, dev, WIDE_N, WIDE_B)
    label = f"[{WIDE_N}, {WIDE_N}, {WIDE_B}] f32"
    same_bits("K4b-c", hold("K4b-c", cluster, bm_twin, wide, WIDE_N, label),
              hold("K4b", rowsplit, bm_twin, wide, WIDE_N, label), label)
    Hn2, d2 = hold("K4b", rowsplit, bm_twin, main, BFGS_N, f"[{BFGS_N}, {BFGS_N}, {BFGS_B}] f32")
    check(torch.equal(Hn, Hn2) and torch.equal(d, d2),
          "K4a and K4b differ at n = 16 (both sum in ascending order)")
    log("[11] K4a == K4b bit for bit at n = 16")
    hold("K4b", rowsplit, bm_twin, rank2_case(torch, dev, 45, 1001), 45, "[45, 45, 1001] f32")
    hold("K4b", rowsplit, bm_twin, rank2_case(torch, dev, 45, 1001, torch.float64), 45,
         "[45, 45, 1001] f64")
    # K4b-c at the first and last n of its range with B = 1001 (one-word
    # copies) and 4096, in float32 and float64; K4b-t at the first n past
    # it (the wide fleet's [225, 225, 256] in float32), at n = 304 and 305
    # (where a cluster of 16 could hold every row and where it no longer
    # could), at the second wide fleet's n = 320, at the dispatcher's last n
    # on 256 lanes and at the last n its plan takes, each bit-equal to K4b;
    # the dispatcher on 5, 256 and 4096 lanes: K4a while the slab fits a
    # block's shared memory, K4b-c while a CTA's rows fit, K4b-t to
    # streamed_last(dtype, B), K4b beyond
    forms = {"resident": ("K4a", resident), "cluster": ("K4b-c", cluster),
             "streamed": ("K4b-t", streamed), "rowsplit": ("K4b", rowsplit)}
    for dtype in (torch.float32, torch.float64):
        ns = range(1, 2048)
        first = min(n for n in ns if tr.direction_form(n, dtype, 1) == "cluster")
        last = max(n for n in ns if tr.direction_form(n, dtype, 1) == "cluster")
        most = max(n for n in ns if tr.streamed_plan(n, dtype))  # by a direct call past the end
        kind = str(dtype)[6:]
        for n, b in ((first, 1001), (last, 1001), (last, 4096)):
            case = rank2_case(torch, dev, n, b, dtype)
            label = f"[{n}, {n}, {b}] {kind}"
            same_bits("K4b-c", hold("K4b-c", cluster, bm_twin, case, n, label),
                      hold("K4b", rowsplit, bm_twin, case, n, label), label)
        end = max(last, tr.streamed_last(dtype, WIDE_K4B_B))
        for n, b in sorted({(last + 1, WIDE_K4B_B), (304, 257), (305, 257), (STREAM_N, WIDE_K4B_B),
                            (end, 5), (most, 5)}):
            case = rank2_case(torch, dev, n, b, dtype)
            label = f"[{n}, {n}, {b}] {kind} (chunk {tr.streamed_plan(n, dtype)})"
            same_bits("K4b-t", hold("K4b-t", streamed, bm_twin, case, n, label),
                      hold("K4b", rowsplit, bm_twin, case, n, label), label)
        ends = {}
        for b in (5, WIDE_K4B_B, 4096):
            end = ends[b] = max(last, tr.streamed_last(dtype, b))
            for n in sorted({first - 1, first, last, last + 1, end, end + 1}):
                kid, kernel = forms[tr.direction_form(n, dtype, b)]
                want = ("K4a" if n < first else "K4b-c" if n <= last else "K4b-t" if n <= end
                        else "K4b")
                check(kid == want, f"direction_form({n}, {dtype}, {b}) is {kid}, not {want}")
                before = kernel.launches
                tr.rank2_direction_batchminor(*rank2_case(torch, dev, n, b, dtype))
                check(kernel.launches == before + 1,
                      f"the dispatcher did not take {kid} at n={n}, B={b}")
        end = ends[5]
        hold("K4b", rowsplit, bm_twin, rank2_case(torch, dev, end + 1, 5, dtype), end + 1,
             f"[{end + 1}, {end + 1}, 5] {kind}")
        log(f"[11] the dispatcher takes K4a up to n = {first - 1}, K4b-c for n = {first} to "
            f"{last}, K4b-t past it to n = "
            + ", ".join(f"{e if e > last else 'none'} on {b} lanes" for b, e in ends.items())
            + f" (its plan to {most}), K4b beyond ({kind})")
    # K4c through the dispatcher in each of its forms, held against the
    # twin and, where two forms take n, against the other bit for bit (the
    # same sums in the same order); K4c-r also against its other way; K4c-g
    # past K4c-w's block
    b_twin = tr.rank2_update_batched_reference
    taken = []
    for n, b, dtype, also in ((BFGS_N, BATCH_B, torch.float32, "warp"),
                              (BFGS_N, BFGS_B, torch.float32, "warp"),
                              (2, 8, torch.float32, "warp"),
                              (2, 8, torch.float64, "warp"),
                              (16, 1001, torch.float64, "rows"),
                              (64, 4096, torch.float32, "warp"),
                              (33, 1001, torch.float64, "global"),
                              (K4CG_N, K4CG_B, torch.float32, None),
                              (200, 64, torch.float64, None)):
        args = leading_batch(rank2_case(torch, dev, n, b, dtype))
        form = tr.batched_form(n, dtype)
        kid, wrapper = K4C[form], tr.BATCHED_FORMS[form]
        label = f"[{b}, {n}, {n}] {'f32' if dtype == torch.float32 else 'f64'}"
        before = wrapper.launches
        got = hold(kid, tr.rank2_update_batched_kernel, b_twin, args, n, label)[0]
        check(wrapper.launches == before + 1, f"the dispatcher did not take {kid} at {label}")
        taken.append(f"{kid} at {label}")
        if (n, b) == (BFGS_N, BFGS_B):  # the two layouts: the same update off the reset lanes
            check(torch.equal(got.permute(1, 2, 0)[:, :, ~reset], Hn[:, :, ~reset]),
                  "K4c-r differs from K4a on the same update")
            log(f"[11] K4c-r == K4a off the reset lanes at {label}")
        if kid == "K4c-r":  # the way rows_staged does not take at this n and B
            staged = not tr.rows_staged(n, dtype, b)
            way = "staged" if staged else "straight"
            check(torch.equal(got, tr.rank2_update_batched_rows(*args, _staged=staged)),
                  f"K4c-r's two ways differ at {label}")
            log(f"[11] K4c-r == K4c-r {way} bit for bit at {label}")
        if also:
            other = K4C[also]
            check(torch.equal(got, hold(other, tr.BATCHED_FORMS[also], b_twin, args, n, label)[0]),
                  f"{kid} and {other} differ at {label}")
            log(f"[11] {kid} == {other} bit for bit at {label}")
    log("[11] the dispatcher takes " + ", ".join(taken))
    small = rank2_case(torch, dev, 4, 64)
    half = tuple(t if t.dtype == torch.bool else t.half() for t in small)
    refused = (
        ("non-contiguous", tr.rank2_direction_batchminor, (small[0].transpose(0, 1), *small[1:])),
        ("f16", tr.rank2_direction_batchminor, half),
        ("non-contiguous", tr.rank2_update_batched,
         (small[0].permute(2, 1, 0), *leading_batch(small)[1:])),
        ("f16", tr.rank2_update_batched, leading_batch(half)),
    )
    for what, fn, args in refused:
        try:
            fn(*args)
        except ValueError as e:
            log(f"[11] {fn.__name__} refuses a {what} input: {e}")
        else:
            check(False, f"{fn.__name__} took a {what} input")
    return worst


def rank2_counts():
    from nlsolver_torch.ops import rank2 as tr

    return {"K4a": tr.rank2_direction_batchminor_resident.launches,
            "K4b-c": tr.rank2_direction_batchminor_cluster.launches,
            "K4b-t": tr.rank2_direction_batchminor_streamed.launches,
            "K4b": tr.rank2_direction_batchminor_rowsplit.launches,
            "K4c": tr.rank2_update_batched_kernel.launches,
            "K4c-r": tr.rank2_update_batched_rows.launches,
            "K4c-w": tr.rank2_update_batched_warp.launches,
            "K4c-g": tr.rank2_update_batched_global.launches}


def phase_bfgs_slice(torch, dev):
    import numpy as np

    import nlsolver_torch
    from nlsolver_torch import BFGSFleetConfig, ops
    from nlsolver_torch.benches import bowls_scenario

    def drive(label, fn_cols, x0, cfg, kernel):
        """One fleet through minimize, counted: ``kernel`` launched once per
        host step, the other K4 kernels never."""
        reset_counts()
        t0 = time.perf_counter()
        res = nlsolver_torch.minimize(None, x0, method="bfgs", layout="fleet", config=cfg,
                                      fn_cols=fn_cols)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = rank2_counts()
        # done.all() is read after every step, and the last lane to finish
        # halts on step max(iterations) + 1
        steps = int(res.iterations.max()) + 1
        its = res.iterations.float()
        log(f"[12] {label}: {wall:.3f} s, host steps {steps}, launches {counts}, iterations "
            f"median {float(its.median()):.0f} max {int(its.max())}, converged "
            f"{float(res.converged.float().mean()):.6f}, f max {float(res.f_value.max()):.3e}")
        check(res.x.is_cuda and bool(torch.isfinite(res.x).all())
              and bool(torch.isfinite(res.f_value).all()), f"{label}: x not on the card or non-finite")
        for k, c in counts.items():
            want = steps if k == kernel else 0
            check(c == want, f"{label}: {k} launched {c} times, expected {want} in {steps} host steps")
        return res, steps

    launches = {}
    fn_cols, centers, _ = bowls_scenario(BFGS_B, BFGS_N, device=dev)
    X0 = torch.zeros(BFGS_N, BFGS_B, device=dev)
    # least converged share per search: the shares this fleet gives (0.988174
    # and 0.927322, the same lanes as the JAX package in f32), rounded down
    for ls, least in (("more_thuente", 0.98), ("speculative", 0.92)):
        res, steps = drive(f"bowls [{BFGS_N}, {BFGS_B}] {ls}", fn_cols, X0,
                           BFGSFleetConfig(max_iter=30, linesearch=ls), "K4a")
        err = (res.x - centers).abs().amax(dim=0)
        off, off_conv = float(err.max()), float(err[res.converged].max())
        share = float(res.converged.float().mean())
        solved = float((res.f_value < 1e-4).float().mean())
        log(f"[12] bowls {ls}: max |x - center| {off_conv:.3e} on converged lanes (limit 5e-3), "
            f"{off:.3e} on all (limit 1e-2), converged {share:.6f} (limit {least}), solved "
            f"{solved:.6f} (limit 0.999), function calls median "
            f"{float(res.function_calls.float().median()):.0f}")
        check(tuple(res.x.shape) == (BFGS_N, BFGS_B), "misshapen x")
        # every lane halts by a tolerance, not by max_iter: grad_norm <
        # grad_eps (``converged``; with scales >= 0.5 that puts x within 5e-3
        # of the center), or a gradient norm that moved by less than grad_eps
        # (the reference's second stopping rule; in f32 it stops these lanes
        # in the JAX package too).  A lane stopped so lies within 1e-2
        check(int(res.iterations.max()) < 30, f"bowls {ls}: a lane ran into max_iter")
        check(share >= least, f"bowls {ls}: converged share {share} below {least}")
        check(off_conv < 5e-3 and off < 1e-2, f"bowls {ls}: lanes off their centers")
        check(solved >= 0.999 and float(res.f_value.max()) < 1e-3,
              f"bowls {ls}: solved share {solved} below 0.999 or a lane far off")
        launches.setdefault("K4a", steps)  # the default search's run

    # a start that is no tensor lands on the card
    small_cols, small_centers, _ = bowls_scenario(256, BFGS_N, seed=1, device=dev)
    res, _ = drive("numpy x0 [16, 256]", small_cols, np.zeros((BFGS_N, 256), np.float32),
                   BFGSFleetConfig(max_iter=30), "K4a")
    check(float((res.x - small_centers).abs().max()) < 1.42e-2, "numpy x0: a lane is off its center")

    B = 64
    starts = torch.stack([torch.full((B,), -0.5), torch.linspace(-1.0, 1.0, B)]).to(dev)
    res, _ = drive("Rosenbrock [2, 64]", lambda X: 100.0 * (X[0] ** 2 - X[1]) ** 2 + (X[0] - 1.0) ** 2,
                   starts, BFGSFleetConfig(max_iter=100, grad_eps=1e-5), "K4a")
    check(float(res.f_value.max()) < 1e-6 and float((res.x - 1.0).abs().max()) < 1e-2,
          "the Rosenbrock fleet did not reach (1, 1)")

    # wide fleets: through K4b-c at WIDE_N, through K4b-t at the first n
    # past K4b-c's range and at STREAM_N, past what a cluster of 16 could
    # hold
    for n, b, kid in ((WIDE_N, WIDE_B, "K4b-c"), (WIDE_K4B_N, WIDE_K4B_B, "K4b-t"),
                      (STREAM_N, WIDE_K4B_B, "K4b-t n=320")):
        wide_cols, wide_centers, _ = bowls_scenario(b, n, seed=2, device=dev)
        res, steps = drive(f"wide bowls [{n}, {b}]", wide_cols, torch.zeros(n, b, device=dev),
                           BFGSFleetConfig(max_iter=30), kid.split()[0])
        off = float((res.x - wide_centers).abs().max())
        log(f"[12] wide bowls [{n}, {b}]: max |x - center| {off:.3e}, converged "
            f"{float(res.converged.float().mean()):.6f}")
        check(off < 5e-2, f"the wide fleet [{n}, {b}] is far off its centers")
        launches[kid] = steps

    # K4b, the form the first wide fleet's n took before K4b-t, by a direct
    # call at its shape
    reset_counts()
    ops.rank2_direction_batchminor_rowsplit(*rank2_case(torch, dev, WIDE_K4B_N, WIDE_K4B_B))
    torch.cuda.synchronize()
    launches["K4b"] = rank2_counts()["K4b"]
    check(launches["K4b"] == 1, f"K4b's direct call counted {launches['K4b']}")
    # the public leading-batch update through the dispatcher (K4c-r at
    # this n), and K4c-w, the form before, by a direct call at the
    # single-instance BFGS's shape
    args = leading_batch(rank2_case(torch, dev, BFGS_N, BFGS_B, seed=12))
    reset_counts()
    out = ops.rank2_update_batched(*args)
    torch.cuda.synchronize()
    counts = rank2_counts()
    want = dict.fromkeys(counts, 0) | {"K4c": 1, "K4c-r": 1}
    check(counts == want, f"ops.rank2_update_batched launched {counts}")
    check(tuple(out.shape) == (BFGS_B, BFGS_N, BFGS_N) and bool(torch.isfinite(out).all()),
          "ops.rank2_update_batched: non-finite or misshapen")
    log(f"[12] ops.rank2_update_batched [{BFGS_B}, {BFGS_N}, {BFGS_N}]: launches {counts}")
    reset_counts()
    ops.rank2_update_batched_warp(*leading_batch(rank2_case(torch, dev, BFGS_N, BATCH_B, seed=12)))
    torch.cuda.synchronize()
    launches["K4c-w"] = rank2_counts()["K4c-w"]
    check(launches["K4c-w"] == 1, f"K4c-w's direct call counted {launches['K4c-w']}")
    return launches


def phase_bfgs_timing(torch, dev):
    from nlsolver_torch.benches import bench_bfgs_fleet
    from nlsolver_torch.ops import rank2 as tr

    runs = {}
    for ls in ("more_thuente", "speculative", "speculative", "more_thuente"):
        r = bench_bfgs_fleet(runs=3, linesearch=ls)
        runs.setdefault(ls, []).append(r)
        log(f"[13] {r['name']}: median {r['median_ms']:.3f} ms / {r['host_steps']} steps, "
            f"min {r['min_ms']:.3f} ms, {r['iters_per_sec']:.6g} instance iterations/s, "
            f"solved {r['solved_frac']:.6f}, converged {r['converged_frac']:.6f}")

    main = rank2_case(torch, dev, BFGS_N, BFGS_B)
    wide = rank2_case(torch, dev, WIDE_N, WIDE_B)
    past = rank2_case(torch, dev, WIDE_K4B_N, WIDE_K4B_B)
    far = rank2_case(torch, dev, STREAM_N, WIDE_K4B_B)
    lead = leading_batch(main)
    batch = leading_batch(rank2_case(torch, dev, BFGS_N, BATCH_B))
    wide_lead = leading_batch(rank2_case(torch, dev, K4CG_N, K4CG_B))
    b_twin = tr.rank2_update_batched_reference
    bm_twin = tr.rank2_direction_batchminor_reference
    staged = [tr.rows_staged(BFGS_N, torch.float32, b) for b in (BATCH_B, BFGS_B)]
    # K4b-t at the wide fleets' [225, 225, 256] and [320, 320, 256] (phase
    # 12), K4b (the form before) and K4b-c on clusters of 16 (the widening
    # alone) beside it; K4b beside K4b-c at [128, 128, 4096]
    times = {
        "K4a": (lambda: tr.rank2_direction_batchminor_resident(*main), lambda: bm_twin(*main)),
        "K4b-t": (lambda: tr.rank2_direction_batchminor_streamed(*past), lambda: bm_twin(*past)),
        "K4b": (lambda: tr.rank2_direction_batchminor_rowsplit(*past), lambda: bm_twin(*past)),
        "K4b-c C=16": (lambda: tr.rank2_direction_batchminor_cluster(*past, size=16, lanes=8),
                       lambda: bm_twin(*past)),
        "K4b-t n=320": (lambda: tr.rank2_direction_batchminor_streamed(*far),
                        lambda: bm_twin(*far)),
        "K4b n=320": (lambda: tr.rank2_direction_batchminor_rowsplit(*far), lambda: bm_twin(*far)),
        "K4b n=128": (lambda: tr.rank2_direction_batchminor_rowsplit(*wide),
                      lambda: bm_twin(*wide)),
        "K4b-c": (lambda: tr.rank2_direction_batchminor_cluster(*wide), lambda: bm_twin(*wide)),
        "K4b n=16": (lambda: tr.rank2_direction_batchminor_rowsplit(*main), lambda: bm_twin(*main)),
        # K4c's forms: K4c-r (the way rows_staged takes, then the other)
        # and K4c-w at the single-instance BFGS's [10000, 16, 16] and at
        # [65536, 16, 16], K4c-g at [256, 256, 256]
        "K4c-r": (lambda: tr.rank2_update_batched_rows(*batch), lambda: b_twin(*batch)),
        "K4c-r other way": (lambda: tr.rank2_update_batched_rows(*batch, _staged=not staged[0]),
                            lambda: b_twin(*batch)),
        "K4c-w": (lambda: tr.rank2_update_batched_warp(*batch), lambda: b_twin(*batch)),
        "K4c-r B=65536": (lambda: tr.rank2_update_batched_rows(*lead), lambda: b_twin(*lead)),
        "K4c-r other way B=65536": (
            lambda: tr.rank2_update_batched_rows(*lead, _staged=not staged[1]),
            lambda: b_twin(*lead)),
        "K4c-w B=65536": (lambda: tr.rank2_update_batched_warp(*lead), lambda: b_twin(*lead)),
        "K4c-g": (lambda: tr.rank2_update_batched_global(*wide_lead), lambda: b_twin(*wide_lead)),
    }
    alone = {}
    for name, (kern, plain) in times.items():
        (k, p), (k1, k2, p1, p2) = abba(torch, kern, 30, plain, 5)
        alone[name] = (k, p, None)  # no single PyTorch call computes the update
        log(f"[13] {name} alone: kernel {k * 1e3:.2f} us of device time, plain twin "
            f"{p * 1e3:.2f} us per chained call (CUDA events; kernel "
            f"{k1 * 1e3:.2f}/{k2 * 1e3:.2f}, twin {p1 * 1e3:.2f}/{p2 * 1e3:.2f})")
    for b, way, key in ((BATCH_B, staged[0], ""), (BFGS_B, staged[1], " B=65536")):
        ways = ("straight", "staged") if way else ("staged", "straight")
        log(f"[13] K4c-r at [{b}, {BFGS_N}, {BFGS_N}] f32: rows_staged takes the {ways[1]} way, "
            f"{alone['K4c-r' + key][0] * 1e3:.2f} us; the {ways[0]} way "
            f"{alone['K4c-r other way' + key][0] * 1e3:.2f} us")
    for ls, rs in runs.items():
        best = max(rs, key=lambda r: r["iters_per_sec"])
        log(f"[13] fleet {ls}: {best['iters_per_sec']:.6g} instance iterations/s "
            f"({best['median_ms']:.3f} ms per run of {BFGS_B} lanes, {best['host_steps']} host steps)")
    return alone


def phase_eigh(torch, dev):
    from nlsolver_torch.benches import spd_fleet
    from nlsolver_torch.linalg.eigh_qr import eigh_library_batched
    from nlsolver_torch.linalg.jacobi import eigh_jacobi
    from nlsolver_torch.ops import eigh_jacobi as te

    f32, f64 = torch.float32, torch.float64
    forms = {"K5r": te.eigh_jacobi_registers, "K5a": te.eigh_jacobi_resident,
             "K5c": te.eigh_jacobi_cluster, "K5b": te.eigh_jacobi_global}
    worst = dict.fromkeys(forms, 0.0)

    def hold(A, sweeps, label, kids, library=True):
        """The forms ``kids`` on ``A`` against the twin, bit for bit, then
        (with ``library``) against the library's f64 decomposition of the
        same matrices (of the first 1024 lanes where n >= 32: the library
        takes seconds there)."""
        n, _, b = A.shape
        tw, tV = eigh_jacobi(A, sweeps=sweeps, sort=False)
        for kid in kids:
            kernel = forms[kid]
            before = kernel.launches
            w, V = kernel(A, sweeps)
            torch.cuda.synchronize()
            check(kernel.launches == before + 1, f"{kid} {label}: no launch counted")
            check(bool(torch.isfinite(w).all()) and bool(torch.isfinite(V).all()),
                  f"{kid} {label}: non-finite output")
            worst[kid] = max(worst[kid], max_diff(w, tw), max_diff(V, tV))
            check(torch.equal(w, tw) and torch.equal(V, tV),
                  f"{kid} {label}: differs from the twin: w {max_diff(w, tw):.3e}, "
                  f"V {max_diff(V, tV):.3e}")
        if not library:
            log(f"[14] {' and '.join(kids)} {label}, {sweeps} sweeps: bit-equal to the twin")
            return
        lanes = b if n < 32 else min(b, 1024)
        Al = A[:, :, :lanes].permute(2, 0, 1).double().contiguous()
        w_ref, _ = eigh_library_batched(Al)
        wl, Vl = w[:, :lanes].t().double(), V[:, :, :lanes].permute(2, 0, 1).double()
        top = float(w_ref.abs().max())
        w_err = float((wl.sort(dim=1).values - w_ref).abs().max()) / top
        recon = float(((Vl * wl[:, None, :]) @ Vl.transpose(1, 2) - Al).abs().max()
                      / Al.abs().max())
        orth = float((Vl.transpose(1, 2) @ Vl - torch.eye(n, device=dev, dtype=f64)).abs().max())
        # f32: the JAX package's 1e-5 bar up to n = 16; an entry of V passes
        # through n - 1 rotations a sweep, so the roundoff grows with n
        limit = 1e-5 * max(1.0, n / 16) if A.dtype == f32 else 1e-11
        log(f"[14] {' and '.join(kids)} {label}: bit-equal to the twin; against "
            f"torch.linalg.eigh in f64 on {lanes} lanes: max|w - w_ref|/max|w_ref| {w_err:.3e}, "
            f"max|V diag(w) Vt - A|/max|A| {recon:.3e}, max|VtV - I| {orth:.3e} (limit {limit:g})")
        check(w_err <= limit and recon <= limit and orth <= limit,
              f"K5 {label}: not an eigendecomposition to {limit:g}")

    # the first n that K5a refuses, where the dispatcher turns to K5c
    first = {dtype: next(n for n in range(2, 1024) if not te.resident_fits(n, dtype))
             for dtype in (f32, f64)}
    edge = first[f32]
    check(edge == CMA_EDGE_N, f"K5a's range in f32 ends at n = {edge - 1}, expected {CMA_EDGE_N - 1}")
    check(te.cluster_plan(CMA_C4_N, f32)[0] == 4 and not te.cluster_fits(K5B_N, f32)
          and te.cluster_fits(K5B_N - 1, f32), "the wide fleets' n left their forms' ranges")
    # every form at the shapes that the main path (phase 15) runs it at: K5c
    # at the wide fleets' [170, 170, 256] and [300, 300, 256] with 8 sweeps,
    # K5b at [473, 473, 16] with 2
    cases = [(CMA_N, CMA_B, f32), (17, 4096, f32), (2, 65536, f32), (8, 4096, f64),
             (CMA_N, 4099, f32), (CMA_N, 4099, f64), (31, 512, f32), (32, 512, f32),
             (56, CMA_WIDE_B, f32), (64, CMA_WIDE_B, f32), (edge - 1, 64, f32),
             (edge, CMA_EDGE_B, f32), (CMA_C4_N, CMA_EDGE_B, f32)]
    for n, b, dtype in cases:
        kids = [k for k, fits in (("K5r", te.registers_fit(n, dtype)),
                                  ("K5a", te.resident_fits(n, dtype)),
                                  ("K5c", n >= edge - 1), ("K5b", n <= 64 or n == edge)) if fits]
        C = te.cluster_plan(n, dtype)[0]
        hold(spd_fleet(b, n, device=dev, dtype=dtype), 8,
             f"[{n}, {n}, {b}] {str(dtype)[6:]}" + (f" (C = {C})" if "K5c" in kids else ""), kids)
    hold(spd_fleet(K5B_B, K5B_N, device=dev), K5B_SWEEPS, f"[{K5B_N}, {K5B_N}, {K5B_B}] float32",
         ["K5b"], library=False)
    # each cluster size at its first and last n, and K5b where K5c ends in
    # float64: few lanes and sweeps
    ranges = {}
    for dtype in (f32, f64):
        sizes = [te.cluster_plan(n, dtype)[0] for n in range(first[dtype], 1024)]
        ends = [first[dtype] + i for i, c in enumerate(sizes)
                if i + 1 == len(sizes) or sizes[i + 1] != c]
        ranges[dtype] = ends
        firsts = [first[dtype]] + [e + 1 for e in ends[:-2]]
        for n in sorted(set(firsts + ends[:-1])):
            hold(spd_fleet(4, n, device=dev, dtype=dtype), 2,
                 f"[{n}, {n}, 4] {str(dtype)[6:]} (C = {te.cluster_plan(n, dtype)[0]})", ["K5c"],
                 library=False)
    first_b = ranges[f64][-2] + 1
    hold(spd_fleet(4, first_b, device=dev, dtype=f64), 2, f"[{first_b}, {first_b}, 4] float64",
         ["K5b"], library=False)
    check(ranges[f32][:-1] == [238, 336, 472] and ranges[f64][:-1] == [167, 236, 329],
          f"K5c's cluster sizes end at {ranges[f32][:-1]} (f32), {ranges[f64][:-1]} (f64)")
    log("[14] K5c's clusters held at once (cudaOccupancyMaxActiveClusters; dtype, C, bytes a "
        f"CTA): {te.CLUSTER_OCCUPANCY}")
    # a diagonal matrix takes the identity rotation (apq == 0) in every round
    d = torch.rand((8, 4096), device=dev) + 0.5
    D = torch.diag_embed(d.t()).permute(1, 2, 0).contiguous()
    for kernel in forms.values():
        w, V = kernel(D, 8)
        check(torch.equal(w, d) and torch.equal(V, torch.eye(8, device=dev)[:, :, None].expand_as(V)),
              f"{kernel.__name__} changed a diagonal matrix")
    log("[14] a diagonal matrix comes back as it was, V = I, no NaN")
    # the dispatcher that keeps the JAX name: K5r while a lane fits its
    # threads' registers, K5a while the slabs fit a block, K5c while they
    # fit a cluster, K5b beyond; sorted
    takes = []
    for dtype in (f32, f64):
        last = ranges[dtype][-2]
        reg = max(n for n in range(1, 64) if te.registers_fit(n, dtype))
        takes += [(reg, dtype, "K5r"), (reg + 1, dtype, "K5a"), (first[dtype] - 1, dtype, "K5a"),
                  (first[dtype], dtype, "K5c"), (last, dtype, "K5c"), (last + 1, dtype, "K5b")]
    for n, dtype, kid in takes:
        kernel = forms[kid]
        before = kernel.launches
        out = te.eigh_jacobi_pallas(spd_fleet(4 if n > 169 else 64, n, device=dev, dtype=dtype),
                                    sweeps=2 if n > 169 else 10)
        check(kernel.launches == before + 1,
              f"the dispatcher did not take {kernel.__name__} at n={n} in {dtype}")
        check(bool((out.eigenvalues.diff(dim=0) >= 0).all()), f"n={n}: eigenvalues not ascending")
    log("[14] the dispatcher takes " + ", ".join(f"{kid} at n = {n} ({str(dt)[6:]})"
                                                 for n, dt, kid in takes))
    small = spd_fleet(64, 4, device=dev)
    for what, arg in (("non-contiguous", small.transpose(0, 1)), ("f16", small.half())):
        try:
            te.eigh_jacobi_pallas(arg)
        except ValueError as e:
            log(f"[14] eigh_jacobi_pallas refuses a {what} input: {e}")
        else:
            check(False, f"eigh_jacobi_pallas took a {what} input")
    return worst


def eigh_counts():
    from nlsolver_torch.ops import eigh_jacobi as te

    return {"K5r": te.eigh_jacobi_registers.launches, "K5a": te.eigh_jacobi_resident.launches,
            "K5c": te.eigh_jacobi_cluster.launches, "K5b": te.eigh_jacobi_global.launches}


def only(kid, launches):
    """The launch counts of a run that went through form ``kid`` alone."""
    return {k: launches * (k == kid) for k in ("K5r", "K5a", "K5c", "K5b")}


def lazy_refreshes(gens, interval):
    """Refreshes of the deferred-covariance mode in ``gens`` generations
    with no kick: one whenever the window of ``interval`` slots is full."""
    filled = refreshes = 0
    for _ in range(gens):
        if filled >= interval:
            refreshes, filled = refreshes + 1, 0
        filled += 1
    return refreshes


def phase_cmaes_slice(torch, dev):
    import numpy as np

    import nlsolver_torch
    from nlsolver_torch import CMAESFleetConfig
    from nlsolver_torch.benches import (bowls_scenario, rastrigin_fleet_config,
                                        run_rastrigin_fleet)
    from nlsolver_torch.core import Bounds

    launches = {}
    # (a) the bench scenario through init / step / drive_fleet_scan; the
    # median limits are the JAX fleet's in f32 (tests/test_torch_cmaes_fleet.py)
    for label, interval, defer, want, limit in (
            ("eager", 1, False, CMA_GENS, 80.0),
            ("interval 5, deferred", 5, True, lazy_refreshes(CMA_GENS, 5), 85.0)):
        reset_counts()
        t0 = time.perf_counter()
        final = run_rastrigin_fleet(rastrigin_fleet_config("pallas", interval, defer),
                                    CMA_B, CMA_N, CMA_GENS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = eigh_counts()
        med = float(final.best_value.median())
        log(f"[15] Rastrigin [{CMA_N}, {CMA_B}] {label}: {wall:.3f} s for {CMA_GENS} generations, "
            f"launches {counts} (expected K5r {want}), best value median {med:.4f} "
            f"(limit {limit}), max {float(final.best_value.max()):.4f}, from 324.0")
        check(counts == only("K5r", want), f"{label}: launches {counts}, expected K5r {want}")
        check(final.gen == CMA_GENS and bool((final.iteration == CMA_GENS).all()),
              f"{label}: not every lane ran {CMA_GENS} generations")
        check(tuple(final.best_x.shape) == (CMA_N, CMA_B) and bool(torch.isfinite(final.best_x).all())
              and bool(torch.isfinite(final.C).all()), f"{label}: non-finite or misshapen state")
        check(med < limit and float(final.best_value.max()) < 324.0,
              f"{label}: the fleet did not descend as the JAX fleet does")
        launches.setdefault("K5r", counts["K5r"])  # the eager run's

    # (b) minimize until every lane halts.  The fleet's objective is one
    # function for all lanes, so the bowls' per-lane centers enter as start
    # points: minimizing sum(s (x - c_b)^2) from 0 is minimizing sum(s x^2)
    # from -c_b.  Limits from the JAX fleet in f32 at B = 1024: every lane
    # converged and below 1e-6, 97 % below 1e-9
    _, centers, scales = bowls_scenario(CMA_B, 8, device=dev)
    s0 = scales[:, 0].clone()
    cfg = CMAESFleetConfig(eigh_method="pallas")

    def bowl(x):
        return (s0 * x * x).sum()

    reset_counts()
    t0 = time.perf_counter()
    res = nlsolver_torch.minimize(bowl, -centers, method="cmaes", layout="fleet", config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, steps = eigh_counts(), int(res.iterations.max()) + 1
    lam = 4 + int(3 * np.log(8))
    solved = float((res.f_value < 1e-9).float().mean())
    log(f"[15] minimize(method='cmaes', layout='fleet') on bowls [8, {CMA_B}]: {wall:.3f} s, host "
        f"steps {steps}, launches {counts}, iterations median "
        f"{float(res.iterations.float().median()):.0f} max {int(res.iterations.max())}, converged "
        f"{float(res.converged.float().mean()):.6f}, f max {float(res.f_value.max()):.3e} (limit "
        f"1e-6), share below 1e-9 {solved:.6f} (limit 0.97)")
    check(res.x.is_cuda and tuple(res.x.shape) == (8, CMA_B) and bool(torch.isfinite(res.x).all()),
          "bowls: x not on the card, misshapen or non-finite")
    check(counts == only("K5r", steps), f"bowls: launches {counts} in {steps} host steps")
    check(int(res.iterations.max()) <= cfg.max_iter and bool(res.converged.all()),
          "bowls: a lane ran into max_iter or halted unconverged")
    check(torch.equal(res.function_calls, 1 + lam * res.iterations),
          "bowls: function_calls is not 1 + lam * iterations")
    check(float(res.f_value.max()) < 1e-6 and solved >= 0.97, "bowls: lanes short of the minimum")

    # a start that is no tensor lands on the card
    res = nlsolver_torch.minimize(bowl, np.full((8, 256), 0.7, np.float32), method="cmaes",
                                  layout="fleet", config=cfg)
    check(res.x.is_cuda and float(res.f_value.max()) < 1e-5, "numpy x0: not on the card or unsolved")
    # the corner optimum of a bounded problem: projection repair keeps every lane in the box
    box = Bounds(torch.zeros(2, device=dev), torch.full((2,), 4.0, device=dev))
    res = nlsolver_torch.minimize(lambda x: ((x + 1.0) ** 2).sum(), torch.full((2, 4096), 2.0, device=dev),
                                  method="cmaes", layout="fleet", bounds=box,
                                  config=CMAESFleetConfig(eigh_method="pallas", max_iter=200))
    log(f"[15] bounded fleet [2, 4096]: x in [{float(res.x.min()):.3e}, {float(res.x.max()):.3e}], "
        f"f median {float(res.f_value.median()):.6f}")
    check(float(res.x.min()) >= 0.0 and float(res.x.max()) <= 1e-2
          and abs(float(res.f_value.median()) - 2.0) < 1e-2, "the bounded fleet left its box or its corner")

    # (c) wide fleets: n = 56 and n = 64 through K5a; beyond its range K5c
    # (clusters of 2 at n = 170, of 4 at n = 300); beyond K5c's, K5b (one
    # generation with 2 sweeps: the twin it is held against takes a quarter
    # of a second a sweep there)
    for n, b, gens, kid, sweeps in ((56, CMA_WIDE_B, 5, "K5a", 8), (64, CMA_WIDE_B, 5, "K5a", 8),
                                    (CMA_EDGE_N, CMA_EDGE_B, 2, "K5c", 8),
                                    (CMA_C4_N, CMA_EDGE_B, 2, "K5c", 8),
                                    (K5B_N, K5B_B, 1, "K5b", K5B_SWEEPS)):
        cfg = dataclasses.replace(rastrigin_fleet_config("pallas"), sweeps=sweeps)
        reset_counts()
        t0 = time.perf_counter()
        final = run_rastrigin_fleet(cfg, b, n, gens, device=dev)
        torch.cuda.synchronize()
        counts = eigh_counts()
        start = 20.25 * n  # Rastrigin at -0.5 in every coordinate
        log(f"[15] wide Rastrigin [{n}, {b}], {sweeps} sweeps: {time.perf_counter() - t0:.3f} s for "
            f"{gens} generations, launches {counts}, best value median "
            f"{float(final.best_value.median()):.2f} from {start}")
        check(counts == only(kid, gens), f"wide n={n}: launches {counts}")
        check(bool(torch.isfinite(final.best_value).all()) and bool(torch.isfinite(final.Bv).all())
              and float(final.best_value.median()) < start, f"wide n={n}: non-finite or no descent")
        if kid != "K5c" or n == CMA_EDGE_N:  # K5a: the n = 64 run's; K5c: the n = 170 run's
            launches[kid] = counts[kid]
    return launches


def phase_cmaes_timing(torch, dev):
    from nlsolver_torch.benches import bench_cmaes_fleet, device_ms, spd_fleet
    from nlsolver_torch.linalg.eigh_qr import eigh_library_batched
    from nlsolver_torch.linalg.jacobi import eigh_jacobi
    from nlsolver_torch.ops import eigh_jacobi as te

    # per input and sweeps: the forms timed on it (name, kernel, repeats);
    # the twin and the library call run once on the same input.  Each form
    # at a shape it serves: K5c at the CMA-ES fleet's B past K5a, K5b where
    # K5c ends, on a few lanes and sweeps
    inputs = [
        (spd_fleet(CMA_B, CMA_N, device=dev), 8,
         [("K5r", te.eigh_jacobi_registers, 10), ("K5a n=16", te.eigh_jacobi_resident, 10)]),
        (spd_fleet(CMA_WIDE_B, 56, device=dev), 8, [("K5a n=56", te.eigh_jacobi_resident, 3)]),
        (spd_fleet(CMA_WIDE_B, 64, device=dev), 8, [("K5a", te.eigh_jacobi_resident, 3)]),
        (spd_fleet(CMA_EDGE_B, CMA_EDGE_N, device=dev), 8, [("K5c", te.eigh_jacobi_cluster, 3)]),
        (spd_fleet(K5B_B, K5B_N, device=dev), K5B_SWEEPS, [("K5b", te.eigh_jacobi_global, 1)]),
    ]
    alone = {}
    for A, sweeps, forms in inputs:
        Al = A.permute(2, 0, 1).contiguous()
        p1 = device_ms(lambda: eigh_jacobi(A, sweeps=sweeps, sort=False), 2, warmup=1, sleep=False)
        ks = {name: [device_ms(lambda: kernel(A, sweeps), kreps, warmup=2)]
              for name, kernel, kreps in forms}
        for name, kernel, kreps in reversed(forms):
            ks[name].append(device_ms(lambda: kernel(A, sweeps), kreps, warmup=1))
        p2 = device_ms(lambda: eigh_jacobi(A, sweeps=sweeps, sort=False), 2, warmup=0, sleep=False)
        lib = device_ms(lambda: eigh_library_batched(Al), 1 if A.shape[0] > 32 else 3, warmup=1,
                        strict=False)
        for name, (k1, k2) in ks.items():
            alone[name] = (min(k1, k2), min(p1, p2), lib)
            log(f"[16] {name} {list(A.shape)}, {sweeps} sweeps, alone: kernel {min(k1, k2):.3f} ms "
                f"of device time ({k1:.3f}/{k2:.3f}), plain twin {min(p1, p2):.3f} ms per call "
                f"({p1:.3f}/{p2:.3f}), torch.linalg.eigh on {list(Al.shape)} {lib:.3f} ms")
    log(f"[16] [16, 16, {CMA_B}]: the register form {alone['K5r'][0]:.3f} ms, the shared-memory "
        f"form {alone['K5a n=16'][0]:.3f} ms, {alone['K5a n=16'][0] / alone['K5r'][0]:.2f} times")

    # the fleet per eigensolver; the plain twin at a fifth of the depth (it takes 0.1 s a generation)
    variants = {"pallas": dict(method="pallas"), "jacobi": dict(method="jacobi", iters=10, runs=2),
                "xla": dict(method="xla"),
                "pallas lazy5 deferred": dict(method="pallas", eigen_interval=5, defer=True)}
    order = list(variants) + list(variants)[::-1]
    runs = {}
    for tag in order:
        r = bench_cmaes_fleet(B=CMA_B, n=CMA_N, **variants[tag])
        runs.setdefault(tag, []).append(r)
        log(f"[16] {r['name']}: median {r['median_ms']:.3f} ms / {r['generations']} generations, "
            f"min {r['min_ms']:.3f} ms, {r['gens_per_sec']:.6g} instance generations/s, best "
            f"value median {r['best_median']:.3f}")
    for tag, rs in runs.items():
        best = max(rs, key=lambda r: r["gens_per_sec"])
        per_gen = best["median_ms"] / best["generations"]
        note = ""
        if tag == "pallas":
            note = f", K5r {alone['K5r'][0] / per_gen:.1%} of it"
        log(f"[16] fleet {tag}: {best['gens_per_sec']:.6g} instance generations/s, "
            f"{per_gen:.3f} ms a generation of {CMA_B} lanes{note}")
    return alone


# the root finders (phase 17): their labels, methods and keyword arguments
ROOT_CASES = (("bisection", "bisection", {}), ("false_position", "false_position", {}),
              ("false_position_reference", "false_position", {"variant": "reference"}),
              ("brent", "brent", {}), ("ridders", "ridders", {}), ("tiruneh", "tiruneh", {}),
              ("itp", "itp", {}), ("chandrupatla", "chandrupatla", {}))
# in float32 the bench's 1e-6 where a default tolerance lies below what
# float32 resolves near the roots (some 6e-8): Brent and ITP would run to
# max_iter, Chandrupatla to its 1e-300 guard
ROOT_F32_KW = {"brent": {"tol": 1e-6}, "ridders": {"tol": 1e-6, "eps": 1e-6},
               "tiruneh": {"tol": 1e-6}, "itp": {"tol": 1e-6, "eps": 1e-6},
               "chandrupatla": {"eps_m": 1e-6, "eps_a": 1e-6}}
ROOT_B, ROOT_EXTRA, ROOT_CPU, ROOT_BIG = 100000, 1024, 4096, 2_000_000
# card against host on the first ROOT_CPU lanes (PERF.md section 5):
# |x_card - x_cpu| on every lane within twice the distance from the root at
# which the finder may stop at these tolerances, |f'| >= 1 at every root
# here: the f-tolerance (bisection, false position, Brent, Ridders' eps), the
# interval tolerance (Brent, Ridders: its new point within tol of an end),
# Chandrupatla's bracket below 2 (2 eps_m |x| + eps_a); tiruneh returns the
# oldest point of its window (2e-3: the JAX comparison's worst in f32 with
# headroom); ITP is held on the lanes that both converge (a bracket below
# 2 eps, or f(xt) == 0), since on a lane that runs to max_iter its
# reference variant returns the midpoint of a bracket whose far end stalled
# where the last bit of the early trips put it, and those lanes are held
# inside their brackets; the reference variant of false_position loses its
# bracket by design and is held to 1e-6.
ROOT_DX = {
    "float64": {"bisection": 2e-6, "false_position": 2e-6, "false_position_reference": 1e-6,
                "brent": 2e-12, "ridders": 2e-12, "tiruneh": 2e-6, "itp": 5e-12,
                "chandrupatla": 2e-9},
    "float32": {"bisection": 2e-6, "false_position": 2e-6, "false_position_reference": 1e-6,
                "brent": 2e-6, "ridders": 4e-6, "tiruneh": 2e-3, "itp": 5e-6,
                "chandrupatla": 1.2e-5},
}
# The lanes (of ROOT_CPU) whose iterations, calls or converged flag differ
# between card and host, as read on an NVIDIA H100 80GB HBM3 at 700.00 W,
# torch 2.11.0+cu128 (PERF.md section 5): the last bit of cos (and of the
# host's sqrt, log2 and pow) decides a stopping test only where f sits
# within an ulp of it, except ITP's, whose test is f(xt) == 0 exactly; in
# float32 Ridders' step takes a sqrt that the host does not round
# correctly on some inputs.  The limit: twice the reading, at least 8
# lanes, at most 0.3 of them.
ROOT_COUNTS_READ = {
    "float32": {"bisection": 9, "false_position": 1, "ridders": 183, "itp": 498,
                "chandrupatla": 7},
    "float64": {"itp": 831},
}
ROOT_COUNTS_DIFFER = {tag: {label: min(max(2 * read.get(label, 0), 8), ROOT_CPU * 3 // 10)
                            for label, _, _ in ROOT_CASES}
                      for tag, read in ROOT_COUNTS_READ.items()}
PSO_SANN_BS, PSO_SANN_DIM, PSO_SANN_ITERS = (256, 8192), 100, 200   # config #3's fleets


def root_lanes(torch, dev, dtype):
    """The bench problem's ROOT_B lanes, cos(x) - c x on [0, 2], then
    ROOT_EXTRA each of it on [3, 5] (no root), of d - x on [0, 3]
    (decreasing, tests/test_scalar.py's) and of c x - cos(x) on [0, 2]
    (increasing): the coefficients (a, c, d) of a cos(x) - c x + d and the
    brackets, on ``dev``."""
    n, e = ROOT_B, ROOT_EXTRA
    lin = lambda k, lo, hi: torch.linspace(lo, hi, k, dtype=torch.float64)   # noqa: E731
    c = torch.cat([lin(n, 0.1, 1.9), lin(e, 0.1, 1.9), torch.ones(e, dtype=torch.float64),
                   -lin(e, 0.1, 1.9)])
    a = torch.cat([torch.ones(n + e), torch.zeros(e), -torch.ones(e)]).double()
    d = torch.cat([torch.zeros(n + e), lin(e, 0.5, 1.5), torch.zeros(e)]).double()
    lo = torch.cat([torch.zeros(n), torch.full((e,), 3.0), torch.zeros(2 * e)]).double()
    hi = torch.cat([torch.full((n,), 2.0), torch.full((e,), 5.0), torch.full((e,), 3.0),
                    torch.full((e,), 2.0)]).double()
    return [v.to(device=dev, dtype=dtype) for v in (a, c, d, lo, hi)]


def run_root(nt, method, kw, lanes):
    a, c, d, lo, hi = lanes
    fn = lambda x: a * x.cos() - c * x + d   # noqa: E731
    if method == "tiruneh":
        return fn, nt.root(fn, method=method, x_k=(lo, (lo + hi) / 2, hi), **kw)
    return fn, nt.root(fn, lo, hi, method=method, **kw)


def phase_roots(torch, dev):
    """nt.root with every method on the bench problem and the extra lanes,
    in float32 and float64; the card against the host; Brent on 2e6 lanes."""
    import nlsolver_torch as nt

    n, e = ROOT_B, ROOT_EXTRA
    unbracketed = torch.zeros(n + 3 * e, dtype=torch.bool)
    unbracketed[n:n + e] = True
    reset_counts()
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[1]
        lanes = root_lanes(torch, dev, dtype)
        host = [v[:ROOT_CPU].cpu() for v in lanes]
        for label, method, kw in ROOT_CASES:
            kw = {**kw, **(ROOT_F32_KW.get(label, {}) if dtype == torch.float32 else {})}
            t0 = time.perf_counter()
            fn, res = run_root(nt, method, kw, lanes)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            br, x = res.bracketed.cpu(), res.x.cpu()
            check(res.x.is_cuda and res.x.dtype == dtype and tuple(res.x.shape) == (n + 3 * e,),
                  f"root {label} {tag}: x misshapen or off the card")
            if method == "tiruneh":
                check(bool(br.all()) and bool(torch.isfinite(x[:n]).all()),
                      f"root {label} {tag}: a bench lane non-finite")
            else:
                check(torch.equal(~br, unbracketed) and torch.equal(torch.isnan(x), unbracketed),
                      f"root {label} {tag}: bracketed or NaN x off the unbracketed lanes")
                check(bool((res.function_calls.cpu()[unbracketed] == 2).all()),
                      f"root {label} {tag}: an unbracketed lane made more than 2 calls")
            conv = res.converged
            resid = fn(res.x).abs()[conv]
            bound = root_residual_bound(label, kw)
            worst = float(resid.max()) if bool(conv.any()) else 0.0
            check(worst <= bound, f"root {label} {tag}: a converged lane's |f(x)| {worst:.3e} "
                                  f"above {bound:.1e}")
            _, ref = run_root(nt, method, kw, host)
            same = ((res.iterations[:ROOT_CPU].cpu() == ref.iterations)
                    & (res.function_calls[:ROOT_CPU].cpu() == ref.function_calls)
                    & (res.converged[:ROOT_CPU].cpu() == ref.converged))
            dx = (x[:ROOT_CPU] - ref.x).abs()
            dx_same = float(dx[same].max()) if bool(same.any()) else 0.0
            held = torch.ones_like(same)
            if label == "itp":
                held = res.converged[:ROOT_CPU].cpu() & ref.converged
                lo, hi = host[3], host[4]
                inside = all(bool(((v >= lo) & (v <= hi))[~unbracketed[:ROOT_CPU]].all())
                             for v in (x[:ROOT_CPU], ref.x))
                check(inside, f"root itp {tag}: an x outside its bracket")
            dx_held = float(dx[held].max())
            differ = int((~same).sum())
            limit = ROOT_COUNTS_DIFFER[tag][label]
            log(f"[17] root {label} {tag}: {wall * 1e3:.1f} ms for {n + 3 * e} lanes, iterations "
                f"max {int(res.iterations.max())}, converged {float(conv.float().mean()):.4f}, "
                f"worst |f(x)| of a converged lane {worst:.3e} (limit {bound:.1e}); against the "
                f"host on {ROOT_CPU} lanes: counters differ on {differ} (limit {limit}), "
                f"|dx| max {float(dx.max()):.3e}, {dx_held:.3e} on the lanes held (limit "
                f"{ROOT_DX[tag][label]:.1e}), {dx_same:.3e} where the counters agree")
            check(torch.equal(br[:ROOT_CPU], ref.bracketed), f"root {label} {tag}: bracketed "
                                                             f"differs from the host's")
            check(differ <= limit and dx_held <= ROOT_DX[tag][label],
                  f"root {label} {tag}: the card and the host differ past the limits")
    # a run on 2e6 lanes of the bench problem completes
    c = torch.linspace(0.1, 1.9, ROOT_BIG, device=dev)
    t0 = time.perf_counter()
    res = nt.root(lambda x: x.cos() - c * x, torch.zeros(ROOT_BIG, device=dev), 2.0,
                  method="brent", tol=1e-6)
    torch.cuda.synchronize()
    conv = float(res.converged.float().mean())
    log(f"[17] root brent float32 on {ROOT_BIG} lanes: {time.perf_counter() - t0:.3f} s, "
        f"iterations max {int(res.iterations.max())}, converged {conv:.6f}")
    check(bool(res.bracketed.all()) and bool(torch.isfinite(res.x).all()) and conv > 0.99,
          "root brent on 2e6 lanes: a lane unbracketed, non-finite or short of converged")
    check(not launched(), f"the root finders launched kernels: {launched()}")


def root_residual_bound(label, kw):
    """The |f(x)| a converged lane may have: the f-tolerance of its
    finder's converged test; ITP's lanes that converge on a bracket below
    2 eps, 2 eps times the steepest slope of the lanes (2.9), rounded up."""
    eps = {"bisection": kw.get("eps", 1e-6), "false_position": kw.get("eps", 1e-6),
           "false_position_reference": kw.get("eps", 1e-6), "brent": kw.get("tol", 1e-12),
           "ridders": kw.get("eps", 1e-12), "tiruneh": kw.get("tol", 1e-12),
           "itp": 6 * kw.get("eps", 1e-12), "chandrupatla": kw.get("eps_a", 2e-10)}
    return eps[label]


def phase_root_timing(torch, dev):
    from nlsolver_torch.benches import bench_rootfinder_batch, profile_rootfinder_batch

    r = bench_rootfinder_batch()
    for m in ("brent", "itp"):
        log(f"[18] bench_rootfinder_batch {m}: {r[f'{m}_roots_per_sec']:.6g} roots/s "
            f"(median {r[f'{m}_median_ms']:.3f} ms, min {r[f'{m}_min_ms']:.3f}) on "
            f"{r['instances']} lanes, {r[f'{m}_trips']} trips, {r[f'{m}_host_ms_per_trip']:.4f} ms "
            f"a trip, iterations max {r[f'{m}_iterations_max']}, converged "
            f"{r[f'{m}_converged_share']:.4f}, worst |f(x)| converged "
            f"{r[f'{m}_max_residual_converged']:.3e}")
        check(r[f"{m}_converged_share"] > 0.8 and r[f"{m}_max_residual_converged"] < 1e-5,
              f"bench_rootfinder_batch {m}: short of converged")
    # one run traced: Brent's (ITP's 204 trips trace for seconds and tell the same)
    p = profile_rootfinder_batch(method="brent")
    log(f"[18] profile brent: wall {p['wall_ms']:.3f} ms / device busy {p['device_busy_ms']:.3f} "
        f"ms ({p['busy_share']:.1%}), {p['trips']} trips: {p['wall_ms_per_trip']:.4f} ms of "
        f"wall and {p['device_busy_ms_per_trip']:.4f} of device a trip, "
        f"{p['launches_per_trip']:.1f} launches a trip; top {p['top_kernels'][:3]}")
    return r


def pso_state_close(torch, a, b, rtol, atol):
    """How close two fleet states are: the largest |a - b| / (atol + rtol
    |b|) over the floating fields (at most 1 where they agree), and whether
    the counters and flags are equal."""
    worst, ok = 0.0, True
    for f, u in a._asdict().items():
        v = getattr(b, f).to(u.device)
        if u.is_floating_point():
            worst = max(worst, float(((u - v).abs() / (atol + rtol * v.abs())).max()))
        else:
            ok &= torch.equal(u, v)
    return worst, ok


def phase_pso_sann_slice(torch, dev):
    import numpy as np

    import nlsolver_torch as nt
    from nlsolver_torch.solvers import pso_batched as psb
    from nlsolver_torch.solvers import sann_batched as snb

    reset_counts()
    sphere, rastrigin = nt.PROBLEMS["sphere"].fn, nt.PROBLEMS["rastrigin"].fn
    # (a) small fleets until every lane halts
    x0 = torch.full((1024, 4), 0.5, device=dev)
    t0 = time.perf_counter()
    res = nt.minimize(sphere, x0, method="pso", layout="batched",
                      config=nt.PSOConfig(n_particles=16))
    wall = time.perf_counter() - t0
    log(f"[19] minimize(sphere, x0[1024, 4], method='pso', layout='batched'): {wall:.3f} s, "
        f"iterations median {float(res.iterations.float().median()):.0f} max "
        f"{int(res.iterations.max())}, converged {float(res.converged.float().mean()):.4f}, "
        f"f median {float(res.f_value.median()):.3e} max {float(res.f_value.max()):.3e}")
    check(res.x.is_cuda and bool(res.converged.all()) and float(res.f_value.median()) < 1e-6
          and float(res.f_value.max()) < 0.05, "PSO small fleet: unconverged or short of 0")
    res = nt.minimize(sphere, x0, method="sann", layout="batched", config=nt.SANNConfig(max_iter=100))
    log(f"[19] minimize(sphere, x0[1024, 4], method='sann', layout='batched', max_iter=100): "
        f"f median {float(res.f_value.median()):.4f} from 1.0")
    check(bool((res.iterations == 100).all()) and bool(res.converged.all())
          and bool((res.function_calls == 1 + 100 * 9).all()) and float(res.f_value.median()) < 0.5,
          "SANN small fleet: counters off or no descent")
    # (b) the 100-D fleets of config #3 through minimize
    pcfg = nt.PSOConfig(n_particles=32, max_iter=PSO_SANN_ITERS, best_value_no_change=1 << 30,
                        eps=0.0)
    scfg = nt.SANNConfig(max_iter=PSO_SANN_ITERS)
    start = 20.25 * PSO_SANN_DIM   # Rastrigin at -0.5 in every coordinate
    for B in PSO_SANN_BS:
        x0 = torch.full((B, PSO_SANN_DIM), -0.5, device=dev)
        for method, cfg in (("pso", pcfg), ("sann", scfg)):
            t0 = time.perf_counter()
            res = nt.minimize(rastrigin, x0, method=method, layout="batched", config=cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"[19] minimize(rastrigin, x0[{B}, {PSO_SANN_DIM}], method={method!r}, "
                f"layout='batched'), {PSO_SANN_ITERS} iterations: {wall:.3f} s, best value median "
                f"{float(res.f_value.median()):.2f} max {float(res.f_value.max()):.2f} from {start}")
            check(tuple(res.x.shape) == (B, PSO_SANN_DIM) and bool(torch.isfinite(res.x).all())
                  and bool((res.iterations == PSO_SANN_ITERS).all())
                  and float(res.f_value.max()) < start, f"{method} [{B}, 100]: no descent")
    # (c) a bounded PSO fleet stays in its box, at its corner nearest the minimum
    res = nt.minimize(lambda x: sphere(x - 2.0), torch.full((1024, 8), 0.5, device=dev),
                      method="pso", layout="batched", config=nt.PSOConfig(n_particles=16),
                      bounds=nt.Bounds(-1.0, 0.5))
    log(f"[19] bounded PSO [1024, 8] in [-1, 0.5]: x in [{float(res.x.min()):.4f}, "
        f"{float(res.x.max()):.4f}], f median {float(res.f_value.median()):.6f} (corner 18)")
    check(float(res.x.min()) >= -1.0 and float(res.x.max()) <= 0.5
          and abs(float(res.f_value.median()) - 18.0) < 1e-3, "bounded PSO left its box or corner")
    # (d) numpy start points land on the card
    for method, cfg in (("pso", nt.PSOConfig(max_iter=50)), ("sann", nt.SANNConfig(max_iter=5))):
        res = nt.minimize(sphere, np.full((64, 4), 0.5, np.float32), method=method,
                          layout="batched", config=cfg)
        check(res.x.is_cuda and res.f_value.is_cuda, f"numpy x0: {method} not on the card")
    # (e) the card against the host for 5 steps on the same injected draws, f64
    B, n, P = 256, PSO_SANN_DIM, 32
    g = torch.Generator().manual_seed(5)
    x0 = torch.rand((B, n), generator=g, dtype=torch.float64) + 0.5
    for mode in ("vanilla", "accelerated", "clamped"):
        cfg = nt.PSOConfig(n_particles=P, accelerated=mode == "accelerated", max_iter=4,
                           best_value_no_change=1 << 30, eps=0.0)
        lo, hi = (torch.full((n, B), -1.0, dtype=torch.float64),
                  torch.full((n, B), 1.2, dtype=torch.float64)) if mode == "clamped" \
            else psb._derived_bounds(x0.T)
        init = psb.PSOInitDraws(*(torch.rand((n, P, B), generator=g, dtype=torch.float64)
                                  for _ in range(2)))
        steps = [psb.PSODraws(torch.randn((n, P, B), generator=g, dtype=torch.float64))
                 if cfg.accelerated else
                 psb.PSODraws(*(torch.rand((n, P, B), generator=g, dtype=torch.float64)
                                for _ in range(2))) for _ in range(5)]
        states = []
        for where in ("cpu", dev):
            to = lambda t: t if t is None else t.to(where)   # noqa: E731
            s = psb.init(rastrigin, x0.to(where), cfg, lo.to(where), hi.to(where),
                         draws=psb.PSOInitDraws(*map(to, init)))
            for d in steps:
                s = psb.step(rastrigin, s, cfg, lo.to(where), hi.to(where), mode == "clamped",
                             draws=psb.PSODraws(*map(to, d)))
            states.append(s)
        worst, ok = pso_state_close(torch, states[1], states[0], 1e-10, 1e-12)
        log(f"[19] PSO {mode} [{n}, {P}, {B}] f64, 5 steps, card against host on the same "
            f"draws: largest |card - host| / (1e-12 + 1e-10 |host|) {worst:.3e} (limit 1), "
            f"counters equal {ok}")
        check(worst <= 1 and ok and bool(states[1].done.all()),
              f"PSO {mode}: the card and the host differ")
    for vs_best in (False, True):
        cfg = nt.SANNConfig(max_iter=4, metropolis_vs_best=vs_best)
        steps = [snb.SANNDraws(torch.randn((9, n, B), generator=g, dtype=torch.float64),
                               torch.rand((9, B), generator=g, dtype=torch.float64))
                 for _ in range(5)]
        states = []
        for where in ("cpu", dev):
            s = snb.init(rastrigin, x0.to(where), cfg)
            for d in steps:
                s = snb.step(rastrigin, s, cfg, draws=snb.SANNDraws(d.noise.to(where),
                                                                    d.u.to(where)))
            states.append(s)
        worst, ok = pso_state_close(torch, states[1], states[0], 1e-10, 1e-12)
        log(f"[19] SANN metropolis_vs_best={vs_best} [{n}, {B}] f64, 5 steps, card against "
            f"host: largest |card - host| / (1e-12 + 1e-10 |host|) {worst:.3e} (limit 1), "
            f"counters equal {ok}")
        check(worst <= 1 and ok, f"SANN vs_best={vs_best}: the card and the host differ")
    check(not launched(), f"the PSO and SANN fleets launched kernels: {launched()}")


def phase_pso_sann_timing(torch, dev):
    from nlsolver_torch.benches import bench_pso_sann_100d, profile_pso_sann_100d

    out = {}
    for B in PSO_SANN_BS:
        r = bench_pso_sann_100d(B=B, dim=PSO_SANN_DIM, iters=PSO_SANN_ITERS)
        # traced over 20 iterations: the tracer takes seconds over the 44000
        # launches of a 200-iteration SANN run, and an iteration's figures are the same
        prof = profile_pso_sann_100d(B=B, dim=PSO_SANN_DIM, iters=20)
        for name in ("pso_rastrigin", "pso_ackley", "sann_rastrigin"):
            rate = r[f"{name}_{PSO_SANN_DIM}d_iters_per_sec"]
            p = prof[name]
            log(f"[20] bench_pso_sann_100d B={B} {name}: {rate:.6g} instance iterations/s "
                f"(median {r[f'{name}_median_ms']:.3f} ms for {PSO_SANN_ITERS} iterations, min "
                f"{r[f'{name}_min_ms']:.3f}), best value median {r[f'{name}_best_median']:.3f}; "
                f"profile of 20 iterations: wall {p['wall_ms_per_iteration']:.4f} ms / device busy "
                f"{p['device_busy_ms_per_iteration']:.4f} ms an iteration ({p['busy_share']:.1%}), "
                f"{p['launches_per_iteration']:.1f} launches an iteration; top {p['top_kernels'][:3]}")
            check(rate > 0 and r[f"{name}_best_median"] < 20.25 * PSO_SANN_DIM,
                  f"bench_pso_sann_100d {name} B={B}: no descent")
            out[(B, name)] = rate
    return out


# the single-instance solvers on lane tensors (phase 21): config #4a's
# batch, lanes of it held against the host, and lanes for the other methods
BATCH_B = 10000
BATCH_CPU = 2048
LANE_B = 1024
LANE_CPU = 256
WIDE_CPU = 4      # the single-instance BFGS's wide arm: lanes held against the host
# card against host on the same lanes, f32: |x_card - x_host| within
# 2e-3 (the stopping rules leave x within some 5e-3 of the minimum, and a
# last-bit difference moves where inside that a lane stops), and the share
# of lanes whose iterations, calls or converged flag differ at most
# LANES_DIFFER
LANE_DX = 2e-3
# in float64, a few ulps grown over the run
LANE_DX64 = 1e-8
LANES_DIFFER = 0.05


def lane_methods(nt):
    """(method, config, bounds) of phase 21's other methods on bowls."""
    return (("lbfgs", nt.LBFGSConfig(max_iter=100, grad_eps=1e-4), None),
            ("lbfgsb", nt.LBFGSBConfig(max_iter=100, pg_eps=1e-4), nt.Bounds(-0.5, 0.5)),
            ("gd", nt.GDConfig(alpha=0.1, max_iter=300, grad_eps=1e-3), None),
            ("cgd", nt.CGDConfig(), None),
            ("lm", nt.LMConfig(), None),
            # a bracket of 5 reaches every center in the first sweep of a
            # separable bowl, and the next sweeps find no more progress
            ("coordinate", nt.CoordinateDescentConfig(bracket=5.0), None))


def card_against_host(torch, label, res, ref, lanes):
    """|x| and |f| of the card's first ``lanes`` lanes against the host's
    run of them, and the share of those lanes whose counters differ.
    Coordinate descent's function calls count the trips of its Brent
    searches, whose stopping tests compare values of f that agree to an
    ulp: they are reported, not held."""
    dx = float((res.x[:lanes].cpu() - ref.x).abs().max())
    df = float((res.f_value[:lanes].cpu() - ref.f_value).abs().max())
    same = torch.ones(lanes, dtype=torch.bool)
    for f in ("iterations", "function_calls", "gradient_calls", "hessian_calls", "converged"):
        if f == "function_calls" and label.startswith("coordinate"):
            calls = float((res.function_calls[:lanes].cpu() != ref.function_calls).float().mean())
            log(f"[21] {label}: lanes whose function calls differ {calls:.4f}")
            continue
        same &= getattr(res, f)[:lanes].cpu() == getattr(ref, f)
    share = 1.0 - float(same.float().mean())
    limit = LANE_DX if res.x.dtype == torch.float32 else LANE_DX64
    log(f"[21] {label}, card against host on {lanes} lanes: max |dx| {dx:.3e} (limit {limit}), "
        f"max |df| {df:.3e}, lanes whose counters differ {share:.4f} (limit {LANES_DIFFER})")
    check(dx <= limit and share <= LANES_DIFFER, f"{label}: the card and the host differ")


def rosen_point(x):
    """Rosenbrock written on one point, as JAX users write it."""
    return 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2


def phase_lane_solvers(torch, dev):
    """The single-instance solvers on lane tensors through nt.minimize:
    config #4a's batch through BFGS with K4c counted, the other methods on
    bowls, Brent on a batch of 1-D functions, every one against the host;
    the F2 repair on the SANN, PSO and plain DE routes."""
    import nlsolver_torch as nt
    from nlsolver_torch.benches import bowls_lanes
    from nlsolver_torch.ops import rank2 as tr

    # (a) config #4a: 10000 16-D bowls through BFGS, f32, max_iter=30
    fn, data = bowls_lanes(BATCH_B, BFGS_N, device=dev)
    x0 = torch.zeros(BATCH_B, BFGS_N, device=dev)
    cfg = nt.BFGSConfig(max_iter=30)
    reset_counts()
    t0 = time.perf_counter()
    res = nt.minimize(fn, x0, method="bfgs", layout="batched", config=cfg, data=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launched()
    steps = int(res.iterations.max()) + 1
    solved = float((res.f_value < 1e-4).float().mean())
    log(f"[21] minimize(bowls, x0[{BATCH_B}, {BFGS_N}], method='bfgs', layout='batched'): "
        f"{wall:.3f} s, host steps {steps}, launches {counts}, iterations median "
        f"{float(res.iterations.float().median()):.0f} max {int(res.iterations.max())}, converged "
        f"{float(res.converged.float().mean()):.6f}, solved {solved:.6f} (limit 0.999)")
    check(res.x.is_cuda and tuple(res.x.shape) == (BATCH_B, BFGS_N)
          and bool(torch.isfinite(res.f_value).all()), "bfgs batch: x misshapen or off the card")
    check(counts == {"rank2_update_batched_kernel": steps, "rank2_update_batched_rows": steps},
          f"bfgs batch: expected K4c (K4c-r) once per host step ({steps}), launched {counts}")
    check(solved >= 0.999, f"bfgs batch: solved share {solved} below 0.999")
    host = tuple(d[:BATCH_CPU].cpu() for d in data)
    ref = nt.minimize(fn, x0[:BATCH_CPU].cpu(), method="bfgs", layout="batched", config=cfg,
                      data=host)
    card_against_host(torch, "bfgs batch", res, ref, BATCH_CPU)
    launches = {"K4c-r": tr.rank2_update_batched_rows.launches}

    # (a') the wide arm: K4CG_B bowls of K4CG_N dimensions, where K4c-g
    # takes the update; WIDE_CPU lanes against the host, |x_card - x_host|
    # within LANE_DX (the stopping rules and float32's last bit, as above)
    wfn, wdata = bowls_lanes(K4CG_B, K4CG_N, seed=4, device=dev)
    wx0 = torch.zeros(K4CG_B, K4CG_N, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    res = nt.minimize(wfn, wx0, method="bfgs", layout="batched", config=cfg, data=wdata)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launched()
    steps = int(res.iterations.max()) + 1
    solved = float((res.f_value < 1e-4).float().mean())
    off = float((res.x - wdata[0]).abs().max())
    log(f"[21] minimize(bowls, x0[{K4CG_B}, {K4CG_N}], method='bfgs', layout='batched'): "
        f"{wall:.3f} s, host steps {steps}, launches {counts}, iterations median "
        f"{float(res.iterations.float().median()):.0f} max {int(res.iterations.max())}, converged "
        f"{float(res.converged.float().mean()):.6f}, solved {solved:.6f}, max |x - center| "
        f"{off:.3e} (limit 1e-2)")
    check(res.x.is_cuda and bool(torch.isfinite(res.f_value).all()) and off < 1e-2,
          "bfgs wide arm: x off the card, non-finite or off its centers")
    check(counts == {"rank2_update_batched_kernel": steps, "rank2_update_batched_global": steps},
          f"bfgs wide arm: expected K4c (K4c-g) once per host step ({steps}), launched {counts}")
    ref = nt.minimize(wfn, wx0[:WIDE_CPU].cpu(), method="bfgs", layout="batched", config=cfg,
                      data=tuple(d[:WIDE_CPU].cpu() for d in wdata))
    dx = float((res.x[:WIDE_CPU].cpu() - ref.x).abs().max())
    same = all(bool((getattr(res, f)[:WIDE_CPU].cpu() == getattr(ref, f)).all())
               for f in ("iterations", "function_calls", "gradient_calls", "converged"))
    log(f"[21] bfgs wide arm, card against host on {WIDE_CPU} lanes: max |dx| {dx:.3e} (limit "
        f"{LANE_DX}), counters equal {same}")
    check(dx <= LANE_DX, "bfgs wide arm: the card and the host differ")
    launches["K4c-g"] = tr.rank2_update_batched_global.launches

    # (b) the other methods on LANE_B of the bowls, each to its minimum
    # (the bowls are separable: the bounded minimum is the clipped center);
    # then LANE_CPU lanes in float64 on the card against the host, where
    # the stopping rules do not sit at float32's last bit (L-BFGS-B's factr
    # test is one float32 ulp of f)
    centers = data[0][:LANE_B]
    sub = tuple(d[:LANE_B] for d in data)
    sub64 = tuple(d[:LANE_CPU].double() for d in data)
    for method, mcfg, bounds in lane_methods(nt):
        reset_counts()
        t0 = time.perf_counter()
        res = nt.minimize(fn, x0[:LANE_B], method=method, layout="batched", config=mcfg,
                          bounds=bounds, data=sub)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = centers if bounds is None else centers.clamp(-0.5, 0.5)
        off = float((res.x - want).abs().max())
        log(f"[21] {method} [{LANE_B}, {BFGS_N}] f32: {wall:.3f} s, iterations max "
            f"{int(res.iterations.max())}, converged {float(res.converged.float().mean()):.4f}, "
            f"max |x - minimum| {off:.3e} (limit 1e-2), launches {launched()}")
        check(off < 1e-2 and not launched(), f"{method}: off its minimum, or a kernel launched")
        x64 = x0[:LANE_CPU].double()
        res = nt.minimize(fn, x64, method=method, layout="batched", config=mcfg, bounds=bounds,
                          data=sub64)
        ref = nt.minimize(fn, x64.cpu(), method=method, layout="batched", config=mcfg,
                          bounds=bounds, data=tuple(d.cpu() for d in sub64))
        card_against_host(torch, f"{method} f64", res, ref, LANE_CPU)
    # Brent on a batch of 1-D bowls s (t - c)^2
    c, s = centers[:, 0].contiguous(), data[1][:LANE_B, 0].contiguous()
    bcfg = nt.BrentConfig(tol=1e-6, eps=1e-6)  # what float32 resolves near the minima
    res = nt.minimize(lambda t: s * (t - c) ** 2, x0[:LANE_B, :1], method="brent",
                      layout="batched", config=bcfg)
    off = float((res.x - c).abs().max())
    log(f"[21] brent on {LANE_B} 1-D bowls: max |x - c| {off:.3e} (limit 1e-3), iterations max "
        f"{int(res.iterations.max())}")
    check(off < 1e-3, "brent: a lane off its minimum")
    cc, sc = c[:LANE_CPU].double(), s[:LANE_CPU].double()
    res = nt.minimize(lambda t: sc * (t - cc) ** 2, x0[:LANE_CPU, :1].double(), method="brent",
                      layout="batched")
    cc, sc = cc.cpu(), sc.cpu()
    ref = nt.minimize(lambda t: sc * (t - cc) ** 2, x0[:LANE_CPU, :1].double().cpu(),
                      method="brent", layout="batched")
    card_against_host(torch, "brent f64", res, ref, LANE_CPU)

    # (c) F2: a single-point objective at B = n = 2 on the three batched
    # engines that score through vmap, each lane's f_value held to the
    # objective at its returned x
    x2 = torch.tensor([[-1.2, 1.0], [0.5, -0.5]], device=dev)
    for method, fcfg in (("sann", nt.SANNConfig(max_iter=50)),
                         ("pso", nt.PSOConfig(max_iter=50)),
                         ("de", nt.DEConfig(max_iter=50))):
        res = nt.minimize(rosen_point, x2, method=method, layout="batched", config=fcfg)
        true = torch.stack([rosen_point(res.x[b]) for b in range(2)])
        err = float(((res.f_value - true).abs() / true.abs().clamp(min=1e-6)).max())
        log(f"[21] F2 {method} at B = n = 2: f_value {res.f_value.tolist()}, f(x) {true.tolist()}, "
            f"largest relative difference {err:.3e} (limit 1e-5)")
        check(err <= 1e-5, f"F2 {method}: f_value is not the objective at x")
    return launches


def phase_lane_solvers_timing(torch, dev):
    """bench_bfgs_batch beside bench_bfgs_fleet on the same 10000 bowls,
    and its wide arm (K4CG_B bowls of K4CG_N dimensions, K4c-g)."""
    from nlsolver_torch.benches import bench_bfgs_batch, bench_bfgs_fleet, profile_bfgs_batch

    r = bench_bfgs_batch(B=BATCH_B, dim=BFGS_N, runs=5, warmup=2)
    log(f"[22] {r['name']}: median {r['median_ms']:.3f} ms / {r['host_steps']} host steps, min "
        f"{r['min_ms']:.3f} ms, {r['iters_per_sec']:.6g} instance iterations/s, solved "
        f"{r['solved_frac']:.6f}, converged {r['converged_frac']:.6f}, K4c launches a run "
        f"{r['k4c_launches']} ({r['k4c_form']}: {r['k4c_form_launches']})")
    check(r["k4c_launches"] == r["host_steps"] == r["k4c_form_launches"]
          and r["k4c_form"] == "rows" and r["solved_frac"] >= 0.999,
          "bench_bfgs_batch: K4c-r not once a host step, or short of solved")
    f = bench_bfgs_fleet(B=BATCH_B, dim=BFGS_N, runs=3)
    log(f"[22] {f['name']} on the same {BATCH_B} bowls: median {f['median_ms']:.3f} ms / "
        f"{f['host_steps']} host steps, {f['iters_per_sec']:.6g} instance iterations/s; the "
        f"batch runs at {r['iters_per_sec'] / f['iters_per_sec']:.3f} of the fleet's rate")
    p = profile_bfgs_batch(B=BATCH_B, dim=BFGS_N)
    log(f"[22] profile_bfgs_batch: wall {p['wall_ms']:.3f} ms, device busy "
        f"{p['device_busy_ms']:.3f} ms ({p['busy_share']:.1%}), {p['launches_per_step']:.1f} "
        f"launches a host step over {p['host_steps']}; top {p['top_kernels'][:4]}")
    w = bench_bfgs_batch(B=K4CG_B, dim=K4CG_N, runs=3, warmup=1)
    log(f"[22] {w['name']} wide arm [{K4CG_B}, {K4CG_N}]: median {w['median_ms']:.3f} ms / "
        f"{w['host_steps']} host steps, {w['iters_per_sec']:.6g} instance iterations/s, solved "
        f"{w['solved_frac']:.6f}, K4c launches a run {w['k4c_launches']} ({w['k4c_form']}: "
        f"{w['k4c_form_launches']})")
    check(w["k4c_launches"] == w["host_steps"] == w["k4c_form_launches"]
          and w["k4c_form"] == "global", "bench_bfgs_batch's wide arm: K4c-g not once a host step")
    return {"bench": r, "fleet": f, "wide": w}


# the derivative-free single-instance solvers on lane tensors (phase 23):
# FREE_B lanes of n = FREE_N, bowls, Rosenbrock and Rastrigin in turn, in
# float32 and float64, the same draws on the card and the host
FREE_B, FREE_N, FREE_SEED = 384, 4, 23
FREE_KINDS = ("bowls", "Rosenbrock", "Rastrigin")   # lane b is of kind b % 3
# Card against host, by route and kind of problem, read on an NVIDIA H100
# 80GB HBM3 at 700.00 W, torch 2.11.0+cu128 (PERF.md section 5): the lanes
# whose iterations, calls or converged flag differ, and |x_card - x_host|
# relative to max(|x|, 1), the largest where the counters agree and where
# they differ.  In float64 no lane differs and x agrees to a few ulps grown
# over a run (0 read but 2.3e-15, the accelerated PSO's pow).  In float32
# the card's cos rounds another way than the host's on Rastrigin, which
# moves where a lane stops, the spread test's mean is summed in another
# order (NM-PSO's Rosenbrock lane), and SANN's chains end a few ulps apart
# on every kind.  Unlisted: 0 lanes, 0 dx.
FREE_READ32 = {
    # (route, kind): (lanes that differ, dx where they agree, dx where they differ)
    ("nelder_mead", "Rastrigin"): (71, 2.103e-5, 2.062e-4),
    ("pso", "Rastrigin"): (0, 4.152e-3, 0.0),
    ("pso accelerated boxed", "Rastrigin"): (0, 2.078e-4, 0.0),
    ("sann", "bowls"): (0, 1.907e-6, 0.0),
    ("sann", "Rosenbrock"): (0, 4.470e-7, 0.0),
    ("sann", "Rastrigin"): (0, 9.984e-7, 0.0),
    ("nmpso", "Rosenbrock"): (1, 0.0, 1.024e-4),
    ("nmpso", "Rastrigin"): (74, 5.501e-5, 3.696e-2),
}
FREE_KIND_LANES = FREE_B // len(FREE_KINDS)
FREE_DX64 = 1e-8


def free_limits(label, kind, tag):
    """(lanes that may differ, dx where they agree, dx where they differ)
    of a route and kind: in float32 twice the reading, at most the reading
    plus a tenth of the kind's lanes, and dx at least 1e-6 (some eight
    float32 ulps); in float64 no lane, FREE_DX64."""
    if tag == "float64":
        return 0, FREE_DX64, FREE_DX64
    lanes, dx, dx_differ = FREE_READ32.get((label, kind), (0, 0.0, 0.0))
    return (min(2 * lanes, lanes + FREE_KIND_LANES // 10), max(2 * dx, 1e-6),
            max(2 * dx_differ, 1e-6))


FREE_RESTARTS = 8


def free_lanes(torch, dtype):
    """FREE_B lanes on the host, from FREE_SEED: x0 [B, n] and the data
    (kind, center, weight) of f = a bowl sum(w (x - c)^2) (kind 0),
    Rosenbrock (1) or Rastrigin (2)."""
    g = torch.Generator().manual_seed(FREE_SEED)
    kind = torch.arange(FREE_B) % 3
    width = torch.tensor([2.0, 1.5, 0.6], dtype=torch.float64)[kind]
    x0 = (2.0 * torch.rand((FREE_B, FREE_N), generator=g, dtype=torch.float64) - 1.0) * width[:, None]
    c = torch.randn((FREE_B, FREE_N), generator=g, dtype=torch.float64)
    w = 0.5 + 2.5 * torch.rand((FREE_B, FREE_N), generator=g, dtype=torch.float64)
    return x0.to(dtype), (kind, c.to(dtype), w.to(dtype))


def free_objective(torch):
    """f of one lane, its terms added in index order: a ``.sum()`` would
    add them in another order on the card than on the host in float32,
    where the last bit of f then decides comparisons of the solvers."""
    def added(t):
        acc = t[0]
        for i in range(1, t.shape[-1]):
            acc = acc + t[i]
        return acc

    def fn(x, d):
        k, c, w = d
        bowl = added(w * (x - c) ** 2)
        rosen = added(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
        ras = 10.0 * x.shape[-1] + added(x * x - 10.0 * torch.cos(2.0 * torch.pi * x))
        return torch.where(k == 0, bowl, torch.where(k == 1, rosen, ras))
    return fn


def free_routes(nt):
    """(label, method, config, bounds, x0 scale) of phase 23's routes."""
    return (("nelder_mead", "nelder_mead", nt.NelderMeadConfig(), None, 1.0),
            ("nelder_mead reference", "nelder_mead", nt.NelderMeadConfig(variant="reference"),
             None, 1.0),
            ("de", "de", nt.DEConfig(pop_size=16, max_iter=100), None, 3.0),
            ("pso", "pso", nt.PSOConfig(max_iter=200), None, 1.0),
            ("pso accelerated boxed", "pso", nt.PSOConfig(max_iter=200, accelerated=True),
             nt.Bounds(-2.0, 2.0), 1.0),
            ("sann", "sann", nt.SANNConfig(max_iter=50), None, 1.0),
            ("nmpso", "nmpso", nt.NMPSOConfig(max_iter=200), None, 1.0))


def free_draws(torch, method, cfg, dtype):
    """A run's draws for FREE_B lanes from one seed, on the host: the
    ``_lane.Draws`` each solver's ``minimize_batched`` takes, T steps."""
    from nlsolver_torch.solvers import de, nmpso, pso, sann
    from nlsolver_torch.solvers._lane import Draws

    g = torch.Generator().manual_seed(FREE_SEED + 1)
    B, n = FREE_B, FREE_N
    T = getattr(cfg, "max_iter", 0) + 1

    def u(*shape):
        return torch.rand(shape, generator=g, dtype=dtype)

    if method == "de":
        P = cfg.pop_size
        partners = torch.stack([torch.randint(0, P - 1 - j, (T, B, P), generator=g)
                                for j in range(3)], dim=-1)
        return Draws(u(B, P, n), de.StepDraws(partners, torch.randint(0, n, (T, B, P), generator=g),
                                              u(T, B, P, n)))
    if method == "pso":
        P = cfg.n_particles
        steps = (pso.StepDraws(torch.randn((T, B, P, n), generator=g, dtype=dtype))
                 if cfg.accelerated else pso.StepDraws(u(T, B, P, n), u(T, B, P, n)))
        return Draws(pso.InitDraws(u(B, P, n), u(B, P, n)), steps)
    if method == "sann":
        m = cfg.temperature_iter - 1
        return Draws(None, sann.StepDraws(torch.randn((T, B, m, n), generator=g, dtype=dtype),
                                          u(T, B, m)))
    if method == "nmpso":
        return Draws(nmpso.InitDraws(u(B, 2 * n, n), u(B, 2 * n, n)),
                     nmpso.StepDraws(u(T, B, 2 * n, n), u(T, B, 2 * n, n)))
    return None


def lane_of(draws, b):
    """Lane b's draws, without the lane axis (what ``minimize`` takes)."""
    from nlsolver_torch.solvers._lane import Draws, tree_map

    if draws is None:
        return None
    return Draws(tree_map(draws.init, lambda a: a[b]), tree_map(draws.steps, lambda a: a[:, b]))


def counters_differ(torch, res, ref):
    same = torch.ones(ref.iterations.shape, dtype=torch.bool)
    for f in ("iterations", "function_calls", "converged"):
        same &= getattr(res, f).cpu() == getattr(ref, f)
    return ~same


def phase_free_solvers(torch, dev):
    """The derivative-free single-instance solvers on lane tensors:
    each route batched on FREE_B lanes, card against host on the same
    draws, in float32 and float64, and single on lane 0 against its
    batch's lane; the default method on the README's example; restarts=8
    on Halton starts for nelder_mead and bfgs, K4c counted on bfgs."""
    import importlib

    import nlsolver_torch as nt
    from nlsolver_torch.api import _halton_unit
    from nlsolver_torch.solvers import bfgs
    from nlsolver_torch.solvers._lane import draws_on

    fn = free_objective(torch)
    reset_counts()
    readings, failed = {}, []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[1]
        x0_host, data_host = free_lanes(torch, dtype)
        kind_of = [FREE_KINDS[int(k)] for k in data_host[0]]
        data = tuple(d.to(dev) for d in data_host)
        for label, method, cfg, bounds, scale in free_routes(nt):
            if label == "nelder_mead reference" and dtype == torch.float32:
                continue
            mod = importlib.import_module(f"nlsolver_torch.solvers.{method}")
            draws = free_draws(torch, method, cfg, dtype)
            kw = {} if draws is None else {"draws": draws_on(draws, dev)}
            x0 = (scale * x0_host).to(dev)
            t0 = time.perf_counter()
            if method in ("nelder_mead", "nmpso"):   # their batched route
                res = nt.minimize(fn, x0, method=method, layout="batched", config=cfg,
                                  bounds=bounds, data=data, **kw)
            else:
                res = mod.minimize_batched(fn, x0, cfg, bounds, data=data, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ref = mod.minimize_batched(fn, scale * x0_host, cfg, bounds, data=data_host,
                                       **({} if draws is None else {"draws": draws}))
            differ = counters_differ(torch, res, ref)
            rel = ((res.x.cpu() - ref.x).abs() / ref.x.abs().clamp(min=1.0)).amax(dim=1)
            key = f"{label} {tag}"
            readings[key] = int(differ.sum())
            log(f"[23] {label} [{FREE_B}, {FREE_N}] {tag}: {wall:.3f} s on the card, iterations "
                f"max {int(res.iterations.max())}, converged {float(res.converged.float().mean()):.4f}"
                f", f median {float(res.f_value.median()):.4e}")
            for k, kind in enumerate(FREE_KINDS):
                mine = data_host[0] == k
                agree, apart = rel[mine & ~differ], rel[mine & differ]
                lanes = int(apart.numel())
                dx = float(agree.max()) if agree.numel() else 0.0
                dx_apart = float(apart.max()) if lanes else 0.0
                limits = free_limits(label, kind, tag)
                log(f"[23]   {kind}, card against host: counters differ on {lanes} of "
                    f"{int(mine.sum())} lanes (limit {limits[0]}), max relative |dx| {dx:.3e} "
                    f"where they agree (limit {limits[1]:.1e}), {dx_apart:.3e} where they "
                    f"differ (limit {limits[2]:.1e})")
                if lanes > limits[0] or dx > limits[1] or dx_apart > limits[2]:
                    failed.append(f"{key} {kind}")
            check(res.x.is_cuda and tuple(res.x.shape) == (FREE_B, FREE_N)
                  and bool(torch.isfinite(res.f_value).all()), f"{key}: misshapen or off the card")
            # single: lane 0 alone through minimize(fn, x0[n]), against the
            # batch's lane on the card
            for b in (0,):
                one_kw = {} if draws is None else {"draws": draws_on(lane_of(draws, b), dev)}
                one = nt.minimize(fn, x0[b], method=method, config=cfg, bounds=bounds,
                                  data=tuple(d[b] for d in data), **one_kw)
                ok = all(bool(getattr(one, f) == getattr(res, f)[b])
                         for f in ("iterations", "function_calls", "converged"))
                dxb = float(((one.x - res.x[b]).abs() / res.x[b].abs().clamp(min=1.0)).max())
                check(one.x.shape == (FREE_N,), f"{key}: the single route's x is misshapen")
                if not (ok and dxb <= free_limits(label, kind_of[b], tag)[1]):
                    failed.append(f"{key}: the single route against lane {b} of the batch "
                                  f"({int(one.iterations)} against {int(res.iterations[b])} "
                                  f"iterations, |dx| {dxb:.3e})")
    check(not failed, f"the card and the host differ past the limits on {failed}")
    check(not launched(), f"the derivative-free solvers launched kernels: {launched()}")

    # the README's example through the default method, on the card
    rosen = lambda x: 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2  # noqa: E731
    t0 = time.perf_counter()
    res = nt.minimize(rosen, [-0.5, -0.5])
    wall = time.perf_counter() - t0
    log(f"[23] minimize(rosen, [-0.5, -0.5]): {wall:.3f} s, x {res.x.tolist()}, f "
        f"{float(res.f_value):.3e}, iterations {int(res.iterations)}, calls "
        f"{int(res.function_calls)}, on {res.x.device}")
    check(res.x.is_cuda and float(res.f_value) < 1e-6, "the default method missed Rosenbrock's "
                                                       "minimum or ran off the card")

    # restarts on Halton starts: nelder_mead, and bfgs with K4c counted
    x0 = torch.tensor([-0.5, -0.5], device=dev)
    out = {}
    for method in ("nelder_mead", "bfgs"):
        reset_counts()
        t0 = time.perf_counter()
        res = nt.minimize(rosen, x0, method=method, restarts=FREE_RESTARTS,
                          restart_sampler="halton")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launched()
        ref = nt.minimize(rosen, x0.cpu(), method=method, restarts=FREE_RESTARTS,
                          restart_sampler="halton")
        same = all(bool(getattr(res, f).cpu() == getattr(ref, f))
                   for f in ("iterations", "function_calls", "gradient_calls", "converged"))
        dx = float((res.x.cpu() - ref.x).abs().max())
        log(f"[23] minimize(rosen, x0, method={method!r}, restarts={FREE_RESTARTS}, "
            f"restart_sampler='halton'): {wall:.3f} s, f {float(res.f_value):.3e}, iterations "
            f"summed {int(res.iterations)}, launches {counts}; against the host: counters equal "
            f"{same}, |dx| {dx:.3e}")
        check(float(res.f_value) < 1e-4, f"restarts on {method}: no start reached the minimum")
        if method == "nelder_mead":
            check(not counts, f"restarts on nelder_mead launched kernels: {counts}")
            continue
        # the restart lanes as one minimize_batched: one K4c launch a host step
        starts = x0 + 10.0 * (2.0 * torch.as_tensor(_halton_unit(FREE_RESTARTS, 2), dtype=x0.dtype,
                                                     device=dev) - 1.0)
        starts[0] = x0
        reset_counts()
        lanes = bfgs.minimize_batched(rosen, starts)
        torch.cuda.synchronize()
        steps = int(lanes.iterations.max()) + 1
        k4c = counts.get("rank2_update_batched_kernel", 0)
        log(f"[23] restarts on bfgs: {steps} host steps over the {FREE_RESTARTS} restart lanes, "
            f"K4c launched {k4c} times (one a host step), iterations summed "
            f"{int(lanes.iterations.sum())} = {int(res.iterations)}")
        check(counts == {"rank2_update_batched_kernel": steps, "rank2_update_batched_rows": steps}
              and int(lanes.iterations.sum()) == int(res.iterations),
              f"restarts on bfgs: expected K4c (K4c-r) once per host step ({steps}), launched "
              f"{counts}")
        out["K4c restarts"] = k4c
    log(f"[23] counters differing, card against host, by route: {readings}")
    return out


def phase_free_timing(torch, dev):
    """bench_nm_rosenbrock and bench_latency_single (chains of 4 solves,
    a shorter chain than the benches' default of 64), bench_lm_fleet at
    B = 4096, the row-layout arm of bench_pso_sann_100d at B = 256, each
    the median of 2 runs after 1 warm-up (2 for bench_lm_fleet), and a
    profile of each single solve."""
    from nlsolver_torch.benches import (bench_latency_single, bench_lm_fleet, bench_nm_rosenbrock,
                                        bench_pso_sann_100d, profile_latency_single,
                                        profile_pso_sann_100d)

    r = bench_nm_rosenbrock(runs=2, chain=4, warmup=1)
    log(f"[24] {r['name']}: {r['nm_solve_time_us']:.1f} us a solve (min "
        f"{r['nm_min_solve_time_us']:.1f}), {r['nm_iterations']} iterations from (-0.5, -0.5), "
        f"{r['nm_iters_per_sec']:.6g} iterations/s over a chain of {r['chain']} "
        f"({r['nm_chain_iterations']} iterations), f {r['nm_f_value']:.3e}")
    check(r["nm_f_value"] < 1e-6, "bench_nm_rosenbrock: missed the minimum")
    lat = bench_latency_single(runs=2, chain=4, warmup=1)
    prof = profile_latency_single()
    for tag in ("nm", "de", "bfgs"):
        p = prof[tag]
        log(f"[24] {lat['name']} {tag}: {lat[f'{tag}_solve_time_us']:.1f} us a solve, "
            f"{lat[f'{tag}_us_per_iteration']:.1f} us an iteration ({lat[f'{tag}_iterations']} "
            f"iterations from (-0.5, -0.5), f {lat[f'{tag}_f_value']:.3e}); profile of one solve: "
            f"wall {p['wall_ms_per_step']:.3f} ms / {p['launches_per_step']:.1f} launches a host "
            f"step, device busy {p['device_busy_ms']:.3f} of {p['wall_ms']:.3f} ms "
            f"({p['busy_share']:.1%}); top {p['top_kernels'][:2]}")
    lm = bench_lm_fleet(B=4096, runs=2)
    log(f"[24] {lm['name']} B={lm['instances']}: fit_fleet ({lm['engine']}) "
        f"{lm['fits_per_sec']:.6g} fits/s (median {lm['median_ms']:.3f} ms), fit_batched "
        f"{lm['vmapped_scalar_fits_per_sec']:.6g} fits/s (median "
        f"{lm['vmapped_scalar_median_ms']:.3f} ms), fleet {lm['fleet_speedup_vs_vmapped']:.2f}x; "
        f"solved {lm['solved_frac']:.4f} / {lm['vmapped_scalar_solved_frac']:.4f}")
    check(lm["solved_frac"] >= 0.99 and lm["vmapped_scalar_solved_frac"] >= 0.99,
          "bench_lm_fleet: short of solved")
    row = bench_pso_sann_100d(B=PSO_SANN_BS[0], dim=PSO_SANN_DIM, iters=PSO_SANN_ITERS, runs=2,
                              fast=False, warmup=1)
    rprof = profile_pso_sann_100d(B=PSO_SANN_BS[0], dim=PSO_SANN_DIM, iters=20, fast=False)
    for name in ("pso_rastrigin", "pso_ackley", "sann_rastrigin"):
        rate = row[f"{name}_{PSO_SANN_DIM}d_iters_per_sec"]
        p = rprof[name]
        log(f"[24] bench_pso_sann_100d(fast=False) B={PSO_SANN_BS[0]} {name}: {rate:.6g} instance "
            f"iterations/s (median {row[f'{name}_median_ms']:.3f} ms for {PSO_SANN_ITERS} "
            f"iterations), best value median {row[f'{name}_best_median']:.3f}; profile of 20 "
            f"iterations: wall {p['wall_ms_per_iteration']:.4f} ms / device busy "
            f"{p['device_busy_ms_per_iteration']:.4f} ms an iteration ({p['busy_share']:.1%}), "
            f"{p['launches_per_iteration']:.1f} launches an iteration")
        check(rate > 0 and row[f"{name}_best_median"] < 20.25 * PSO_SANN_DIM,
              f"row {name}: no descent")


# the CMA-ES on lane tensors (phase 25): the card against the host on LANE_CMA
# lanes of three kinds, n = 4, pop_size 8 (mu = 4 >= n), LANE_CMA_GENS generations
LANE_CMA, LANE_CMA_N, LANE_CMA_POP, LANE_CMA_GENS = 256, 4, 8, 30
LANE_CMA_RTOL = 1e-10


def cma_bench_config(method):
    """The fleet bench's scenario for the lane CMA-ES: lam = 12, 50
    generations, every other termination rule and the kick off."""
    from nlsolver_torch.solvers.cmaes import CMAESConfig

    return CMAESConfig(pop_size=12, max_iter=CMA_GENS, best_value_no_change=1 << 30, f_tol=0.0,
                       kick_tol=0.0, cond_max=float("inf"), eigh_method=method)


def cma_lanes_close(torch, got, want, rtol):
    """Counters equal and floats within ``rtol`` of the host's (scaled by
    each field's largest entry); returns the worst relative difference."""
    worst = 0.0
    for f in ("iterations", "function_calls", "gradient_calls", "hessian_calls", "converged"):
        check(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
              f"the lane CMA-ES: {f} differs between the card and the host")
    for f in ("x", "f_value"):
        a, b = getattr(got, f).cpu(), getattr(want, f)
        scale = float(b.abs().max())
        err = float((a - b).abs().max()) / max(scale, 1e-300)
        worst = max(worst, err)
        check(err <= rtol, f"the lane CMA-ES: {f} off the host's by {err:.3e} (rtol {rtol})")
    return worst


def phase_cmaes_lanes(torch, dev):
    """The CMA-ES on lane tensors: the bench scenario through minimize and
    timed a generation; 256 float64 lanes against the host; restarts=8 as
    one batch."""
    import nlsolver_torch as nt
    from nlsolver_torch.core import Bounds
    from nlsolver_torch.solvers import cmaes
    from nlsolver_torch.solvers._lane import Draws

    fn = nt.PROBLEMS["rastrigin"].fn
    x0 = torch.full((CMA_B, CMA_N), -0.5, device=dev)
    reset_counts()
    for method in ("xla", "jacobi"):
        cfg = cma_bench_config(method)
        g = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        res = nt.minimize(fn, x0, method="cmaes", layout="batched", config=cfg, generator=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        med = float(res.f_value.median())
        # generations by cmaes.step alone: no drive, no frozen steps (10 of
        # the Jacobi twin's, at some 0.14 s each)
        timed = CMA_GENS if method == "xla" else 10
        state = cmaes.init(fn, x0, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(timed):
            state = cmaes.step(fn, state, cfg, generator=g)
        torch.cuda.synchronize()
        per_gen = (time.perf_counter() - t1) / timed * 1e3
        log(f"[25] minimize(rastrigin, x0[{CMA_B}, {CMA_N}], method='cmaes', layout='batched', "
            f"eigh_method={method!r}) f32: {wall:.3f} s for {CMA_GENS} generations (the drive's "
            f"{-(-(CMA_GENS + 1) // 16) * 16} steps), best value median {med:.4f} from 324.0 "
            f"(limit 80.0), max {float(res.f_value.max()):.4f}; cmaes.step alone {per_gen:.3f} ms "
            f"a generation of {CMA_B} lanes, {CMA_B / per_gen * 1e3:.6g} instance generations/s "
            f"(the fleet: 5.9-6.1 ms through K5r, PERF.md)")
        check(res.x.is_cuda and tuple(res.x.shape) == (CMA_B, CMA_N)
              and bool(torch.isfinite(res.x).all()) and bool((res.iterations == CMA_GENS).all()),
              f"{method}: misshapen, off the card, non-finite or short of {CMA_GENS} generations")
        check(med < 80.0 and float(res.f_value.max()) < 324.0,
              f"{method}: the lanes did not descend as the fleet does")
        del res, state
    check(not launched(), f"the lane CMA-ES launched kernels: {launched()}")

    # 256 float64 lanes against the host, on injected draws: bowls, Rosenbrock, bounded bowls
    gen = torch.Generator().manual_seed(25)
    n, lam = LANE_CMA_N, LANE_CMA_POP
    x0_host = torch.rand((LANE_CMA, n), generator=gen, dtype=torch.float64) * 3.0 - 1.5
    centers = torch.randn((LANE_CMA, n), generator=gen, dtype=torch.float64)
    z = torch.randn((LANE_CMA_GENS + 1, LANE_CMA, lam, n), generator=gen, dtype=torch.float64)
    draws = Draws(None, z)
    box = (torch.full((n,), -0.5, dtype=torch.float64), torch.full((n,), 1.0, dtype=torch.float64))
    kinds = {
        "bowls": (lambda x, c: ((x - c) ** 2).sum(), None),
        "Rosenbrock": (lambda x, c: (100.0 * (x[1:] - x[:-1] ** 2) ** 2
                                     + (1.0 - x[:-1]) ** 2).sum(), None),
        "bounded bowls": (lambda x, c: ((x - c) ** 2).sum(), box),
    }
    cfg = cmaes.CMAESConfig(pop_size=lam, max_iter=LANE_CMA_GENS, eigh_method="jacobi")
    for label, (f, bounds) in kinds.items():
        t0 = time.perf_counter()
        got = cmaes.minimize_batched(
            f, x0_host.to(dev), cfg,
            None if bounds is None else Bounds(*(b.to(dev) for b in bounds)),
            draws=Draws(None, z.to(dev)), data=centers.to(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        want = cmaes.minimize_batched(f, x0_host, cfg, None if bounds is None else Bounds(*bounds),
                                      draws=draws, data=centers)
        host = time.perf_counter() - t1
        worst = cma_lanes_close(torch, got, want, LANE_CMA_RTOL)
        log(f"[25] {label} [{LANE_CMA}, {n}] f64, jacobi, {LANE_CMA_GENS} generations on "
            f"injected draws: {wall:.3f} s on the card, {host:.3f} s on the host; counters equal, "
            f"worst relative difference {worst:.3e} (rtol {LANE_CMA_RTOL:g}), f median "
            f"{float(got.f_value.median()):.3e}")
        if bounds is not None:
            check(float(got.x.min()) >= -0.5 and float(got.x.max()) <= 1.0,
                  "the bounded lanes left their box")
    check(not launched(), f"the lane CMA-ES launched kernels: {launched()}")

    # restarts=8 on the CMA-ES: the starts as the lanes of one batch, one drive
    seen, drives = [], []
    real_batched, real_drive = cmaes.minimize_batched, cmaes.drive

    def spy_batched(fn, x0, *a, **kw):
        seen.append(tuple(x0.shape))
        return real_batched(fn, x0, *a, **kw)

    def spy_drive(*a, **kw):
        drives.append(1)
        return real_drive(*a, **kw)

    rosen = lambda x: 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2  # noqa: E731
    cmaes.minimize_batched, cmaes.drive = spy_batched, spy_drive
    try:
        t0 = time.perf_counter()
        res = nt.minimize(rosen, torch.tensor([-0.5, -0.5], device=dev), method="cmaes",
                          restarts=8, restart_sampler="halton")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cmaes.minimize_batched, cmaes.drive = real_batched, real_drive
    log(f"[25] minimize(rosen, x0, method='cmaes', restarts=8): {wall:.3f} s, batches {seen}, "
        f"drives {len(drives)}, f {float(res.f_value):.3e}, iterations summed "
        f"{int(res.iterations)}")
    check(seen == [(8, 2)] and len(drives) == 1,
          f"restarts=8 ran as {seen} in {len(drives)} drives")
    check(res.x.is_cuda and float(res.f_value) < 1e-8, "restarts=8 missed Rosenbrock's minimum")
    check(not launched(), f"the lane CMA-ES launched kernels: {launched()}")


def rosen_sequential(torch):
    """N-D Rosenbrock with its terms added one by one in index order, so the
    card and the host round the sum alike (a ``.sum()`` orders it by
    device)."""
    def fn(x):
        t = 100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2
        acc = t[0]
        for i in range(1, t.shape[0]):
            acc = acc + t[i]
        return acc

    return fn


def phase_replays(torch, dev):
    """The golden trajectories on the card, the generators and a 10-D DE
    replay card against host, and the card's libm against the C library's."""
    import math
    import os

    from nlsolver_torch import parity
    from nlsolver_torch.random import mt19937, reference_rngs
    from nlsolver_torch.solvers import de_reference

    reset_counts()
    golden = parity.load_golden(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                              "tests", "data", "reference_trajectories.tsv"))
    check(sorted(golden) == sorted(parity.DX_TOL), "the golden file's pairs are not DX_TOL's")
    failed, exact, seconds = [], 0, {}
    for (solver, problem), rows in sorted(golden.items()):
        t0 = time.perf_counter()
        per_k = parity.compare_pair(solver, problem, rows, device=dev)
        seconds[(solver, problem)] = time.perf_counter() - t0
        bad = parity.check_pair(solver, problem, per_k)
        dx = max(r["dx"] for r in per_k)
        tol = parity.DX_TOL[(solver, problem)][0]
        exact += int(tol == 0.0 and not bad)
        if bad:
            failed.append(f"{solver}/{problem}: {bad[:3]}")
        log(f"[26] {solver}/{problem} on the card: {len(rows)} prefixes, max dx {dx:.3e} (tol "
            f"{tol:g}), {'ok' if not bad else bad[:2]}, {seconds[(solver, problem)]:.2f} s")
    log(f"[26] golden pairs: {len(golden) - len(failed)} of {len(golden)} pass on the card, "
        f"{exact} of 30 exact pairs bit-exact, {sum(seconds.values()):.1f} s in all")
    check(not failed and exact == 30, f"golden pairs failed on the card: {failed}")

    # the generators: the first 4096 variates card against host, bit for bit
    def draws(kind, dtype, device):
        with mt19937.registered_mt("mt", seed=42):
            state, nxt = reference_rngs.make(kind, dtype, device)
            return reference_rngs.sample(state, nxt, 4096)[0]

    for kind in ("splitmix", "xoshiro", "xorshift", "halton", "recurrent", "mt"):
        for dtype in (torch.float32, torch.float64):
            t0 = time.perf_counter()
            card = draws(kind, dtype, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            host = draws(kind, dtype, "cpu")
            same = torch.equal(card.cpu(), host) and card.dtype == dtype
            log(f"[26] {kind} {str(dtype)[6:]}: 4096 variates {wall:.2f} s on the card, "
                f"bit-equal to the host's: {same}")
            check(same, f"{kind} {dtype}: the card's variates differ from the host's")

    # a DE replay on 10-D Rosenbrock, card against host
    fn = rosen_sequential(torch)
    cfg = de_reference.DEReferenceConfig(pop_size=50, max_iter=1000)
    x0 = torch.full((10,), 2.0, dtype=torch.float64)
    runs = {}
    for where in (dev, "cpu"):
        state = de_reference.init(fn, x0.to(where), cfg)
        if where != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            state = de_reference.step(fn, state, cfg)
        if where != "cpu":
            torch.cuda.synchronize()
        runs[str(where)] = (state, (time.perf_counter() - t0) / 20)
    card, host = runs[str(dev)][0], runs["cpu"][0]
    same = all(torch.equal(getattr(card, f).cpu(), getattr(host, f))
               for f in ("agents", "scores", "best_id", "iteration", "nfev"))
    log(f"[26] de_reference [50, 10] Rosenbrock, 20 generations: {runs[str(dev)][1]:.3f} s a "
        f"generation on the card, {runs['cpu'][1]:.3f} s on the host; agents bit-equal: {same}; "
        f"best score {float(card.scores.min()):.6e}")
    check(same and int(card.iteration) == 20, "the DE replay's agents differ card against host")

    # seconds a generation of each replay on the golden pairs, card and host
    for solver, problem in (("sann_xorshift", "rosenbrock"), ("pso_acc_xorshift", "rosenbrock"),
                            ("nmpso_xorshift", "rosenbrock"), ("de_rand_xorshift", "rosenbrock")):
        rows = golden[(solver, problem)]
        t0 = time.perf_counter()
        parity.compare_pair(solver, problem, rows, device="cpu")
        host = time.perf_counter() - t0
        k = max(r["k"] for r in rows)
        log(f"[26] {solver}/{problem}: {seconds[(solver, problem)] / k:.4f} s a generation on "
            f"the card, {host / k:.4f} on the host ({k} generations)")

    # how often the card's own libm parts from the C library's, which the replays take
    u = torch.rand(10000, generator=torch.Generator().manual_seed(26), dtype=torch.float64)
    rates = {}
    for name, arg in (("log", u), ("exp", 4.0 * u - 2.0), ("cos", 6.283186 * u),
                      ("sin", 6.283186 * u - 3.141593), ("sqrt", 9.0 * u)):
        card = getattr(torch, name)(arg.to(dev)).cpu().tolist()
        rates[name] = sum(c != getattr(math, name)(v) for c, v in zip(card, arg.tolist())) / 1e4
    log(f"[26] the card's float64 log, exp, cos, sin, sqrt against the C library's on 10^4 inputs: "
        f"shares that differ {rates}")
    check(not launched(), f"the replays launched kernels: {launched()}")


SHARD_DE_CPU = 256   # de_sharded's and the PSO's lanes held against their own run on the host in f64
# the island DE's: its two forms on 256 lanes to max_iter took about a
# minute each on a host of 8 cores, on 128 some 10 s
SHARD_ISLANDS_CPU = 128
SHARD_LBFGS_CPU = 1 << 16   # the L-BFGS's n held against its own run on the host


def card_against_host_f64(torch, label, card, host, counts):
    """A mesh engine's float64 run on the card against the same run on the
    host: the counters equal on at least 90 % of the lanes, and |f card -
    f host| / max(|f|, 1) < 1e-9 on those; no kernel launched."""
    agree = ((card.iterations.cpu() == host.iterations) & (card.converged.cpu() == host.converged)
             & (card.function_calls.cpu() == host.function_calls)).reshape(-1)
    rel = ((card.f_value.cpu() - host.f_value).abs()
           / host.f_value.abs().clamp_min(1.0)).reshape(-1)[agree]
    log(f"[27] {label} f64, card against host: counters equal on {int(agree.sum())} of "
        f"{agree.numel()} lanes, largest |f card - f host| / max(|f|, 1) there "
        f"{float(rel.max()) if rel.numel() else float('nan'):.3e}; converged (halted by a "
        f"tolerance) card {float(card.converged.float().mean()):.6f}, host "
        f"{float(host.converged.float().mean()):.6f}, iterations at most card "
        f"{int(card.iterations.max())}, host {int(host.iterations.max())}; launches {counts}")
    check(not counts, f"{label} launched {counts}")
    check(float(agree.float().mean()) >= 0.9 and rel.numel() > 0 and float(rel.max()) < 1e-9,
          f"{label}: the card's f64 run parts from the host's")


def timed_counted(torch, run):
    """``run()`` once from zeroed counts: its result, seconds and launches."""
    reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launched()


def phase_sharded(torch, dev):
    """The mesh routes on a world of one NCCL rank (``parallel.distributed``,
    ``make_mesh(dp=1, pop=1)``), each against its unsharded engine through
    ``benches.mesh.run_routes``, and de_sharded."""
    import torch.distributed as dist

    import nlsolver_torch as nt
    from nlsolver_torch.benches import mesh as mesh_bench
    from nlsolver_torch.parallel import distributed, make_mesh

    distributed.initialize()                 # no launcher here: a world of its own
    mesh = make_mesh(dp=1, pop=1)
    check(dist.get_world_size() == 1 and mesh.device_type == "cuda",
          f"the mesh is {mesh}, world {dist.get_world_size()}")
    log(f"[27] mesh {mesh}, backend {dist.get_backend()}")
    try:
        # raises where a route's kernel did not run or a plain twin did
        rows = mesh_bench.run_routes(mesh, dev)
        overhead = {}
        for name, r in rows.items():
            overhead[name] = 1.0 / r["speedup"] - 1.0
            log(f"[27] {name}: unsharded {' '.join(f'{t:.4f}' for t in r['unsharded_s'])} s, "
                f"sharded {' '.join(f'{t:.4f}' for t in r['sharded_s'])} s (after a warm-up of "
                f"each; pairs u s, s u, u s, s u), launches {r['launches_sharded']}, (sharded - "
                f"unsharded) / unsharded of the medians {overhead[name]:+.4f}")
            check(r["bit_equal"], f"{name}: the sharded result is not the unsharded one")
            check(r["launches_sharded"] == r["launches_unsharded"],
                  f"{name}: launches {r['launches_sharded']}, unsharded {r['launches_unsharded']}")
        launches = {kid: n for r in rows.values() for kid, n in r["launches_sharded"].items()}

        # de_sharded on 8192 10-D Rastrigin instances of 64 agents: no
        # unsharded engine draws as it does, so it is held to its own run
        # on the host in float64
        (name, de), = mesh_bench.run_de(1, dev).items()
        de = de["1x1"]
        log(f"[27] {name}: {de['s']:.3f} s, {de['generations']} generations at most "
            f"({de['ms_a_generation']:.2f} ms a generation), converged {de['converged']:.6f}")
        check(de["converged"] >= 0.99, f"de_sharded: converged share {de['converged']}")
        host_mesh = make_mesh(dp=1, pop=1, device_type="cpu")
        w64 = torch.full((SHARD_DE_CPU, 10), 10.24, dtype=torch.float64, device=dev)
        cfg = nt.DEConfig(pop_size=64, max_iter=1000)
        rastrigin = nt.PROBLEMS["rastrigin"].fn
        card, _, counts = timed_counted(torch, lambda: nt.minimize(
            rastrigin, w64, method="de", layout="sharded", mesh=mesh, config=cfg))
        host = nt.minimize(rastrigin, w64.cpu(), method="de", layout="sharded", mesh=host_mesh,
                           config=cfg)
        card_against_host_f64(torch, f"de_sharded on {SHARD_DE_CPU} lanes", card, host, counts)
        phase_sharded_engines(torch, dev)
    finally:
        dist.destroy_process_group()
    log(f"[27] overhead of the sharded wrapper on one rank, (sharded - unsharded) / unsharded: "
        f"{json.dumps({k: round(v, 4) for k, v in overhead.items()})}")
    return launches


def phase_sharded_engines(torch, dev):
    """Phase 27's engines with no unsharded twin, at full width on the one
    NCCL rank, then each held to its own run on the host in float64."""
    from nlsolver_torch.benches import mesh as mesh_bench

    runs = {"pso": mesh_bench.run_pso, "islands": mesh_bench.run_islands,
            "lbfgs": mesh_bench.run_lbfgs}
    with mesh_bench.counted_twins() as twins:
        for kind, run in runs.items():
            out, _, counts = timed_counted(torch, lambda: run(1, dev))
            check(not counts, f"{kind}: launched {counts}")
            for name, rows in out.items():
                row = rows["1x1"]
                res = row["result"]
                log(f"[27] {name}: {row['s']:.3f} s, {row['generations']} "
                    f"{'iterations' if kind == 'lbfgs' else 'generations'} at most "
                    f"({row['ms_a_generation']:.2f} ms each), converged "
                    f"{row['converged']:.6f}" + (f", max |x - t| {row['x_err']:.3e}"
                                                  if kind == "lbfgs" else ""))
                check(bool(torch.isfinite(res.f_value).all()) and row["ranks_agree"],
                      f"{name}: a value that is not finite")
                if kind == "lbfgs":
                    check(row["converged"] == 1.0 and row["x_err"] < 1e-4,
                          f"{name}: not converged to the targets ({row['x_err']})")
        # to the configs' own max_iter, as de_sharded is held
        f64 = dict(dtype=torch.float64)
        for kind, kw in (("pso", dict(f64, scale=8192 // SHARD_DE_CPU)),
                         ("islands", dict(f64, scale=8192 // SHARD_ISLANDS_CPU)),
                         ("lbfgs", dict(scale=(1 << 23) // SHARD_LBFGS_CPU))):
            card, card_s, counts = timed_counted(torch, lambda: runs[kind](1, dev, **kw))
            t0 = time.perf_counter()
            host = runs[kind](1, torch.device("cpu"), device_type="cpu", **kw)
            log(f"[27] {kind} f64 against the host: {card_s:.1f} s on the card, "
                f"{time.perf_counter() - t0:.1f} s on the host (each with its warm-ups)")
            for name in card:
                card_against_host_f64(torch, name, card[name]["1x1"]["result"],
                                      host[name]["1x1"]["result"], counts)
    check(not any(twins.values()), f"a plain twin ran on the mesh engines: {twins}")


def phase_benches_port(torch, dev):
    """bench_qr_shapes and bench_de_fused_sweep, their kernels counted."""
    from nlsolver_torch.benches import bench_de_fused_sweep, bench_qr_shapes

    # reps=5 (the bench's default is 20): torch.linalg.qr takes some 0.18 s
    # a call at [4096, 16, 16] on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md)
    out, wall, counts = timed_counted(torch, lambda: bench_qr_shapes(B=4096, runs=3, reps=5))
    for row in out["rows"]:
        log(f"[28] bench_qr_shapes [{row['m']}, {row['n']}, 4096]: " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v) for k, v in row.items()}))
        check(row["recon_rel_err"] < 1e-5 and row["kernel_recon_rel_err"] < 1e-5,
              f"bench_qr_shapes [{row['m']}, {row['n']}]: Q R is not A")
    log(f"[28] bench_qr_shapes: {wall:.1f} s, launches {counts}")
    check({"qr_wavefront_warp", "least_squares_wavefront_shared",
           "least_squares_wavefront_registers"} <= set(counts),
          f"bench_qr_shapes launched {counts}")
    launches = {"K2a-w": counts["qr_wavefront_warp"]}
    out, wall, counts = timed_counted(torch, lambda: bench_de_fused_sweep(iters=50, runs=3))
    for row in out["rows"]:
        log("[28] bench_de_fused_sweep " + json.dumps(
            {k: (round(v, 3) if isinstance(v, float) else v) for k, v in row.items()}))
    log(f"[28] bench_de_fused_sweep: {wall:.1f} s, launches {counts}, fused wins "
        f"{out['fused_wins']}")
    check(set(counts) == {"de_generation_staged"}, f"bench_de_fused_sweep launched {counts}")
    launches["K1s"] = counts["de_generation_staged"]
    return launches


def kernel_row(name, source, replaces, launches, max_err, times, bound_ms_by, issue_ms=None,
               shape=None):
    """One entry of the kernels line; ``issue_ms``, where phase 2 found it,
    is the floor of the kernel's instruction issue beside its bound, and
    ``shape``, where given, the shape the row was timed at."""
    ms, plain_ms, library_ms = times
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1], "library_ms": library_ms,
           "issue_ms": issue_ms}
    if shape is not None:
        row["shape"] = shape
    return row


def err_at(err, kid, shape):
    """The largest |kernel - twin| phase 11 found for ``kid`` at ``shape``
    (its labels there begin with the shape)."""
    found = [e for (k, label), e in err.items() if k == kid and label.startswith(shape)]
    check(bool(found), f"phase 11 held {kid} nowhere at {shape}")
    return max(found)


def phases_earlier(torch, dev):
    max_err = phase(3, phase_injected, torch, dev)
    phase(4, phase_philox, torch, dev)
    de_launches = phase(5, phase_slice, torch, dev)
    de_times = phase(6, phase_timing, torch, dev)
    chol_err, k3_launches, spd_twin_ms = phase(7, phase_smallchol, torch, dev)
    qr_err, qr_launches, qr_twin_ms = phase(8, phase_qr, torch, dev)
    fleet_launches = phase(9, phase_nlls_slice, torch, dev)
    alone = phase(10, phase_nlls_timing, torch, dev, spd_twin_ms, qr_twin_ms)
    rank2_err = phase(11, phase_rank2, torch, dev)
    bfgs_launches = phase(12, phase_bfgs_slice, torch, dev)
    alone.update(phase(13, phase_bfgs_timing, torch, dev))
    # an issue floor above the time measured would be no floor: the model
    # (4 warp-instructions a clock an SM) held against the card
    for kid, times in (("K1s", de_times["K1s"]), ("K1c", de_times["K1c"]),
                       ("K1g", de_times["K1g"]), ("K2b-r", alone["K2b-r"]),
                       ("K2b-w", alone["K2b-w"]), ("K2a-w", alone["K2a-w"]),
                       ("K4b-c", alone["K4b-c"]), ("K4b-t", alone["K4b-t"]),
                       ("K4b", alone["K4b"]), ("K3-r", alone["K3-r"]), ("K3-w", alone["K3-w"])):
        log(f"[10] {kid}: {times[0] * 1e3:.2f} us of device time against its issue floor "
            f"{FLOORS[kid] * 1e3:.2f} us")
        check(FLOORS[kid] <= times[0], f"{kid}'s issue floor lies above its time")
    m = FLEET_M + 2  # rows of the NLLS fleet's augmented system [J; sqrt(lam) I]
    csrc, tpu = "nlsolver_torch/csrc/", "nlsolver_tpu/ops/"
    k2b = tpu + "qr_wavefront.py:207"
    # the shapes of phase 11's labels at which the K4 rows are held
    main = f"[{BFGS_N}, {BFGS_N}, {BFGS_B}] f32"
    wide = f"[{WIDE_N}, {WIDE_N}, {WIDE_B}] f32"
    wide_k4b = f"[{WIDE_K4B_N}, {WIDE_K4B_N}, {WIDE_K4B_B}] float32"
    batch = f"[{BATCH_B}, {BFGS_N}, {BFGS_N}] f32"
    return [
        # agents in and out, scores in and out, the active mask; 30
        # floating-point operations a coordinate (mutation, crossover, a
        # Rastrigin term with its cosine as one), which leaves out the cosine's
        # range reduction and Philox's integer rounds (see the issue floors)
        kernel_row("de_generation_staged", csrc + "de_fused.cu", TPU_KERNEL, de_launches["K1s"],
                   max_err, de_times["K1s"], de_bound(B, N, P), FLOORS["K1s"]),
        # the wide fleet's [256, 29, 1024] through the cluster form, the
        # global form there by a direct call
        kernel_row("de_generation_cluster", csrc + "de_fused.cu", TPU_KERNEL, de_launches["K1c"],
                   max_err, de_times["K1c"], de_bound(*DE_WIDE[:3]), FLOORS["K1c"],
                   shape="[256, 29, 1024]"),
        kernel_row("de_generation_global", csrc + "de_fused.cu", TPU_KERNEL, de_launches["K1g"],
                   max_err, de_times["K1g"], de_bound(*DE_WIDE[:3]), FLOORS["K1g"],
                   shape="[256, 29, 1024], a direct call"),
        # A in, R and Q out; each form at its path's shape: K2a-w at [16, 16,
        # 4096], K2a-c past its range at linalg.qr's [170, 170, 32], K2a-d
        # past K2a-c's range at [333, 333, 2] f64, K2a-g by a direct call at
        # [170, 170, 32]
        kernel_row("qr_wavefront_warp", csrc + "qr_wavefront.cu", tpu + "qr_wavefront.py:150",
                   qr_launches["K2a-w"], qr_err, alone["K2a-w"],
                   bound(3 * 16 * 16 * 4096 * 4, givens_ops(16, 16, 16) * 4096), FLOORS["K2a-w"],
                   shape="[16, 16, 4096] f32 with Q"),
        kernel_row("qr_wavefront_cluster", csrc + "qr_wavefront.cu", tpu + "qr_wavefront.py:150",
                   qr_launches["K2a-c"], qr_err, alone["K2a-c"],
                   bound(3 * 170 * 170 * 32 * 4, givens_ops(170, 170, 170) * 32),
                   shape="[170, 170, 32] f32 with Q"),
        kernel_row("qr_wavefront_distributed", csrc + "qr_wavefront.cu",
                   tpu + "qr_wavefront.py:150", qr_launches["K2a-d"], qr_err, alone["K2a-d"],
                   bound(3 * K2AD_N * K2AD_N * 2 * 8, givens_ops(K2AD_N, K2AD_N, K2AD_N) * 2, True),
                   shape=f"[{K2AD_N}, {K2AD_N}, 2] f64 with Q"),
        kernel_row("qr_wavefront_global", csrc + "qr_wavefront.cu", tpu + "qr_wavefront.py:150",
                   qr_launches["K2a-g"], qr_err, alone["K2a-g"],
                   bound(3 * 170 * 170 * 32 * 4, givens_ops(170, 170, 170) * 32),
                   shape="[170, 170, 32] f32 with Q, a direct call"),
        # past K2a-d's range: linalg.qr at the first square shapes with Q in
        # f64 (the row's time) and f32, one launch each (phase 8)
        kernel_row("qr_wavefront_panel", csrc + "qr_wavefront.cu", tpu + "qr_wavefront.py:150",
                   qr_launches["K2a-p"], qr_err, alone["K2a-p"], qr_bound(K2AP_N["float64"], 2, True),
                   shape=f"[{K2AP_N['float64']}, {K2AP_N['float64']}, 2] f64 with Q"),
        # A and y in, x out; each form at the fleet it serves
        kernel_row("least_squares_wavefront_registers", csrc + "qr_wavefront.cu", k2b,
                   fleet_launches["K2b-r"], qr_err, alone["K2b-r"], lstsq_bound(m, 2, FLEET_B),
                   FLOORS["K2b-r"]),
        kernel_row("least_squares_wavefront_shared", csrc + "qr_wavefront.cu", k2b,
                   fleet_launches["K2b-s"], qr_err, alone["K2b-s"],
                   lstsq_bound(CHEB_SHARED[1] + CHEB_SHARED[0], *CHEB_SHARED[::2])),
        kernel_row("least_squares_wavefront_warp", csrc + "qr_wavefront.cu", k2b,
                   fleet_launches["K2b-w"], qr_err, alone["K2b-w"],
                   lstsq_bound(CHEB_WARP[1] + CHEB_WARP[0], *CHEB_WARP[::2]), FLOORS["K2b-w"]),
        # the float64 fleet past the warp form's range; past the cluster
        # form's range the distributed form through the dispatcher and the
        # device-memory form by a direct call, both at [330, 330, 2] f64
        kernel_row("least_squares_wavefront_cluster", csrc + "qr_wavefront.cu", k2b,
                   fleet_launches["K2b-c"], qr_err, alone["K2b-c"],
                   lstsq_bound(CHEB_CLUSTER[1] + CHEB_CLUSTER[0], *CHEB_CLUSTER[::2], True)),
        kernel_row("least_squares_wavefront_distributed", csrc + "qr_wavefront.cu", k2b,
                   qr_launches["K2b-d"], qr_err, alone["K2b-d"],
                   lstsq_bound(K2BD_N, K2BD_N, 2, True)),
        kernel_row("least_squares_wavefront_global", csrc + "qr_wavefront.cu", k2b,
                   qr_launches["K2b-g"], qr_err, alone["K2b-g"],
                   lstsq_bound(K2BD_N, K2BD_N, 2, True)),
        # past K2b-d's range: its launches on the Chebyshev fits of 1263
        # coefficients in f64 (phase 9), its time at the first n in f64
        # (phase 10)
        kernel_row("least_squares_wavefront_panel", csrc + "qr_wavefront.cu", k2b,
                   fleet_launches["K2b-p"], qr_err, alone["K2b-p"],
                   lstsq_bound(K2BP_N["float64"], K2BP_N["float64"], 2, True),
                   shape=f"[{K2BP_N['float64']}, {K2BP_N['float64']}, 2] f64"),
        # A's lower triangle and b in, x out; each form at the fleet it
        # serves, K3-c at its path past K3-w's range, past K3-c's range K3-d
        # and K3-g by direct calls, both at [646, 646, 2] f64, where the
        # dispatcher takes K3-b
        kernel_row("solve_spd_registers", csrc + "smallchol.cu", tpu + "smallchol.py:101",
                   fleet_launches["K3-r"], chol_err["K3-r"], alone["K3-r"],
                   spd_bound(2, FLEET_B), FLOORS["K3-r"]),
        kernel_row("solve_spd_warp", csrc + "smallchol.cu", tpu + "smallchol.py:101",
                   fleet_launches[f"K3 n={CHEB_WARP[0]}"], chol_err["K3-w"], alone["K3-w"],
                   spd_bound(CHEB_WARP[0], CHEB_WARP[2]), FLOORS["K3-w"]),
        kernel_row("solve_spd_cluster", csrc + "smallchol.cu", tpu + "smallchol.py:101",
                   k3_launches["K3-c"], chol_err["K3-c"], alone["K3-c"],
                   spd_bound(K3G_N, K3G_B, True)),
        kernel_row("solve_spd_distributed", csrc + "smallchol.cu", tpu + "smallchol.py:101",
                   k3_launches["K3-d"], chol_err["K3-d"], alone["K3-d"], spd_bound(K3D_N, 2, True),
                   shape=f"[{K3D_N}, {K3D_N}, 2] f64, a direct call"),
        kernel_row("solve_spd_batchminor_global", csrc + "smallchol.cu",
                   tpu + "smallchol.py:101", k3_launches["K3-g"], chol_err["K3-g"], alone["K3-g"],
                   spd_bound(K3D_N, 2, True)),
        # past K3-c's range: its launches on the Chebyshev fits of 1263
        # coefficients in f64 (phase 9; phase 7's dispatcher calls beside
        # them), its time there through the dispatcher (phase 10); max_abs_err
        # against its plain version, whose back solve is not the twin's order
        kernel_row("solve_spd_blocked", csrc + "smallchol.cu", tpu + "smallchol.py:101",
                   fleet_launches[f"K3 n={CHEB_PANEL[0]}"], chol_err["K3-b"],
                   alone[f"K3-b n={CHEB_PANEL[0]}"], spd_bound(CHEB_PANEL[0], 2, True),
                   shape=f"[{CHEB_PANEL[0]}, {CHEB_PANEL[0]}, 2] f64"),
        kernel_row("rank2_direction_batchminor_resident", csrc + "rank2.cu", tpu + "rank2.py:280",
                   bfgs_launches["K4a"], err_at(rank2_err, "K4a", main), alone["K4a"],
                   rank2_bound(BFGS_N, BFGS_B)),
        # each at the wide fleet it serves: K4b-c at [128, 128, 4096], K4b-t
        # past K4b-c's range at [225, 225, 256]; K4b, the form there before,
        # by a direct call at that shape
        kernel_row("rank2_direction_batchminor_cluster", csrc + "rank2.cu", tpu + "rank2.py:214",
                   bfgs_launches["K4b-c"], err_at(rank2_err, "K4b-c", wide), alone["K4b-c"],
                   rank2_bound(WIDE_N, WIDE_B), FLOORS["K4b-c"], shape="[128, 128, 4096] f32"),
        kernel_row("rank2_direction_batchminor_streamed", csrc + "rank2.cu", tpu + "rank2.py:214",
                   bfgs_launches["K4b-t"], err_at(rank2_err, "K4b-t", wide_k4b), alone["K4b-t"],
                   rank2_bound(WIDE_K4B_N, WIDE_K4B_B), FLOORS["K4b-t"],
                   shape="[225, 225, 256] f32"),
        kernel_row("rank2_direction_batchminor_rowsplit", csrc + "rank2.cu", tpu + "rank2.py:214",
                   bfgs_launches["K4b"], err_at(rank2_err, "K4b", wide_k4b), alone["K4b"],
                   rank2_bound(WIDE_K4B_N, WIDE_K4B_B), FLOORS["K4b"],
                   shape="[225, 225, 256] f32, a direct call"),
        # K4c-w, the form the single-instance BFGS's [10000, 16, 16] took
        # before K4c-r, by a direct call there
        kernel_row("rank2_update_batched_warp", csrc + "rank2.cu", tpu + "rank2.py:66",
                   bfgs_launches["K4c-w"], err_at(rank2_err, "K4c-w", batch), alone["K4c-w"],
                   rank2_bound(BFGS_N, BATCH_B, direction=False),
                   shape=f"[{BATCH_B}, {BFGS_N}, {BFGS_N}] f32, a direct call"),
    ], {"alone": alone, "err": rank2_err, "qr_launches": qr_launches, "k3_launches": k3_launches}


def eigh_rows(launches, err, alone):
    csrc, tpu = "nlsolver_torch/csrc/eigh_jacobi.cu", "nlsolver_tpu/ops/eigh_jacobi.py:213"
    return [
        kernel_row("eigh_jacobi_registers", csrc, tpu, launches["K5r"], err["K5r"], alone["K5r"],
                   jacobi_bound(CMA_N, CMA_B, 8)),
        kernel_row("eigh_jacobi_resident", csrc, tpu, launches["K5a"], err["K5a"], alone["K5a"],
                   jacobi_bound(64, CMA_WIDE_B, 8)),
        kernel_row("eigh_jacobi_cluster", csrc, tpu, launches["K5c"], err["K5c"], alone["K5c"],
                   jacobi_bound(CMA_EDGE_N, CMA_EDGE_B, 8)),
        kernel_row("eigh_jacobi_global", csrc, tpu, launches["K5b"], err["K5b"], alone["K5b"],
                   jacobi_bound(K5B_N, K5B_B, K5B_SWEEPS)),
    ]


def main():
    import torch

    start = time.perf_counter()
    name = phase(1, phase_device, torch)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(2, phase_build)
    rows, k4c = phases_earlier(torch, dev)
    eigh_err = phase(14, phase_eigh, torch, dev)
    cmaes_launches = phase(15, phase_cmaes_slice, torch, dev)
    rows += eigh_rows(cmaes_launches, eigh_err, phase(16, phase_cmaes_timing, torch, dev))
    phase(17, phase_roots, torch, dev)
    phase(18, phase_root_timing, torch, dev)
    phase(19, phase_pso_sann_slice, torch, dev)
    phase(20, phase_pso_sann_timing, torch, dev)
    batch_launches = phase(21, phase_lane_solvers, torch, dev)
    phase(22, phase_lane_solvers_timing, torch, dev)
    phase(23, phase_free_solvers, torch, dev)
    phase(24, phase_free_timing, torch, dev)
    phase(25, phase_cmaes_lanes, torch, dev)
    phase(26, phase_replays, torch, dev)
    sharded = phase(27, phase_sharded, torch, dev)
    benched = phase(28, phase_benches_port, torch, dev)
    # K4c-r on the single-instance BFGS's path, K4c-g on its wide arm's
    # (phase 21), each timed alone in phase 13
    csrc, tpu = "nlsolver_torch/csrc/rank2.cu", "nlsolver_tpu/ops/rank2.py:66"
    rows.append(kernel_row("rank2_update_batched_rows", csrc, tpu, batch_launches["K4c-r"],
                           err_at(k4c["err"], "K4c-r", f"[{BATCH_B}, {BFGS_N}, {BFGS_N}] f32"),
                           k4c["alone"]["K4c-r"],
                           rank2_bound(BFGS_N, BATCH_B, direction=False),
                           shape=f"[{BATCH_B}, {BFGS_N}, {BFGS_N}] f32, bench_bfgs_batch's path"))
    rows.append(kernel_row("rank2_update_batched_global", csrc, tpu, batch_launches["K4c-g"],
                           err_at(k4c["err"], "K4c-g", f"[{K4CG_B}, {K4CG_N}, {K4CG_N}] f32"),
                           k4c["alone"]["K4c-g"],
                           rank2_bound(K4CG_N, K4CG_B, direction=False),
                           shape=f"[{K4CG_B}, {K4CG_N}, {K4CG_N}] f32, the wide arm's path"))
    # the launches of the sharded paths (phase 27) and of the benches of
    # phase 28, beside each row's main-path launches
    more = {"rank2_direction_batchminor_resident": {
                f"minimize(layout='sharded') bowls [{BFGS_N}, {BFGS_B}]": sharded["K4a"]},
            "least_squares_wavefront_registers": {
                f"fit_fleet_sharded qr_pallas [2, {FLEET_B}]": sharded["K2b-r"]},
            "least_squares_wavefront_panel": {
                "phase 8's dispatcher calls at its first shapes": k4c["qr_launches"]["K2b-p"]},
            "solve_spd_registers": {f"fit_fleet_sharded cholesky [2, {FLEET_B}]": sharded["K3-r"]},
            "solve_spd_blocked": {
                "phase 7's dispatcher calls at its first shapes": k4c["k3_launches"]["K3-b"]},
            "eigh_jacobi_registers": {
                f"minimize(layout='sharded') cmaes [{CMA_N}, {CMA_B}]": sharded["K5r"]},
            "qr_wavefront_warp": {"bench_qr_shapes": benched["K2a-w"]},
            "de_generation_staged": {"bench_de_fused_sweep": benched["K1s"]}}
    for row in rows:
        if row["name"] in more:
            row["more_launches"] = more[row["name"]]
    # K2a-p's and K2b-p's other shapes: the other dtype's first shape and
    # the direct call's at K2a-d's and K2b-d's paths; K3-b's through the
    # dispatcher at K3-d's old path and at the first shapes past K3-d's
    # range (phase 10)
    alone = k4c["alone"]
    others = {"qr_wavefront_panel": [
                  (f"[{K2AP_N['float32']}, {K2AP_N['float32']}, 2] f32 with Q", "K2a-p n=1875",
                   qr_bound(K2AP_N["float32"], 2)),
                  (f"[{K2AD_N}, {K2AD_N}, 2] f64 with Q, a direct call", "K2a-p n=333",
                   qr_bound(K2AD_N, 2, True))],
              "solve_spd_blocked": [
                  (f"[{K3D_N}, {K3D_N}, 2] f64", f"K3-b n={K3D_N}", spd_bound(K3D_N, 2, True)),
                  (f"[{K3B_N['float64']}, {K3B_N['float64']}, 2] f64", "K3-b",
                   spd_bound(K3B_N["float64"], 2, True)),
                  (f"[{K3B_N['float32']}, {K3B_N['float32']}, 2] f32", "K3-b n=3600",
                   spd_bound(K3B_N["float32"], 2))],
              "least_squares_wavefront_panel": [
                  (f"[{K2BP_N['float32']}, {K2BP_N['float32']}, 2] f32",
                   f"K2b-p n={K2BP_N['float32']}",
                   lstsq_bound(K2BP_N["float32"], K2BP_N["float32"], 2)),
                  (f"[{K2BD_N}, {K2BD_N}, 2] f64, a direct call", f"K2b-p n={K2BD_N}",
                   lstsq_bound(K2BD_N, K2BD_N, 2, True))]}
    for row in rows:
        for shape, key, (bound_ms, bound_by) in others.get(row["name"], ()):
            ms, plain_ms, library_ms = alone[key]
            row.setdefault("more_shapes", {})[shape] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
    print(f"seconds a phase: {PHASE_SECONDS}; {time.perf_counter() - start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
