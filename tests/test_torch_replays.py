"""The reference replays (nlsolver_torch.solvers.de_reference,
sann_reference, pso_reference, nmpso_reference) against the JAX package's,
step by step, on a problem outside the golden file: 4-D Rosenbrock from
(-0.5, 0.3, 0.8, -1.2), float64 on the CPU, 10 steps.

Against the JAX replay run op by op (``jax.disable_jit``) every field is
bit-equal after every step: the generator's words, the counters, the
positions (agents, chain points, particles) and the stored scores.  The
jitted JAX replay is not the reference here: XLA contracts the
objective's sums into FMAs, which the eager port does not (2-3 ulps on the
stored scores of these 4-D sums, and a choice such as the PSO swarm best
can flip on them, as the JAX suite notes beside its ``DX_TOL``); and a
single jitted step of the JAX replay, compiled in a process whose JAX suite
already jitted that replay's trajectories (tests/test_trajectory_parity.py
first), fails in jaxlib 0.9 with "Execution supplied N buffers but
compiled program expected M buffers".
"""
import pytest
import torch
from torch_replays_common import steps_equal_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("rng,extra", [
    ("xorshift", {}), ("halton", {}), ("mt", {}), ("xoshiro", {"strategy": "best"}),
])
def test_de_replay_steps_equal_jax(rng, extra):
    """The DE replay (pop 8) on four generators, mt19937(42) through each
    package's registry, and the "best" strategy."""
    steps_equal_jax("de", rng, extra)
