"""The SANN, accelerated PSO and NM-PSO replays against the JAX package's,
step by step (tests/torch_replays_common.py): every field bit-equal to
the JAX replay run op by op, 10 steps of 4-D Rosenbrock in float64.
"""
import pytest
import torch
from torch_replays_common import steps_equal_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("family,rng", [
    ("sann", "xorshift"), ("sann", "recurrent"), ("pso", "xoshiro"), ("nmpso", "xorshift"),
])
def test_replay_steps_equal_jax(family, rng):
    steps_equal_jax(family, rng, {})
