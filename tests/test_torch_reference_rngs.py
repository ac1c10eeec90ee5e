"""nlsolver_torch.random.reference_rngs and mt19937 against the JAX
package's (with jax_enable_x64, as the JAX suite runs): bit for bit.

For each reference generator the first 10^4 variates in float64 and in
float32 equal ``nlsolver_tpu.random.reference_rngs.sample``'s, and so do
the generator's words after them.  The bit generators (splitmix, xoshiro,
xorshift) and mt19937 compute a variate in float64 and round it to the
dtype asked for, so their float32 stream is held as the float64 stream
rounded (all 10^4) and, drawn as float32, on its first 1000 variates;
halton and recurrent keep their state in the dtype and are drawn 10^4
times in each.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlsolver_torch.random import mt19937 as tm
from nlsolver_torch.random import reference_rngs as tr
from nlsolver_tpu.random import mt19937 as jm
from nlsolver_tpu.random import reference_rngs as jr

torch.set_num_threads(1)
DRAWS = 10_000
DIRECT32 = 1000
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _jax_sample(state, nxt, n):
    return jax.jit(lambda s: jr.sample(s, nxt, n))(state)


def _words(state):
    """Every integer word of a generator state, as Python ints."""
    leaves = state if isinstance(state, tuple) else (state,)
    out = []
    for leaf in leaves:
        if isinstance(leaf, tuple):
            out.extend(_words(leaf))
        else:
            a = np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor) else leaf)
            if a.dtype.kind in "iu":
                out.extend(int(v) for v in a.reshape(-1))
    return out


@pytest.mark.parametrize("kind", ["splitmix", "xoshiro", "xorshift"])
def test_bit_generators_equal_jax(kind):
    state, nxt = tr.make(kind, torch.float64)
    got, final = tr.sample(state, nxt, DRAWS)
    want, want_final = _jax_sample(*jr.make(kind, jnp.float64), DRAWS)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert _words(final) == _words(want_final) and len(_words(final)) >= 2
    want32, _ = _jax_sample(*jr.make(kind, jnp.float32), DRAWS)
    assert np.array_equal(_bits(got.to(torch.float32).numpy()), _bits(want32))
    direct, _ = tr.sample(*tr.make(kind, torch.float32), DIRECT32)
    assert np.array_equal(_bits(direct.numpy()), _bits(want32[:DIRECT32]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["halton", "recurrent"])
def test_float_state_generators_equal_jax(kind, dtype):
    got, final = tr.sample(*tr.make(kind, dtype), DRAWS)
    want, want_final = _jax_sample(*jr.make(kind, JDT[dtype]), DRAWS)
    assert got.dtype == dtype and np.array_equal(_bits(got.numpy()), _bits(want))
    for a, b in zip(final, want_final):
        assert np.array_equal(_bits(a.numpy()), _bits(b))


def test_mt19937_equals_jax():
    state = tm.init(42, torch.float64)
    assert np.array_equal(state.mt.numpy(), np.asarray(jm.init(42).mt).astype(np.int64))
    got, final = tr.sample(state, tm.next_canonical, DRAWS)
    want, want_final = _jax_sample(jm.init(42, jnp.float64), jm.next_canonical, DRAWS)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert np.array_equal(final.mt.numpy(), np.asarray(want_final.mt).astype(np.int64))
    assert int(final.idx) == int(want_final.idx)
    want32, _ = _jax_sample(jm.init(42, jnp.float32), jm.next_canonical, DRAWS)
    assert np.array_equal(_bits(got.to(torch.float32).numpy()), _bits(want32))
    direct, _ = tr.sample(tm.init(42, torch.float32), tm.next_canonical, DIRECT32)
    assert np.array_equal(_bits(direct.numpy()), _bits(want32[:DIRECT32]))


def test_u64_arithmetic_against_python_integers():
    """mul, add, shifts and rotations of (hi, lo) pairs on random words
    (the edges 0 and 2^64 - 1 among them), each against Python's exact
    integers taken mod 2^64."""
    rng = random.Random(0)
    words = [0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1] + [rng.getrandbits(64) for _ in range(60)]
    M = 2**64
    for a in words:
        ta = tr.from_int(a)
        for k in (1, 5, 17, 23, 30, 31, 32, 33, 45, 63):
            assert tr.to_int(tr.shl(ta, k)) == (a << k) % M
            assert tr.to_int(tr.shr(ta, k)) == a >> k
            assert tr.to_int(tr.rotl(ta, k)) == ((a << k) | (a >> (64 - k))) % M
        for b in words[::7]:
            tb = tr.from_int(b)
            assert tr.to_int(tr.mul(ta, tb)) == (a * b) % M
            assert tr.to_int(tr.add(ta, tb)) == (a + b) % M
            assert tr.to_int(tr.xor(ta, tb)) == a ^ b
        for half in tr.from_int(a):
            assert 0 <= int(half) < 2**32 and half.dtype == torch.int64


def test_register_is_scoped_to_its_block():
    """``registered`` (and ``registered_mt``) put a generator in the port's
    own registry for a ``with`` block and take it out after, restoring
    what stood there before; the JAX package's registry is untouched."""
    assert "mt_scoped" not in tr._CUSTOM
    jax_before = dict(jr._CUSTOM)
    with tm.registered_mt("mt_scoped", seed=42):
        state, nxt = tr.make("mt_scoped", torch.float64)
        got, _ = tr.sample(state, nxt, 4)
        want, _ = tr.sample(tm.init(42, torch.float64), tm.next_canonical, 4)
        assert torch.equal(got, want)
    assert "mt_scoped" not in tr._CUSTOM and dict(jr._CUSTOM) == jax_before
    with pytest.raises(ValueError, match="unknown generator"):
        tr.make("mt_scoped")
    # a kind that was registered before comes back after the block
    tr.register("mine", lambda dtype, device: tr.recurrent_init(0.25, dtype, device),
                tr.recurrent_next)
    try:
        with tr.registered("mine", lambda dtype, device: tr.recurrent_init(0.5, dtype, device),
                           tr.recurrent_next):
            assert float(tr.make("mine", torch.float64)[0].z) == float(
                tr.recurrent_init(0.5, torch.float64).z)
        assert float(tr.make("mine", torch.float64)[0].z) == float(
            tr.recurrent_init(0.25, torch.float64).z)
    finally:
        tr.unregister("mine")
    assert "mine" not in tr._CUSTOM


def test_box_muller_parity_is_the_reference_formula():
    """The reference's rnorm with pi truncated to 3.141593, its log, cos
    and sqrt the C library's: equal to the JAX package's on the CPU."""
    from nlsolver_torch.random.sampling import box_muller_parity as tb
    from nlsolver_tpu.random.sampling import box_muller_parity as jb

    u, _ = tr.sample(*tr.make("xorshift", torch.float64), 400)
    u1, u2 = u.reshape(200, 2).unbind(1)
    got = tb(u1, u2)
    want = jax.jit(jb)(jnp.asarray(u1.numpy()), jnp.asarray(u2.numpy()))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
