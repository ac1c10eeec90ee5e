"""The JAX package's mesh engines run op by op, for the tests that show a
difference between them and the port to be rounding.

Jitted, XLA's CPU compiler contracts ``a + F * (b - c)`` and the like into
fused multiply-adds, which the eager port never does; a last-bit
difference can then flip a comparison that a tie decides (a DE proposal
equal to an agent that migration copied).  ``op_by_op(module, mesh)``
swaps the module's ``shard_map`` and ``lax`` for an emulation in which
every shard of the mesh runs the engine's body eagerly in a thread of its
own: each ``jnp`` operation is then its own XLA computation, so nothing is
fused, and the collectives (``psum``, ``pmin``, ``all_gather``,
``ppermute``, ``axis_index``) meet at a barrier and combine the shards'
values in the mesh's order.  ``while_loop`` and ``fori_loop`` become
Python loops.
"""
import contextlib
import threading
import types

import jax.numpy as jnp
from jax import lax

DP, POP = "dp", "pop"


class _Spmd:
    """One run of an engine over the shards of a (dp, pop) mesh."""

    def __init__(self, dp: int, pop: int):
        self.dp, self.pop = dp, pop
        self.barrier = threading.Barrier(dp * pop)
        self.slots = {}
        self.local = threading.local()

    def _group(self, axis):
        d, p = self.local.coord
        if axis == POP:
            return [(d, q) for q in range(self.pop)], p
        return [(e, p) for e in range(self.dp)], d

    def _exchange(self, axis, value, combine):
        self.slots[self.local.coord] = value
        self.barrier.wait()
        group, me = self._group(axis)
        out = combine([self.slots[c] for c in group], me)
        self.barrier.wait()
        return out

    # the lax namespace of the engine
    def axis_index(self, axis):
        return jnp.int32(self._group(axis)[1])

    def psum(self, x, axis):
        def add(vals, _):
            out = vals[0]
            for v in vals[1:]:
                out = out + v
            return out
        return self._exchange(axis, x, add)

    def pmin(self, x, axis):
        def least(vals, _):
            out = vals[0]
            for v in vals[1:]:
                out = jnp.minimum(out, v)
            return out
        return self._exchange(axis, x, least)

    def all_gather(self, x, axis_name, axis=0, tiled=False):
        return self._exchange(axis_name, x, lambda vals, _: (
            jnp.concatenate(vals, axis=axis) if tiled else jnp.stack(vals, axis=axis)))

    def ppermute(self, x, axis, perm):
        def take(vals, me):
            src = [s for s, d in perm if d == me]
            return vals[src[0]] if src else jnp.zeros_like(vals[me])
        return self._exchange(axis, x, take)

    @staticmethod
    def while_loop(cond, body, state):
        while bool(cond(state)):
            state = body(state)
        return state

    @staticmethod
    def fori_loop(lo, hi, body, state):
        for i in range(lo, hi):
            state = body(i, state)
        return state

    def shard_map(self, f, mesh, in_specs, out_specs, check_vma=False):
        def cut(a, spec, d, p):
            if not spec or spec[0] is None:
                return a
            parts, i = (self.dp, d) if spec[0] == DP else (self.pop, p)
            per = a.shape[0] // parts
            return a[i * per:(i + 1) * per]

        def run(*args):
            outs, errors = {}, []

            def shard(d, p):
                self.local.coord = (d, p)
                try:
                    outs[(d, p)] = f(*(cut(a, s, d, p) for a, s in zip(args, in_specs)))
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)
                    self.barrier.abort()

            threads = [threading.Thread(target=shard, args=(d, p))
                       for d in range(self.dp) for p in range(self.pop)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]

            def join(i, spec):
                if not spec or spec[0] is None:
                    return outs[(0, 0)][i]
                if spec[0] == DP:
                    return jnp.concatenate([outs[(d, 0)][i] for d in range(self.dp)])
                return jnp.concatenate([outs[(0, p)][i] for p in range(self.pop)])

            return tuple(join(i, s) for i, s in enumerate(out_specs))

        return run


@contextlib.contextmanager
def op_by_op(module, mesh):
    """Within the block, ``module``'s engines run op by op over ``mesh``'s
    shards (see the module docstring)."""
    spmd = _Spmd(mesh.shape[DP], mesh.shape[POP])
    fake_lax = types.SimpleNamespace(
        **{name: getattr(lax, name) for name in dir(lax) if not name.startswith("_")})
    for name in ("axis_index", "psum", "pmin", "all_gather", "ppermute", "while_loop",
                 "fori_loop"):
        setattr(fake_lax, name, getattr(spmd, name))

    def fake_shard_map(f=None, **kw):
        if f is None:
            return lambda g: spmd.shard_map(g, **kw)
        return spmd.shard_map(f, **kw)

    saved = module.lax, module.shard_map
    module.lax, module.shard_map = fake_lax, fake_shard_map
    try:
        yield
    finally:
        module.lax, module.shard_map = saved
