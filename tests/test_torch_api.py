"""``nlsolver_torch.minimize`` refuses what ``nlsolver_tpu.minimize``
refuses, with the same exception type: a fleet layout for a method that
has none, and the single-instance multistart options (``restarts``) with a
multi-instance layout.  Both packages get the same arguments; the start
points are a numpy array for JAX and a CPU tensor for the port.
``nlsolver_torch.root`` refuses what ``nlsolver_tpu.root`` refuses, word
for word: an unknown method, and ``tiruneh`` given ``lower`` / ``upper``."""
import numpy as np
import pytest
import torch

import nlsolver_torch as nt
import nlsolver_tpu as nj


def _sphere(x):
    return (x ** 2).sum()


def _raised(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e), str(e)
    return None, ""


CASES = [
    # (method, layout, extra keyword arguments, x0 shape)
    ("de", "fleet", {}, (2, 4)),
    ("pso", "fleet", {}, (2, 4)),
    ("nelder_mead", "fleet", {}, (2, 4)),
    ("de", "batched", {"restarts": 3}, (4, 2)),
    ("bfgs", "fleet", {"restarts": 3}, (2, 4)),
]


@pytest.mark.parametrize("method,layout,kwargs,shape", CASES)
def test_refusals_match_the_reference(method, layout, kwargs, shape):
    x0 = np.full(shape, -0.5)
    want, want_msg = _raised(lambda: nj.minimize(_sphere, x0, method=method, layout=layout,
                                                 **kwargs))
    got, got_msg = _raised(lambda: nt.minimize(_sphere, torch.from_numpy(x0), method=method,
                                               layout=layout, **kwargs))
    assert want is ValueError, want_msg
    assert got is want, got_msg
    assert got_msg == want_msg


def test_restarts_of_one_run_a_batched_fleet():
    """restarts=1 and the other multistart options are the multistart run's
    defaults: the reference pops them, and so does the port."""
    cfg = nt.DEConfig(pop_size=16, max_iter=20)
    x0 = torch.full((4, 2), -0.5, dtype=torch.float64)
    res = nt.minimize(nt.PROBLEMS["sphere"].fn, x0, method="de", layout="batched", config=cfg,
                      generator=torch.Generator().manual_seed(0), restarts=1,
                      restart_spread=10.0, restart_sampler="uniform")
    assert res.x.shape == (4, 2) and bool(torch.isfinite(res.f_value).all())
    assert int(res.iterations.max()) <= 20


ROOT_CASES = [
    # (method, lower, upper, extra keyword arguments)
    ("newton", 0.0, 2.0, {}),
    ("tiruneh", 0.0, 2.0, {}),
    ("tiruneh", 0.0, None, {}),
    ("tiruneh", None, 2.0, {"x_k": (0.0, 0.5, 1.0)}),
]


@pytest.mark.parametrize("method,lower,upper,kwargs", ROOT_CASES)
def test_root_refusals_match_the_reference(method, lower, upper, kwargs):
    def fn(x):
        return x - 1.0

    def cpu(v):
        return v if v is None else torch.tensor(v, dtype=torch.float64)

    want, want_msg = _raised(lambda: nj.root(fn, lower, upper, method=method, **kwargs))
    got, got_msg = _raised(lambda: nt.root(fn, cpu(lower), cpu(upper), method=method, **kwargs))
    assert want is ValueError, want_msg
    assert got is want, got_msg
    assert got_msg == want_msg


def test_root_methods_match_the_reference():
    assert nt.root_methods() == nj.root_methods()
