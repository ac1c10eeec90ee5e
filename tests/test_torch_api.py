"""``nlsolver_torch.minimize`` refuses what ``nlsolver_tpu.minimize``
refuses, with the same exception type: a fleet layout for a method that
has none, the single-instance multistart options (``restarts``) with a
multi-instance layout, an unknown method, a method with no single-instance
solver under ``layout="single"`` (with the reference's hint, the package
named aside).  ``methods()`` lists the same modules, and the multistart on
Halton starts equals the reference's.  Both packages get the same arguments; the start
points are a numpy array for JAX and a CPU tensor for the port.
``nlsolver_torch.root`` refuses what ``nlsolver_tpu.root`` refuses, word
for word: an unknown method, and ``tiruneh`` given ``lower`` / ``upper``."""
import jax.numpy as jnp
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
    ("nelder_mead", "batched", {"restarts": 3}, (4, 2)),
    ("nmpso", "fleet", {}, (2, 4)),
    ("simplex", "single", {}, (2,)),
    ("simplex", "batched", {}, (4, 2)),
    ("de_batched", "single", {}, (2,)),
    ("pso_batched", "single", {}, (2,)),
    ("sann_batched", "single", {}, (2,)),
    ("bfgs_fleet", "single", {}, (2,)),
    ("nelder_mead", "single", {"restarts": 3, "restart_sampler": "sobol"}, (2,)),
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


# the single-instance solvers on lane tensors: (method, config of the port,
# config of the JAX package, bounds)
def _lane_methods():
    import nlsolver_tpu.solvers.gd as jgd

    return [
        ("bfgs", None, None, None),
        ("lbfgs", None, None, (-2.0, 0.3)),
        ("lbfgsb", None, None, (-2.0, 0.3)),
        ("gd", nt.GDConfig(alpha=0.1), jgd.GDConfig(alpha=0.1), None),
        ("cgd", None, None, None),
        ("lm", None, None, None),
        ("coordinate", None, None, None),
    ]


def _bowl(x):
    return (1.5 * (x - 0.5) ** 2).sum()


def _fields(res):
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


@pytest.mark.parametrize("layout", ["single", "batched"])
def test_lane_solver_routes_run_their_modules(layout):
    """``minimize`` and ``maximize`` with each of the eight methods under
    ``layout="single"`` (x0 [n]) and ``"batched"`` (x0 [B, n]) give what
    the solver module gives; ``maximize`` flips f_value back."""
    import importlib

    x0 = torch.linspace(-1.0, 1.0, 12, dtype=torch.float64).reshape(4, 3)
    x0 = x0[1] if layout == "single" else x0
    for method, cfg, _, box in _lane_methods():
        mod = importlib.import_module(f"nlsolver_torch.solvers.{method}")
        bounds = None if box is None else nt.Bounds(*box)
        kw = {} if cfg is None else {"config": cfg}
        run = mod.minimize if layout == "single" else mod.minimize_batched
        want = _fields(run(_bowl, x0, bounds=bounds, **kw))
        got = _fields(nt.minimize(_bowl, x0, method=method, layout=layout, bounds=bounds, **kw))
        up = _fields(nt.maximize(lambda x: -_bowl(x), x0, method=method, layout=layout,
                                 bounds=bounds, **kw))
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{method} {f}")
            np.testing.assert_allclose(up[f], -want[f] if f == "f_value" else want[f],
                                       rtol=1e-12, atol=1e-15, err_msg=f"{method} {f}")
        assert got["x"].shape == tuple(x0.shape), method
    c = torch.tensor([0.25, -1.5, 3.0, 0.0], dtype=torch.float64)
    lanes = (4, 1) if layout == "batched" else (1,)
    cc = c if layout == "batched" else c[0]
    res = nt.minimize(lambda t: (t - cc) ** 2, torch.zeros(lanes, dtype=torch.float64),
                      method="brent", layout=layout)
    np.testing.assert_allclose(res.x.numpy(), cc.numpy(), atol=1e-7)


@pytest.mark.parametrize("layout", ["single", "batched"])
@pytest.mark.parametrize("verb", ["minimize", "maximize"])
def test_lane_solver_routes_match_the_reference(layout, verb):
    """The API of both packages on BFGS and L-BFGS-B (with a box), each
    lane's counters equal and x within 1e-9."""
    x0 = np.linspace(-1.0, 1.0, 12).reshape(4, 3)
    x0 = x0[1] if layout == "single" else x0
    sign = 1.0 if verb == "minimize" else -1.0

    def jfn(x):
        return sign * jnp.sum((x - 0.5) ** 2 * jnp.arange(1.0, 4.0))

    def tfn(x):
        return sign * ((x - 0.5) ** 2 * torch.arange(1.0, 4.0, dtype=x.dtype)).sum()

    for method, box in (("bfgs", None), ("lbfgsb", (-2.0, 0.3))):
        jb = None if box is None else nj.Bounds(*box)
        tb = None if box is None else nt.Bounds(*box)
        want = _fields(getattr(nj, verb)(jfn, x0, method=method, layout=layout, bounds=jb))
        got = _fields(getattr(nt, verb)(tfn, torch.from_numpy(x0), method=method, layout=layout,
                                        bounds=tb))
        for f in ("iterations", "function_calls", "gradient_calls", "converged"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{method} {f}")
        np.testing.assert_allclose(got["x"], want["x"], atol=1e-9)
        np.testing.assert_allclose(got["f_value"], want["f_value"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("method", ["bfgs", "gd", "cgd", "lm", "coordinate"])
def test_unconstrained_routes_refuse_what_the_reference_ignores(method):
    """The JAX package takes bounds= for these methods and ignores them;
    the port refuses them (ROADMAP.md, faults in the JAX package)."""
    x0 = np.zeros(3)
    got, msg = _raised(lambda: nt.minimize(_sphere, torch.from_numpy(x0), method=method,
                                           bounds=nt.Bounds(-1.0, 1.0)))
    assert got is ValueError and "takes no bounds" in msg
    got, msg = _raised(lambda: nt.minimize(_sphere, torch.zeros(2, 3, dtype=torch.float64),
                                           method=method, layout="batched",
                                           bounds=nt.Bounds(-1.0, 1.0)))
    assert got is ValueError and "takes no bounds" in msg


def test_ported_routes_and_what_is_left():
    """Every single-instance method is ported under layout="single" and
    "batched", the CMA-ES too; the default method and the multistart run;
    the lane-sharded and population-sharded routes of layout="sharded" are
    ported; what is left of the mesh routes (the population-sharded PSO,
    the dimension-sharded L-BFGS, layout="islands") names the ROADMAP.md
    item that ports it."""
    from nlsolver_torch.api import PORTED_ROUTES

    for method in ("nelder_mead", "de", "pso", "sann", "nmpso", "cmaes", "bfgs", "lbfgs",
                   "lbfgsb", "gd", "cgd", "lm", "brent", "coordinate"):
        assert (method, "single") in PORTED_ROUTES and (method, "batched") in PORTED_ROUTES
    x0 = torch.full((2,), 0.5, dtype=torch.float64)
    for call in (lambda: nt.minimize(_sphere, x0),
                 lambda: nt.minimize(_sphere, x0, method="bfgs", restarts=3)):
        res = call()
        assert res.x.shape == (2,) and float(res.f_value) < 1e-8
    res = nt.minimize(_sphere, x0[None].repeat(3, 1), method="cmaes", layout="batched",
                      config=nt.CMAESConfig(max_iter=200))
    assert res.x.shape == (3, 2) and bool(res.converged.all()) and float(res.f_value.max()) < 1e-8
    for method in ("bfgs", "cmaes", "pso_batched", "sann", "de"):
        assert (method, "sharded") in PORTED_ROUTES
    for method, layout, start in (("pso", "sharded", x0[None]), ("lbfgs", "sharded", x0),
                                  ("cmaes", "islands", x0[None]), ("de", "islands", x0[None])):
        got, msg = _raised(lambda: nt.minimize(_sphere, start, method=method, layout=layout))
        assert got is NotImplementedError and "Queue 1 item 9" in msg and "item 11" not in msg


def test_methods_match_the_reference():
    assert nt.methods() == nj.methods()


@pytest.mark.parametrize("method", ["nlls", "cmaes_fleet"])
def test_single_layout_hints_name_the_package(method):
    """The reference's hint, with the port's package named in it."""
    want, want_msg = _raised(lambda: nj.minimize(_sphere, np.zeros(2), method=method))
    got, got_msg = _raised(lambda: nt.maximize(_sphere, torch.zeros(2, dtype=torch.float64),
                                               method=method))
    assert want is ValueError and got is want
    assert got_msg == want_msg.replace("nlsolver_tpu", "nlsolver_torch").replace(
        "no single-instance minimize", "no single-instance maximize")


def _rosen_j(x):
    return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2


def _rosen_t(x):
    return 100.0 * (x[0] ** 2 - x[1]) ** 2 + (x[0] - 1.0) ** 2


@pytest.mark.parametrize("verb", ["minimize", "maximize"])
@pytest.mark.parametrize("method,bounded", [("nelder_mead", False), ("nelder_mead", True),
                                            ("bfgs", False)])
def test_restarts_on_halton_starts_match_the_reference(method, verb, bounded):
    """``restarts=8`` on Halton starts (key-independent) for the two
    deterministic methods: the winning start's x and flag, and every
    counter summed over the starts, equal the JAX ``_multistart``'s; the
    starts lie in ``bounds`` where given (Nelder-Mead only: the port's
    BFGS refuses bounds)."""
    sign = 1.0 if verb == "minimize" else -1.0
    kw = {"restarts": 8, "restart_sampler": "halton"}
    jb = nj.Bounds(-2.0, 2.0) if bounded else None
    tb = nt.Bounds(-2.0, 2.0) if bounded else None
    want = _fields(getattr(nj, verb)(lambda x: sign * _rosen_j(x), np.array([-0.5, -0.5]),
                                     method=method, bounds=jb, **kw))
    got = _fields(getattr(nt, verb)(lambda x: sign * _rosen_t(x),
                                    torch.tensor([-0.5, -0.5], dtype=torch.float64),
                                    method=method, bounds=tb, **kw))
    for f in ("iterations", "function_calls", "gradient_calls", "hessian_calls", "converged"):
        assert got[f] == want[f], f
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["f_value"], want["f_value"], rtol=0, atol=1e-9)


def test_restarts_never_pick_a_nan_start():
    """A start whose run ends in NaN never wins: the objective is NaN
    right of 1.5 in x[0], where some Halton starts land."""
    def fn(x):
        return torch.where(x[0] > 1.5, torch.nan, ((x - 0.25) ** 2).sum())

    res = nt.minimize(fn, torch.zeros(2, dtype=torch.float64), restarts=6,
                      restart_sampler="halton", restart_spread=3.0)
    assert bool(torch.isfinite(res.f_value)) and float(res.f_value) < 1e-8
    res = nt.minimize(fn, torch.zeros(2, dtype=torch.float64), method="sann", restarts=4,
                      config=nt.SANNConfig(max_iter=20), generator=torch.Generator().manual_seed(1))
    assert bool(torch.isfinite(res.f_value)) and int(res.function_calls) == 4 * (1 + 9 * 20)


def test_restarts_uniform_in_bounds_and_the_cmaes_loop():
    """Uniform starts inside ``bounds``; the CMA-ES runs the starts as the
    lanes of one batch, its counters summed."""
    from nlsolver_torch.solvers import cmaes

    box = nt.Bounds(torch.tensor([-1.0, 0.0], dtype=torch.float64),
                    torch.tensor([0.5, 2.0], dtype=torch.float64))
    res = nt.minimize(_sphere, torch.zeros(2, dtype=torch.float64), method="pso", bounds=box,
                      restarts=5, config=nt.PSOConfig(max_iter=30),
                      generator=torch.Generator().manual_seed(2))
    assert float(res.x[0]) >= -1.0 and float(res.x[0]) <= 0.5 and float(res.x[1]) >= 0.0
    cfg = nt.CMAESConfig(max_iter=40)
    one = cmaes.minimize(_sphere, torch.full((3,), 0.5, dtype=torch.float64), cfg,
                         generator=torch.Generator().manual_seed(4))
    many = nt.minimize(_sphere, torch.full((3,), 0.5, dtype=torch.float64), method="cmaes",
                       config=cfg, restarts=3, generator=torch.Generator().manual_seed(4))
    assert int(many.iterations) >= int(one.iterations) and float(many.f_value) < 1e-3
    assert many.x.shape == (3,)


@pytest.mark.parametrize("layout", ["single", "batched"])
def test_derivative_free_routes_run_their_modules(layout):
    """``minimize`` and ``maximize`` with Nelder-Mead, NM-PSO and the CMA-ES
    under both layouts, and with the row-layout DE, PSO and SANN under
    ``layout="single"``, give what the solver module gives on the same
    generator seed; ``maximize`` flips f_value back."""
    import importlib

    x0 = torch.linspace(-1.0, 1.0, 12, dtype=torch.float64).reshape(4, 3)
    x0 = x0[1] if layout == "single" else x0
    small = {"de": nt.DEConfig(pop_size=8, max_iter=40), "pso": nt.PSOConfig(max_iter=40),
             "sann": nt.SANNConfig(max_iter=10), "cmaes": nt.CMAESConfig(max_iter=30)}
    routed = ["nelder_mead", "nmpso", "cmaes"] + (["de", "pso", "sann"] if layout == "single"
                                                  else [])
    for method in routed:
        mod = importlib.import_module(f"nlsolver_torch.solvers.{method}")
        kw = {"config": small[method]} if method in small else {}
        run = mod.minimize if layout == "single" else mod.minimize_batched
        # Nelder-Mead draws nothing and takes no generator; the API drops it
        drawn = {} if method == "nelder_mead" else {"generator": torch.Generator().manual_seed(5)}
        want = _fields(run(_bowl, x0, **drawn, **kw))
        got = _fields(nt.minimize(_bowl, x0, method=method, layout=layout,
                                  generator=torch.Generator().manual_seed(5), **kw))
        up = _fields(nt.maximize(lambda x: -_bowl(x), x0, method=method, layout=layout,
                                 generator=torch.Generator().manual_seed(5), **kw))
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{method} {f}")
            np.testing.assert_allclose(up[f], -want[f] if f == "f_value" else want[f],
                                       rtol=1e-12, atol=1e-15, err_msg=f"{method} {f}")
        assert got["x"].shape == tuple(x0.shape), method


@pytest.mark.parametrize("method", ["de", "sann"])
def test_row_solvers_refuse_what_the_reference_ignores(method):
    """The JAX row-layout DE and SANN take bounds= and ignore them; the port
    refuses them (ROADMAP.md, faults in the JAX package), single and under
    restarts."""
    for kw in ({}, {"restarts": 3}):
        got, msg = _raised(lambda: nt.minimize(_sphere, torch.zeros(3, dtype=torch.float64),
                                               method=method, bounds=nt.Bounds(-1.0, 1.0), **kw))
        assert got is ValueError and "takes no bounds" in msg, (kw, msg)
