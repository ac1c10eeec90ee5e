"""Analytic benchmark objectives with known-minima oracles (counterpart of
``nlsolver_tpu.problems.test_functions``; reference test_functions.h:50-319).

Each function takes ``x[..., n]`` and reduces over the last axis, so one
call scores a whole batch of points.  The 2-D functions read ``x[..., 0]``
and ``x[..., 1]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch

PI = math.pi


@dataclass(frozen=True)
class Problem:
    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    dim: int
    minima: tuple  # tuple of tuples, kept hashable
    fmin: float
    # classical search domain
    lower: tuple = ()
    upper: tuple = ()

    @property
    def minima_array(self) -> torch.Tensor:
        return torch.tensor(self.minima, dtype=torch.float64)

    def distance_to_nearest_minimum(self, x: torch.Tensor) -> torch.Tensor:
        """Max-abs distance of ``x[..., n]`` to the nearest known minimum:
        the reference's pass criterion |x_i - x*_i| <= tol for some minimum
        (test_functions.h:392-428)."""
        m = self.minima_array.to(dtype=x.dtype, device=x.device)
        d = (x[..., None, :] - m).abs()
        return d.amax(dim=-1).amin(dim=-1)


def sphere(x):  # test_functions.h:52-57
    return (x * x).sum(-1)


def rosenbrock(x):  # test_functions.h:60-68 (note: 100(x0^2 - x1)^2 variant)
    a, b = x[..., :-1], x[..., 1:]
    return (100.0 * (a**2 - b) ** 2 + (a - 1.0) ** 2).sum(-1)


def rastrigin(x):  # test_functions.h:71-79
    n = x.shape[-1]
    return 10.0 * n + (x * x - 10.0 * torch.cos(2.0 * PI * x)).sum(-1)


def ackley(x):  # test_functions.h:82-92
    n = x.shape[-1]
    a = -20.0 * torch.exp(-0.2 * torch.sqrt((x * x).sum(-1) / n))
    b = -torch.exp(torch.cos(2.0 * PI * x).sum(-1) / n)
    return a + b + math.e + 20.0


def beale(x):  # test_functions.h:95-104
    x0, x1 = x[..., 0], x[..., 1]
    return (
        (1.5 - x0 + x0 * x1) ** 2
        + (2.25 - x0 + x0 * x1**2) ** 2
        + (2.625 - x0 + x0 * x1**3) ** 2
    )


def goldstein_price(x):  # test_functions.h:107-120
    x0, x1 = x[..., 0], x[..., 1]
    a = 1.0 + (x0 + x1 + 1.0) ** 2 * (
        19.0 - 14.0 * x0 + 3.0 * x0**2 - 14.0 * x1 + 6.0 * x0 * x1 + 3.0 * x1**2
    )
    b = 30.0 + (2.0 * x0 - 3.0 * x1) ** 2 * (
        18.0 - 32.0 * x0 + 12.0 * x0**2 + 48.0 * x1 - 36.0 * x0 * x1 + 27.0 * x1**2
    )
    return a * b


def himmelblau(x):  # test_functions.h:122-138
    x0, x1 = x[..., 0], x[..., 1]
    return (x0**2 + x1 - 11.0) ** 2 + (x0 + x1**2 - 7.0) ** 2


def three_hump_camel(x):  # test_functions.h:140-148
    x0, x1 = x[..., 0], x[..., 1]
    return 2.0 * x0**2 - 1.05 * x0**4 + x0**6 / 6.0 + x0 * x1 + x1**2


def cross_in_tray(x):  # test_functions.h:150-171
    x0, x1 = x[..., 0], x[..., 1]
    inner = torch.abs(
        torch.sin(x0) * torch.sin(x1)
        * torch.exp(torch.abs(100.0 - torch.sqrt(x0**2 + x1**2) / PI))
    )
    return -0.0001 * (inner + 1.0) ** 0.1


def eggholder(x):  # test_functions.h:173-182
    x0, x1 = x[..., 0], x[..., 1]
    return -(x1 + 47.0) * torch.sin(torch.sqrt(torch.abs(x0 / 2.0 + (x1 + 47.0)))) - x0 * torch.sin(
        torch.sqrt(torch.abs(x0 - (x1 + 47.0)))
    )


def holder_table(x):  # test_functions.h:184-201
    x0, x1 = x[..., 0], x[..., 1]
    return -torch.abs(
        torch.sin(x0) * torch.cos(x1)
        * torch.exp(torch.abs(1.0 - torch.sqrt(x0**2 + x1**2) / PI))
    )


def mccormick(x):  # test_functions.h:203-211
    x0, x1 = x[..., 0], x[..., 1]
    return torch.sin(x0 + x1) + (x0 - x1) ** 2 - 1.5 * x0 + 2.5 * x1 + 1.0


def schaffer_n2(x):  # test_functions.h:213-221
    x0, x1 = x[..., 0], x[..., 1]
    return 0.5 + (torch.sin(x0**2 - x1**2) ** 2 - 0.5) / (1.0 + 0.001 * (x0**2 + x1**2)) ** 2


def schaffer_n4(x):  # test_functions.h:223-242
    x0, x1 = x[..., 0], x[..., 1]
    return (
        0.5
        + (torch.cos(torch.sin(torch.abs(x0**2 - x1**2))) ** 2 - 0.5)
        / (1.0 + 0.001 * (x0**2 + x1**2)) ** 2
    )


def styblinski_tang(x):  # test_functions.h:244-255
    return (x**4 - 16.0 * x**2 + 5.0 * x).sum(-1) / 2.0


_SHEKEL_A = (
    (4.0, 4.0, 4.0, 4.0),
    (1.0, 1.0, 1.0, 1.0),
    (8.0, 8.0, 8.0, 8.0),
    (6.0, 6.0, 6.0, 6.0),
    (3.0, 7.0, 3.0, 7.0),
    (2.0, 9.0, 2.0, 9.0),
    (5.0, 5.0, 3.0, 3.0),
    (8.0, 1.0, 8.0, 1.0),
    (6.0, 2.0, 6.0, 2.0),
    (7.0, 3.6, 7.0, 3.2),
)
_SHEKEL_C = (0.1, 0.2, 0.2, 0.4, 0.4, 0.6, 0.3, 0.7, 0.5, 0.5)


def shekel(x):  # test_functions.h:257-277 (4-D, 10 foci)
    a = torch.tensor(_SHEKEL_A, dtype=x.dtype, device=x.device)
    c = torch.tensor(_SHEKEL_C, dtype=x.dtype, device=x.device)
    inner = ((x[..., None, :] - a) ** 2).sum(-1)
    return -(1.0 / (inner + c)).sum(-1)


def booth(x):  # test_functions.h:279-286
    x0, x1 = x[..., 0], x[..., 1]
    return (x0 + 2.0 * x1 - 7.0) ** 2 + (2.0 * x0 + x1 - 5.0) ** 2


def bukin_n6(x):  # test_functions.h:288-296
    x0, x1 = x[..., 0], x[..., 1]
    return 100.0 * torch.sqrt(torch.abs(x1 - 0.01 * x0**2)) + 0.01 * torch.abs(x0 + 10.0)


def matyas(x):  # test_functions.h:298-305
    x0, x1 = x[..., 0], x[..., 1]
    return 0.26 * (x0**2 + x1**2) - 0.48 * x0 * x1


def levi_n13(x):  # test_functions.h:307-318
    x0, x1 = x[..., 0], x[..., 1]
    return (
        torch.sin(3.0 * PI * x0) ** 2
        + (x0 - 1.0) ** 2 * (1.0 + torch.sin(3.0 * PI * x1) ** 2)
        + (x1 - 1.0) ** 2 * (1.0 + torch.sin(2.0 * PI * x1) ** 2)
    )


PROBLEMS: Dict[str, Problem] = {
    p.name: p
    for p in [
        Problem("sphere", sphere, 2, ((0.0, 0.0),), 0.0, (-5.12, -5.12), (5.12, 5.12)),
        Problem("rosenbrock", rosenbrock, 2, ((1.0, 1.0),), 0.0, (-5.0, -5.0), (10.0, 10.0)),
        Problem("rastrigin", rastrigin, 2, ((0.0, 0.0),), 0.0, (-5.12, -5.12), (5.12, 5.12)),
        Problem("ackley", ackley, 2, ((0.0, 0.0),), 0.0, (-5.0, -5.0), (5.0, 5.0)),
        Problem("beale", beale, 2, ((3.0, 0.5),), 0.0, (-4.5, -4.5), (4.5, 4.5)),
        Problem("goldstein_price", goldstein_price, 2, ((0.0, -1.0),), 3.0, (-2.0, -2.0), (2.0, 2.0)),
        Problem(
            "himmelblau",
            himmelblau,
            2,
            (
                (3.0, 2.0),
                (-2.805118, 3.131312),
                (-3.779310, -3.283186),
                (3.584428, -1.848126),
            ),
            0.0,
            (-5.0, -5.0),
            (5.0, 5.0),
        ),
        Problem("three_hump_camel", three_hump_camel, 2, ((0.0, 0.0),), 0.0, (-5.0, -5.0), (5.0, 5.0)),
        Problem(
            "cross_in_tray",
            cross_in_tray,
            2,
            (
                (1.34941, -1.34941),
                (1.34941, 1.34941),
                (-1.34941, 1.34941),
                (-1.34941, -1.34941),
            ),
            -2.06261,
            (-10.0, -10.0),
            (10.0, 10.0),
        ),
        Problem("eggholder", eggholder, 2, ((512.0, 404.2319),), -959.6407, (-512.0, -512.0), (512.0, 512.0)),
        Problem(
            "holder_table",
            holder_table,
            2,
            (
                (8.05502, 9.66459),
                (-8.05502, 9.66459),
                (8.05502, -9.66459),
                (-8.05502, -9.66459),
            ),
            -19.2085,
            (-10.0, -10.0),
            (10.0, 10.0),
        ),
        Problem("mccormick", mccormick, 2, ((-0.54719, -1.54719),), -1.9133, (-1.5, -3.0), (4.0, 4.0)),
        Problem("schaffer_n2", schaffer_n2, 2, ((0.0, 0.0),), 0.0, (-100.0, -100.0), (100.0, 100.0)),
        Problem(
            "schaffer_n4",
            schaffer_n4,
            2,
            ((0.0, 1.25313), (0.0, -1.25313), (1.25313, 0.0), (-1.25313, 0.0)),
            0.292579,
            (-100.0, -100.0),
            (100.0, 100.0),
        ),
        Problem(
            "styblinski_tang",
            styblinski_tang,
            2,
            ((-2.903534, -2.903534),),
            -78.33233,
            (-5.0, -5.0),
            (5.0, 5.0),
        ),
        Problem(
            "shekel",
            shekel,
            4,
            ((4.0, 4.0, 4.0, 4.0),),
            -10.5364,
            (0.0, 0.0, 0.0, 0.0),
            (10.0, 10.0, 10.0, 10.0),
        ),
        Problem("booth", booth, 2, ((1.0, 3.0),), 0.0, (-10.0, -10.0), (10.0, 10.0)),
        Problem("bukin_n6", bukin_n6, 2, ((-10.0, 1.0),), 0.0, (-15.0, -5.0), (-5.0, 3.0)),
        Problem("matyas", matyas, 2, ((0.0, 0.0),), 0.0, (-10.0, -10.0), (10.0, 10.0)),
        Problem("levi_n13", levi_n13, 2, ((1.0, 1.0),), 0.0, (-10.0, -10.0), (10.0, 10.0)),
    ]
}

# the 15 problems the reference's test runner enables (test_functions.h:486-524)
REFERENCE_SUITE = [
    "sphere",
    "rosenbrock",
    "rastrigin",
    "ackley",
    "beale",
    "goldstein_price",
    "three_hump_camel",
    "mccormick",
    "schaffer_n2",
    "styblinski_tang",
    "shekel",
    "booth",
    "bukin_n6",
    "matyas",
    "levi_n13",
]


def get(name: str) -> Problem:
    return PROBLEMS[name]
