from .driver import drive, drive_fleet_scan, drive_scan, drive_trace
from .objective import (Bounds, Objective, batch_eval, resolve_bounds, signed,
                        with_eval_dtype)
from .result import SolverResult, make_result
from .utils import (c_math, clamp, exact_product, lane_where, max_abs, start_points, std_err,
                    where_lanes)

__all__ = [
    "Bounds",
    "Objective",
    "SolverResult",
    "batch_eval",
    "c_math",
    "clamp",
    "exact_product",
    "drive",
    "drive_fleet_scan",
    "drive_scan",
    "drive_trace",
    "lane_where",
    "make_result",
    "max_abs",
    "resolve_bounds",
    "signed",
    "start_points",
    "std_err",
    "where_lanes",
    "with_eval_dtype",
]
