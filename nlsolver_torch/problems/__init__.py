from .test_functions import PROBLEMS, REFERENCE_SUITE, Problem, get

__all__ = ["PROBLEMS", "REFERENCE_SUITE", "Problem", "get"]
