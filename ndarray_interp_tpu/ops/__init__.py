from .lerp import calc_frac
from .pcr import pcr_solve
from .searchsorted import get_lower_index, is_in_range
from .thomas import thomas_solve, thomas_solve_fast

__all__ = [
    "calc_frac",
    "get_lower_index",
    "is_in_range",
    "pcr_solve",
    "thomas_solve",
    "thomas_solve_fast",
]
