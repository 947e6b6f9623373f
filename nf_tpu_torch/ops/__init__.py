from .splines import (
    rational_quadratic_spline,
    unconstrained_rational_quadratic_spline,
    unconstrained_rational_quadratic_spline_kmajor,
)

__all__ = [
    "rational_quadratic_spline",
    "unconstrained_rational_quadratic_spline",
    "unconstrained_rational_quadratic_spline_kmajor",
]
