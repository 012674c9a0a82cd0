"""Minimal solvers: eight-point, Nister-Stewenius five-point, Lambda-Twist P3P."""

from . import eight_point, lambda_twist, nister_stewenius

__all__ = ["eight_point", "lambda_twist", "nister_stewenius"]
