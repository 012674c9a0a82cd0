"""Minimal solvers: eight-point and Lambda-Twist P3P."""

from . import eight_point, lambda_twist

__all__ = ["eight_point", "lambda_twist"]
