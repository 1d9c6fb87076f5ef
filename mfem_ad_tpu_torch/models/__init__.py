"""Model problems as reusable builders: ``build(...)`` returns a Problem
bundle and ``solve(...)`` runs it."""

from . import elasticity, poisson

__all__ = ["poisson", "elasticity"]
