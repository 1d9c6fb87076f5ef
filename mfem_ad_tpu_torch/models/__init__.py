"""Model problems as reusable builders: ``build(...)`` returns a Problem
bundle and ``solve(...)`` runs it."""

from . import elasticity, minimal_surface, obstacle, poisson

__all__ = ["poisson", "elasticity", "minimal_surface", "obstacle"]
