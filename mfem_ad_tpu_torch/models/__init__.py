"""Model problems as reusable builders: ``build(...)`` returns a Problem
bundle and ``solve(...)`` runs it."""

from . import (
    elasticity,
    gradient_obstacle,
    minimal_surface,
    obstacle,
    poisson,
    topopt,
)

__all__ = ["poisson", "elasticity", "minimal_surface", "obstacle",
           "gradient_obstacle", "topopt"]
