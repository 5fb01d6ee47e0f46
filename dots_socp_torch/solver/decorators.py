"""Solver output adapters: SOCP units -> DOT units -> time-centered grid.

Counterpart of `dots_socp_tpu/solver/decorators.py`, wrapping the port's
`solver_socp` (the reference module imports the JAX solver). Exports
`solver_raw` / `solver` with the standardized contract
``solver(n_time, geometry, **kw) -> (SolutionDotData, RunningHistory)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dots_socp_torch.solver.socp import solver_socp
from dots_socp_tpu.utils.history import RunningHistory
from dots_socp_tpu.utils.types import (
    GeometryData,
    SolutionDotData,
    translate_solution_socp_to_dot,
)


def solver_decorator_socp_to_dot(socp_solver):
    """Wrap an SOCP solver so it returns DOT-unit solutions (mu scaled by
    vertex areas, E by triangle areas)."""

    def solver_dot(
        n_time: int, geometry: GeometryData, **kwargs
    ) -> Tuple[SolutionDotData, RunningHistory]:
        solution_socp, run_history = socp_solver(n_time, geometry, **kwargs)
        return (
            translate_solution_socp_to_dot(solution_socp=solution_socp, geom=geometry),
            run_history,
        )

    return solver_dot


def solver_decorator_time_stagger_to_center(dot_solver):
    """Wrap a DOT solver so the density lives on the time-centered grid:
    interior slices are midpoint averages, endpoints are mu0/mu1."""

    def to_centered(solution: SolutionDotData, mu0, mu1):
        mu = solution["mu"]
        mid = 0.5 * (mu[:-1] + mu[1:])
        solution["mu"] = np.concatenate([mu0[None, :], mid, mu1[None, :]], axis=0)

    def solver_dot_center(
        n_time: int, geometry: GeometryData, **kwargs
    ) -> Tuple[SolutionDotData, RunningHistory]:
        mu0 = np.asarray(geometry["mu0"])
        mu1 = np.asarray(geometry["mu1"])
        solution, run_history = dot_solver(n_time, geometry, **kwargs)
        to_centered(solution, mu0, mu1)
        if solution.get("checkpoints"):
            for checkpoint in solution["checkpoints"]:
                to_centered(checkpoint, mu0, mu1)
        return solution, run_history

    return solver_dot_center


solver_raw = solver_decorator_socp_to_dot(solver_socp)
solver_raw.__name__ = "dot_solver_socp"
solver_raw.__doc__ = (
    "DOT solver (SOCP backend); solution on the time-staggered grid in DOT units."
)

solver = solver_decorator_time_stagger_to_center(solver_raw)
solver.__name__ = "dot_solver_socp_center"
solver.__doc__ = (
    "DOT solver (SOCP backend); solution on the time-centered grid in DOT units."
)
