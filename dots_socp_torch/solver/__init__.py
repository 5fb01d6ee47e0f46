"""iALM solver for the SOCP reformulation of dynamic optimal transport (PyTorch).

Layout, module for module as in `dots_socp_tpu/solver`:
  state.py      -- SolverState (all mutable per-iteration data)
  problem.py    -- one-time assembly: operators, Laplacian factor, constants
  step.py       -- the iALM iteration + chunked loops
  kkt.py        -- all 7 KKT residuals
  scaling.py    -- prim/dual/z rescalings + sigma penalty updates
  schedule.py   -- sigma cadence / factor tables / scaling triggers (host)
  socp.py       -- solver_socp orchestration (host)
  decorators.py -- SOCP -> DOT unit translation, stagger -> center grid
"""

import sys
import types

from dots_socp_torch.solver.socp import solver_socp
from dots_socp_torch.solver.decorators import solver, solver_raw

__all__ = ["solver_socp", "solver", "solver_raw"]


class _SolverPackage(types.ModuleType):
    """`dots_socp_torch.solver` names both this subpackage and the API
    function (as in the reference's lazy API). Importing the subpackage
    binds the module under that name on the parent package, so calling the
    module calls the function: either way `dots_socp_torch.solver(...)`
    solves."""

    def __call__(self, *args, **kwargs):
        return solver(*args, **kwargs)


sys.modules[__name__].__class__ = _SolverPackage
