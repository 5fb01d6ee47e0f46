# The port's own copy of dots_socp_tpu/utils/types.py; only the import paths differ.
"""Typed data contracts shared across the framework.

Parity with reference `dot_surface_socp/utils/type.py:6-84`: same dict keys and
unit-translation semantics so downstream tooling (tables, evaluation,
visualization) can consume either solver's output.

Arrays may be NumPy or JAX arrays; the solver returns NumPy on the host
boundary.
"""

from __future__ import annotations

from typing import Optional, TypedDict

import numpy as np
from typing_extensions import NotRequired


class GeometryData(TypedDict, total=True):
    """Triangulated-surface problem instance.

    vertices  : (V, 3) float - vertex coordinates
    triangles : (F, 3) int   - vertex indices per triangle
    edges     : (E, 2) int   - vertex indices per edge (informational)
    mu0, mu1  : (V,)   float - boundary densities (sum to 1 after loading)
    """

    mu0: np.ndarray
    mu1: np.ndarray
    vertices: np.ndarray
    triangles: np.ndarray
    edges: np.ndarray
    area_triangles: NotRequired[np.ndarray]
    area_vertices: NotRequired[np.ndarray]


class CheckpointDotData(TypedDict, total=False):
    """Solution snapshot taken when the stop error first crosses a tolerance."""

    mu: np.ndarray
    E: np.ndarray
    iteration: int
    time: float
    kkt: list


class SolutionSocpData(TypedDict, total=False):
    """Full primal/dual state of the SOCP formulation.

    Shapes (T = n_time, V vertices, F triangles), matching the reference's
    state initialization (`socp/solver_socp.py:239-264`):
      phi (T+1,V), A (T,V), B (T+1,F,3), lambda_c (T,V),
      z_fst/z_end (T,V), z_mid (T,2,3,F,3), mu (T,V), E (T+1,F,3),
      beta_fst/beta_end (T,V), beta_mid (T,2,3,F,3).
    """

    phi: np.ndarray
    A: np.ndarray
    B: np.ndarray
    lambda_c: np.ndarray
    z_fst: np.ndarray
    z_mid: np.ndarray
    z_end: np.ndarray
    mu: np.ndarray
    E: np.ndarray
    beta_fst: np.ndarray
    beta_mid: np.ndarray
    beta_end: np.ndarray
    checkpoints: NotRequired[list]


class SolutionDotData(TypedDict, total=False):
    """DOT-level solution: transported density and momentum field, and the
    potential phi (T+1, V) where the solver gives one (it carries no area
    weight, so it is the SOCP solution's own)."""

    mu: np.ndarray
    E: np.ndarray
    phi: NotRequired[np.ndarray]
    checkpoints: NotRequired[list]


class CameraConfig(TypedDict, total=False):
    position: list
    focal_point: list
    up: list
    name: Optional[str]


class ErrorVersusExactData(TypedDict):
    l1: float
    l2: float
    linf: float


class CheckpointsErrorData(TypedDict):
    error: ErrorVersusExactData
    kkt_error: float
    iteration: int
    time: float


def translate_solution_socp_to_dot(
    solution_socp: SolutionSocpData, geom: GeometryData
) -> SolutionDotData:
    """Convert SOCP units to DOT units.

    mu picks up the vertex-area weight (area_vertices/3), E the triangle area
    (reference `utils/type.py:48-65`).
    """
    va = np.asarray(geom["area_vertices"])[np.newaxis, :] / 3.0
    ta = np.asarray(geom["area_triangles"])[np.newaxis, :, np.newaxis]

    def _convert(mu, E):
        return np.asarray(mu) * va, np.asarray(E) * ta

    mu_dot, e_dot = _convert(solution_socp["mu"], solution_socp["E"])
    out = SolutionDotData(mu=mu_dot, E=e_dot)
    if solution_socp.get("phi") is not None:
        out["phi"] = np.asarray(solution_socp["phi"])

    if solution_socp.get("checkpoints"):
        converted = []
        for cp in solution_socp["checkpoints"]:
            mu_cp, e_cp = _convert(cp["mu"], cp["E"])
            converted.append(
                CheckpointDotData(
                    mu=mu_cp,
                    E=e_cp,
                    iteration=cp["iteration"],
                    time=cp["time"],
                    kkt=cp["kkt"],
                )
            )
        out["checkpoints"] = converted
    return out
