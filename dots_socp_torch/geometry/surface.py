# The port's own copy of dots_socp_tpu/geometry/surface.py; only the import paths differ.
"""Vectorized FEM precomputation on a triangulated surface.

Produces the same geometric quantities as the reference's per-triangle Python
loops (`utils/surface_pre_computations_socp.py:11-132`) but fully vectorized,
and in the layouts the TPU operators want:

  * `triangle_quantities`: areas (F,), corner angles (F,3), and P1 hat-basis
    gradients (F,3,3) via the normal-cross-opposite-edge identity
    grad(phi_k) = n x e_opp / (2A)  -- mathematically identical to the
    altitude construction the reference uses.
  * `vertex_areas`: one-ring triangle-area sums (the reference's
    `trianglesToVertices` areaVertices, before its /3).
  * `cotan_laplacian`: scipy CSR cotangent Laplacian (negative semidefinite),
    used host-side to build the dense spectral factor and CG preconditioner.
  * `build_incidence_table`: padded vertex -> (triangle, corner) incidence,
    turning on-device scatter-adds into gather + masked-sum reductions.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def triangle_quantities(vertices: np.ndarray, triangles: np.ndarray):
    """Per-triangle areas, corner angles, and P1 basis gradients.

    Returns
    -------
    area : (F,) float64
    angles : (F, 3) float64  -- angle at corner k
    grad_basis : (F, 3, 3) float64 -- gradient (in R^3, tangent to the
        triangle plane) of the hat function of corner k.
    """
    v = vertices[triangles]  # (F, 3corner, 3coord)
    # Edge k runs from corner (k+1) to corner (k+2): the edge opposite corner k.
    e = v[:, [2, 0, 1], :] - v[:, [1, 2, 0], :]  # (F, 3, 3); e[:,k] opposite corner k

    normal = np.cross(e[:, 1], e[:, 2])  # cross of edges emanating appropriately
    # cross(e1, e2) where e1 = p0-p2, e2 = p1-p0 -> consistent with cross(v01, v12)
    double_area = np.linalg.norm(normal, axis=-1)
    area = 0.5 * double_area

    # Corner angle k = angle between the two edges meeting at corner k,
    # i.e. between -e_{k+1} and e_{k+2} (both emanate from corner k).
    cos_angles = np.empty((triangles.shape[0], 3))
    for k in range(3):
        a = -e[:, (k + 1) % 3]
        b = e[:, (k + 2) % 3]
        cos_angles[:, k] = np.einsum("fc,fc->f", a, b) / (
            np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
        )
    angles = np.arccos(np.clip(cos_angles, -1.0, 1.0))

    # grad(phi_k) = n_hat x e_k / (2 A): perpendicular to the opposite edge,
    # pointing toward corner k, magnitude 1/height_k.
    n_hat = normal / double_area[:, None]
    grad_basis = np.cross(n_hat[:, None, :], e) / double_area[:, None, None]
    return area, angles, grad_basis


def vertex_areas(triangles: np.ndarray, area_triangles: np.ndarray, n_vertices: int):
    """Sum of incident triangle areas per vertex (one-ring area)."""
    av = np.zeros(n_vertices)
    np.add.at(av, triangles.reshape(-1), np.repeat(area_triangles, 3))
    return av


def cotan_laplacian(
    triangles: np.ndarray, angles: np.ndarray, n_vertices: int
) -> sp.csr_matrix:
    """Cotangent Laplacian (V x V, negative semidefinite), CSR.

    Each corner angle theta_k contributes +0.5 cot(theta_k) to the symmetric
    off-diagonal pair of the opposite edge and -0.5 cot(theta_k) to both its
    endpoints' diagonals (reference `surface_pre_computations_socp.py:68-84`).
    Identity used by the matrix-free device path: L = div . (area * grad).
    """
    w = 0.5 / np.tan(angles)  # (F, 3) cotan weights
    f = triangles.shape[0]
    # Opposite edge of corner k connects corners (k+1, k+2).
    i_idx = triangles[:, [1, 2, 0]].reshape(-1)
    j_idx = triangles[:, [2, 0, 1]].reshape(-1)
    vals = w.reshape(-1)

    rows = np.concatenate([i_idx, j_idx, i_idx, j_idx])
    cols = np.concatenate([j_idx, i_idx, i_idx, j_idx])
    data = np.concatenate([vals, vals, -vals, -vals])
    lap = sp.coo_matrix((data, (rows, cols)), shape=(n_vertices, n_vertices))
    return lap.tocsr()


def build_incidence_table(triangles: np.ndarray, n_vertices: int):
    """Padded vertex -> incident (triangle, corner) table.

    For each vertex v, lists the flat indices ``f*3 + k`` of all corner slots
    (f, k) with triangles[f, k] == v, padded to the max vertex degree.

    Returns
    -------
    table : (V, D) int32 -- flat corner-slot indices (0 where padded)
    mask  : (V, D) float64 -- 1.0 for valid entries, 0.0 for padding

    On device, a vertex reduction of corner-slot data x (..., F, 3) becomes
    ``(x.reshape(..., 3F)[..., table] * mask).sum(-1)`` -- a gather + masked
    sum, which maps to the VPU far better than a scatter-add.
    """
    flat_v = triangles.reshape(-1)  # vertex id of slot f*3+k
    order = np.argsort(flat_v, kind="stable")
    sorted_v = flat_v[order]
    counts = np.bincount(flat_v, minlength=n_vertices)
    max_deg = int(counts.max()) if counts.size else 0

    table = np.zeros((n_vertices, max_deg), dtype=np.int32)
    mask = np.zeros((n_vertices, max_deg), dtype=np.float64)
    # Position of each sorted slot within its vertex's run.
    starts = np.zeros(n_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(flat_v.size) - starts[sorted_v]
    table[sorted_v, within] = order.astype(np.int32)
    mask[sorted_v, within] = 1.0
    return table, mask
