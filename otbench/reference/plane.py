"""The upstream plane example, frozen: mesh, normalisation and gaussian pair.

A copy of the hexagonal-lattice triangulation of the unit square of
chlhnu/DOTs-SOCP `data/meshes/plane.py` (same vertex order and triangles),
of the normalisation its `main` applies to every mesh (centre at the
area-weighted centroid, scale the bounding box to unit size, shift into the
positive octant), and of the densities of `data/settings/plane.py`: isotropic
gaussians exp(-|v - c|^2 / scale) times the one-ring vertex area, each
normalised to mass 1. Only the centres are parameters here; the traffic mix
draws them. Plain NumPy: the benchmark hands the same arrays to the program
and to the reference checks, and later changes to the program do not move
them.
"""

from __future__ import annotations

import numpy as np


def plane_mesh(n: int):
    """(vertices (V, 3), triangles (F, 3) int64, edges (E, 2) int64) of the
    plane at resolution n, before normalisation."""
    dx = 1.0 / n
    dy = dx * np.sqrt(3.0) / 2.0
    n_rows = int(1.0 / dy) + 1
    n_cols = n + 1
    rows = np.arange(n_rows)
    cols = np.arange(n_cols)
    xx = cols[None, :] * dx + (rows[:, None] % 2) * (dx / 2.0)
    yy = np.broadcast_to(rows[:, None] * dy, (n_rows, n_cols))
    vertices = np.stack([xx.reshape(-1), yy.reshape(-1), np.zeros(n_rows * n_cols)], axis=-1)

    def vid(i, j):
        return i * n_cols + j

    triangles = []
    for i in range(n_rows - 1):
        for j in range(n_cols - 1):
            if i % 2 == 0:
                triangles.append([vid(i, j), vid(i, j + 1), vid(i + 1, j)])
                triangles.append([vid(i, j + 1), vid(i + 1, j + 1), vid(i + 1, j)])
            else:
                triangles.append([vid(i, j), vid(i + 1, j + 1), vid(i + 1, j)])
                if j > 0:
                    triangles.append([vid(i, j - 1), vid(i, j), vid(i + 1, j)])
    triangles = np.asarray(triangles, dtype=np.int64)
    pairs = np.concatenate([triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]])
    edges = np.unique(np.sort(pairs, axis=1), axis=0)
    return vertices, triangles, edges


def triangle_areas(vertices, triangles):
    p = vertices[triangles]
    return 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)


def one_ring_areas(triangles, area_f, n_vertices):
    """Sum of the incident triangles' areas per vertex."""
    out = np.zeros(n_vertices)
    np.add.at(out, triangles.reshape(-1), np.repeat(area_f, 3))
    return out


def normalise(vertices, triangles):
    """`main`'s affine map: area-weighted centroid to the origin, the
    bounding box's longest side to 1, then into the positive octant."""
    area = triangle_areas(vertices, triangles)
    centroid = (vertices[triangles].mean(axis=1) * area[:, None]).sum(0) / area.sum()
    moved = vertices - centroid
    scaled = moved / (moved.max(axis=0) - moved.min(axis=0)).max()
    return scaled - scaled.min(axis=0)


def geometry(n: int) -> dict:
    """The normalised plane at resolution n with its areas, as the program's
    `solver(n_time, geometry)` takes it (densities added per problem)."""
    vertices, triangles, edges = plane_mesh(n)
    vertices = normalise(vertices, triangles)
    area_f = triangle_areas(vertices, triangles)
    return {"vertices": vertices, "triangles": triangles, "edges": edges,
            "area_triangles": area_f,
            "area_vertices": one_ring_areas(triangles, area_f, vertices.shape[0])}


def gaussian_mass(geom: dict, center, scale: float) -> np.ndarray:
    """area_vertices * exp(-|v - center|^2 / scale), normalised to mass 1."""
    d2 = np.linalg.norm(geom["vertices"] - np.asarray(center, dtype=float), axis=-1) ** 2
    mass = geom["area_vertices"] * np.exp(-d2 / scale)
    return mass / mass.sum()
