# The port's own copy of dots_socp_tpu/geometry/generators.py; only the import paths differ.
"""Procedural mesh generators.

`generate_plane_mesh` produces the same hexagonal-lattice triangulation of
the unit square as the reference's `data/meshes/plane.py:3-68` (same vertex
ordering and triangle connectivity so μ settings and exact-transport tests
are directly comparable), implemented vectorized.

The remaining generators (icosphere, torus, torus-knot tube, hills
height-field, punctured sphere) are SURROGATES for the reference's
benchmark `.off` meshes, which ship as git-LFS pointers and are absent
from the snapshot (reference `.MISSING_LARGE_BLOBS`): they let every
predefined example and the full replication sweep run end-to-end on
procedurally generated geometry of matching topology. They are not the
published meshes; results on them are self-consistent but not comparable
to numbers produced on the real blobs.
"""

from __future__ import annotations

import numpy as np


def _edges_of(triangles: np.ndarray) -> np.ndarray:
    pairs = np.concatenate(
        [triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]], axis=0
    )
    return np.unique(np.sort(pairs, axis=1), axis=0)


def _closed_grid_triangles(n_u: int, n_v: int) -> np.ndarray:
    """Triangulate an (n_u, n_v) parameter grid that wraps in both
    directions (torus topology). Vertex (i, j) has index i * n_v + j."""
    i = np.arange(n_u)[:, None]
    j = np.arange(n_v)[None, :]
    v00 = (i * n_v + j).reshape(-1)
    v10 = (((i + 1) % n_u) * n_v + j).reshape(-1)
    v01 = (i * n_v + (j + 1) % n_v).reshape(-1)
    v11 = (((i + 1) % n_u) * n_v + (j + 1) % n_v).reshape(-1)
    tri = np.concatenate(
        [np.stack([v00, v10, v11], axis=1), np.stack([v00, v11, v01], axis=1)],
        axis=0,
    )
    return tri.astype(np.int64)


def generate_plane_mesh(n: int = 50):
    """Regular triangular mesh on [0,1]^2 built from staggered rows.

    Rows are spaced dy = dx*sqrt(3)/2 apart; odd rows are shifted by dx/2,
    so each interior cell splits into two near-equilateral triangles.

    Returns (vertices (N,3), triangles (M,3), edges (K,2)).
    """
    dx = 1.0 / n
    dy = dx * np.sqrt(3.0) / 2.0
    n_rows = int(1.0 / dy) + 1
    n_cols = n + 1

    rows = np.arange(n_rows)
    cols = np.arange(n_cols)
    xx = cols[None, :] * dx + (rows[:, None] % 2) * (dx / 2.0)
    yy = np.broadcast_to(rows[:, None] * dy, (n_rows, n_cols))
    vertices = np.stack(
        [xx.reshape(-1), yy.reshape(-1), np.zeros(n_rows * n_cols)], axis=-1
    )

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

    edge_pairs = np.concatenate(
        [triangles[:, [0, 1]], triangles[:, [1, 2]], triangles[:, [2, 0]]], axis=0
    )
    edges = np.unique(np.sort(edge_pairs, axis=1), axis=0)
    return vertices, triangles, edges


def generate_mesh(n: int = 50):
    """Alias so this module can be used as a .py mesh file via read_mesh."""
    return generate_plane_mesh(n=n)


def generate_sphere_mesh(
    n_subdiv: int = 4, radius: float = 1.0, center=(0.0, 0.0, 0.0)
):
    """Icosphere: icosahedron subdivided `n_subdiv` times, vertices pushed to
    the sphere of `radius` around `center`. V = 10 * 4^n + 2."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )

    for _ in range(n_subdiv):
        vlist = list(verts)
        midpoint = {}

        def mid(a, b):
            key = (a, b) if a < b else (b, a)
            idx = midpoint.get(key)
            if idx is None:
                p = vlist[a] + vlist[b]
                p = p / np.linalg.norm(p)
                idx = len(vlist)
                vlist.append(p)
                midpoint[key] = idx
            return idx

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)

    vertices = radius * verts + np.asarray(center, dtype=np.float64)
    return vertices, faces, _edges_of(faces)


def generate_punctured_sphere_mesh(
    n_subdiv: int = 4,
    radius: float = 1.0,
    center=(0.0, 0.0, 0.0),
    cap: float = 0.85,
):
    """Icosphere with the polar cap (unit-sphere z > cap) removed: an open
    surface with one boundary loop, the topology of the reference's
    `sphere_puncture.off` / `punctured_ball.off` meshes."""
    vertices, faces, _ = generate_sphere_mesh(n_subdiv, radius=1.0)
    centroid_z = vertices[faces, 2].mean(axis=1)
    faces = faces[centroid_z <= cap]
    used = np.unique(faces)
    remap = np.full(vertices.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    vertices = radius * vertices[used] + np.asarray(center, dtype=np.float64)
    faces = remap[faces]
    return vertices, faces, _edges_of(faces)


def generate_torus_mesh(
    n_u: int = 64, n_v: int = 48, big_radius: float = 0.7, small_radius: float = 0.3
):
    """Torus of revolution around the z axis; spans [-(R+r), R+r] in x, y."""
    u = 2.0 * np.pi * np.arange(n_u) / n_u
    v = 2.0 * np.pi * np.arange(n_v) / n_v
    ring = big_radius + small_radius * np.cos(v)[None, :]
    x = ring * np.cos(u)[:, None]
    y = ring * np.sin(u)[:, None]
    z = np.broadcast_to(small_radius * np.sin(v)[None, :], x.shape)
    vertices = np.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=-1)
    triangles = _closed_grid_triangles(n_u, n_v)
    return vertices, triangles, _edges_of(triangles)


def generate_knot_mesh(
    p: int = 2,
    q: int = 3,
    n_u: int = 160,
    n_v: int = 21,
    big_radius: float = 0.6,
    small_radius: float = 0.35,
    tube_radius: float = 0.12,
):
    """Tube of radius `tube_radius` around a (p, q) torus knot, framed by
    parallel transport along the curve (so the tube does not spin). The
    trefoil is (2, 3); the cinquefoil of the reference's knots_5 is (2, 5)."""
    t = 2.0 * np.pi * np.arange(n_u) / n_u
    ring = big_radius + small_radius * np.cos(q * t)
    curve = np.stack(
        [ring * np.cos(p * t), ring * np.sin(p * t), small_radius * np.sin(q * t)],
        axis=-1,
    )

    tangent = np.roll(curve, -1, axis=0) - np.roll(curve, 1, axis=0)
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)

    # Parallel-transport an initial normal along the closed curve.
    normal = np.zeros_like(curve)
    seed = np.array([0.0, 0.0, 1.0])
    if abs(seed @ tangent[0]) > 0.9:
        seed = np.array([1.0, 0.0, 0.0])
    n = seed - (seed @ tangent[0]) * tangent[0]
    normal[0] = n / np.linalg.norm(n)
    for i in range(1, n_u):
        n = normal[i - 1] - (normal[i - 1] @ tangent[i]) * tangent[i]
        normal[i] = n / np.linalg.norm(n)
    binormal = np.cross(tangent, normal)

    theta = 2.0 * np.pi * np.arange(n_v) / n_v
    offsets = (
        np.cos(theta)[None, :, None] * normal[:, None, :]
        + np.sin(theta)[None, :, None] * binormal[:, None, :]
    )
    vertices = (curve[:, None, :] + tube_radius * offsets).reshape(-1, 3)
    triangles = _closed_grid_triangles(n_u, n_v)
    return vertices, triangles, _edges_of(triangles)


def generate_hills_mesh(n: int = 80, n_bumps: int = 4, height: float = 0.25):
    """Plane mesh displaced by deterministic gaussian bumps: a height-field
    surface standing in for the reference's `hills.off`."""
    vertices, triangles, edges = generate_plane_mesh(n=n)
    centers = np.array(
        [[0.25, 0.3], [0.7, 0.25], [0.35, 0.75], [0.75, 0.7], [0.5, 0.5]]
    )[:n_bumps]
    widths = np.array([0.12, 0.1, 0.14, 0.11, 0.09])[:n_bumps]
    z = np.zeros(vertices.shape[0])
    for c, w in zip(centers, widths):
        d2 = (vertices[:, 0] - c[0]) ** 2 + (vertices[:, 1] - c[1]) ** 2
        z += height * np.exp(-d2 / w**2)
    vertices = vertices.copy()
    vertices[:, 2] = z
    return vertices, triangles, edges
