# The port's own copy of dots_socp_tpu/geometry/normalize.py; only the import paths differ.
"""Geometry normalization: center, scale to the unit box, shift positive.

Parity with reference `socp/data_preprocessing.py:5-44` (same affine map and
returned scale_factor used to de-scale transport costs downstream), without
the trimesh dependency: pure NumPy on the vertex array.
"""

from __future__ import annotations

import numpy as np

from dots_socp_torch.geometry.surface import triangle_quantities, vertex_areas
from dots_socp_torch.utils.types import GeometryData


def normalize_geometry(geometry: GeometryData, camera_config: dict | None = None):
    """Center the mesh at its area-weighted centroid, scale the bounding box
    to unit size, and translate into the positive octant.

    Returns (normalized_geometry, scale_factor) and, if a camera_config is
    given, the camera mapped through the same affine transform.
    """
    vertices = np.asarray(geometry["vertices"], dtype=np.float64)
    triangles = np.asarray(geometry["triangles"])

    # Area-weighted surface centroid (matches trimesh's Trimesh.centroid).
    tri_pts = vertices[triangles]
    tri_centers = tri_pts.mean(axis=1)
    tri_area, _, _ = triangle_quantities(vertices, triangles)
    centroid = (tri_centers * tri_area[:, None]).sum(0) / tri_area.sum()

    offset = -centroid
    moved = vertices + offset
    scale_factor = 1.0 / (moved.max(axis=0) - moved.min(axis=0)).max()
    scaled = moved * scale_factor
    offset2 = -scaled.min(axis=0)
    normalized_vertices = scaled + offset2

    area_triangles, _, _ = triangle_quantities(normalized_vertices, triangles)
    area_v = vertex_areas(triangles, area_triangles, normalized_vertices.shape[0])

    normalized = GeometryData(
        vertices=normalized_vertices,
        triangles=triangles,
        edges=geometry["edges"],
        mu0=geometry["mu0"],
        mu1=geometry["mu1"],
        area_triangles=area_triangles,
        area_vertices=area_v,
    )

    if camera_config is None:
        return normalized, scale_factor

    camera = {
        "position": (np.asarray(camera_config["position"]) + offset) * scale_factor
        + offset2,
        "focal_point": (np.asarray(camera_config["focal_point"]) + offset)
        * scale_factor
        + offset2,
        "up": camera_config["up"],
    }
    return normalized, scale_factor, camera
