# The port's own copy of dots_socp_tpu/geometry/__init__.py; only the import paths differ.
"""Host-side geometry kernel: mesh IO, FEM precomputation, normalization.

Runs once per problem on the host (NumPy; optional C++ fast path) and emits
the static arrays the device operators consume: triangle corner indices,
P1 basis gradients, areas, incidence tables, and the assembled cotangent
Laplacian (for the spectral factorization path).
"""

from dots_socp_torch.geometry.mesh_io import read_mesh, read_mesh_off
from dots_socp_torch.geometry.surface import (
    triangle_quantities,
    vertex_areas,
    cotan_laplacian,
    build_incidence_table,
)
from dots_socp_torch.geometry.normalize import normalize_geometry
from dots_socp_torch.geometry.generators import generate_plane_mesh

__all__ = [
    "read_mesh",
    "read_mesh_off",
    "triangle_quantities",
    "vertex_areas",
    "cotan_laplacian",
    "build_incidence_table",
    "normalize_geometry",
    "generate_plane_mesh",
]
