# The port's own copy of dots_socp_tpu/geometry/mesh_io.py; only the import paths differ.
"""Mesh loading: .off files and procedural .py generator modules.

Functional parity with reference `data/util.py:29-144` (same two formats,
same returned (vertices, triangles, edges) contract), implemented as a
vectorized parser instead of a per-line Python loop.
"""

from __future__ import annotations

from importlib.util import module_from_spec, spec_from_file_location
from pathlib import Path
from typing import NamedTuple

import numpy as np


class GeneratedMesh(NamedTuple):
    """A mesh produced by a named generator in `geometry.generators` instead
    of a file. `surrogate_for` names the benchmark example this stands in
    for when its .off blob is absent (None for first-class generated meshes
    like plane)."""

    generator: str
    kwargs: dict
    surrogate_for: str | None = None

    def generate(self, user_kwargs: dict | None = None):
        from dots_socp_torch.geometry import generators

        kwargs = dict(self.kwargs)
        # plane-style size kwargs from the CLI override the defaults when
        # the generator accepts them.
        fn = getattr(generators, self.generator)
        import inspect

        accepted = set(inspect.signature(fn).parameters)
        for key, val in (user_kwargs or {}).items():
            if val is not None and key in accepted:
                kwargs[key] = val
        return fn(**kwargs)


def read_mesh(name_file, kwargs_generating_mesh: dict | None = None):
    """Load a mesh from an .off file, a .py generator module, or a
    `GeneratedMesh` spec.

    A generator module must define ``generate_mesh(**kwargs)`` returning
    (vertices, triangles, edges).
    """
    if isinstance(name_file, GeneratedMesh):
        return name_file.generate(kwargs_generating_mesh)
    path = Path(name_file)
    ext = path.suffix
    if ext == ".off":
        return read_mesh_off(path)
    if ext == ".py":
        spec = spec_from_file_location(path.stem, str(path))
        module = module_from_spec(spec)
        spec.loader.exec_module(module)
        if not hasattr(module, "generate_mesh"):
            raise ValueError("mesh generator module must define generate_mesh()")
        kwargs = {
            k: v for k, v in (kwargs_generating_mesh or {}).items() if v is not None
        }
        return module.generate_mesh(**kwargs)
    raise ValueError(f"unsupported mesh file format: {ext}")


def read_mesh_off(name_file):
    """Parse an OFF mesh. Returns (vertices (V,3) f64, triangles (F,3) i64,
    edges (3F,2) i64).

    Uses the native C++ parser (`native/geom_kernels.cpp`) when available
    (mmap + manual scan, ~10x the vectorized NumPy path on multi-MB
    meshes), with this NumPy implementation as the fallback."""
    path = Path(name_file)

    from dots_socp_torch.geometry.native import parse_off_native

    parsed = parse_off_native(path)
    if parsed is not None:
        vertices, triangles = parsed
        triangles = triangles.astype(np.int64)
        edges = np.stack(
            [
                triangles[:, [0, 1]],
                triangles[:, [1, 2]],
                triangles[:, [2, 0]],
            ],
            axis=1,
        ).reshape(-1, 2)
        return vertices, triangles, edges

    with open(path, "r") as f:
        header = f.readline().strip()
        if header != "OFF":
            raise ValueError(f"{path}: not a valid OFF file (header {header!r})")
        counts = f.readline().split()
        if len(counts) < 2:
            raise ValueError(f"{path}: missing vertex/face counts")
        n_vertices, n_triangles = int(counts[0]), int(counts[1])
        body = f.read().split()

    numbers = np.asarray(body, dtype=np.float64)
    n_vertex_numbers = 3 * n_vertices
    n_face_numbers = 4 * n_triangles
    if numbers.size < n_vertex_numbers + n_face_numbers:
        raise ValueError(
            f"{path}: expected {n_vertices} vertices and {n_triangles} faces, "
            f"file too short"
        )

    vertices = numbers[:n_vertex_numbers].reshape(n_vertices, 3)
    faces = (
        numbers[n_vertex_numbers : n_vertex_numbers + n_face_numbers]
        .reshape(n_triangles, 4)
        .astype(np.int64)
    )
    if not np.all(faces[:, 0] == 3):
        raise ValueError(f"{path}: only triangle faces are supported")
    triangles = faces[:, 1:]

    edges = np.stack(
        [
            triangles[:, [0, 1]],
            triangles[:, [1, 2]],
            triangles[:, [2, 0]],
        ],
        axis=1,
    ).reshape(-1, 2)
    return vertices, triangles, edges
