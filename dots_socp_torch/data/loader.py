# The port's own copy of dots_socp_tpu/data/loader.py; only the import paths differ.
"""Example loading: predefined registry or custom (mesh file + settings file).

Parity with reference `data/load_example.py:22-210`: the same two loading
modes, mu normalization, camera lookup and exact-transport loading, with the
camera table stored in `models.cameras` instead of per-example JSON files.
"""

from __future__ import annotations

import warnings
from importlib.util import module_from_spec, spec_from_file_location
from pathlib import Path

import numpy as np

from dots_socp_torch.geometry.mesh_io import read_mesh
from dots_socp_torch.geometry.surface import triangle_quantities, vertex_areas
from dots_socp_torch.models.cameras import get_camera
from dots_socp_torch.models.registry import match_example
from dots_socp_torch.utils.types import GeometryData


def load_module_dynamically(path_to_module):
    path = Path(path_to_module)
    spec = spec_from_file_location(path.stem, str(path))
    module = module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_custom_example(mesh_filename, setting_filename):
    if Path(mesh_filename).suffix != ".off":
        raise FileExistsError("custom mesh file must be a .off file")
    setting = load_module_dynamically(setting_filename)
    if not hasattr(setting, "get_mu"):
        raise FileExistsError(
            "custom setting file must define get_mu(area_vertices, vertices)"
        )
    return setting


def load_example_file(
    example_name: str = None,
    path_to_mesh_file: str = None,
    path_to_setting_file: str = None,
    is_pymesh: bool = False,
):
    """Resolve (example_id, mesh_file, settings module) from either a
    predefined name or a custom mesh/setting file pair."""
    predefined = example_name is not None
    custom = path_to_mesh_file is not None and path_to_setting_file is not None

    if predefined and custom:
        raise ValueError(
            "choose either a predefined example_name or a custom "
            "mesh/setting file pair, not both"
        )
    if not predefined and not custom:
        raise ValueError(
            "provide example_name, or both mesh_file (.off) and "
            "setting_file (.py)"
        )

    if predefined:
        mesh_file, setting = match_example(example_name, is_pymesh=is_pymesh)
        return example_name, mesh_file, setting

    setting = check_custom_example(path_to_mesh_file, path_to_setting_file)
    example_id = (
        f"{Path(path_to_mesh_file).name}-{Path(path_to_setting_file).name}"
    ).replace(".", "_")
    return example_id, path_to_mesh_file, setting


def _fallback_mu(area_v: np.ndarray, vertices: np.ndarray):
    """Well-posed default densities: gaussian bumps at the two extremal
    vertices along the widest coordinate axis."""
    from dots_socp_torch.models.density import gaussian

    span = vertices.max(axis=0) - vertices.min(axis=0)
    axis = int(np.argmax(span))
    c0 = vertices[int(np.argmin(vertices[:, axis]))]
    c1 = vertices[int(np.argmax(vertices[:, axis]))]
    scale = (0.25 * float(span[axis])) ** 2
    mu0 = area_v * gaussian(vertices, c0, scale)
    mu1 = area_v * gaussian(vertices, c1, scale)
    return mu0, mu1


def _load_geometry(mesh_file, kwargs_generating_mesh):
    vertices, triangles, edges = read_mesh(
        mesh_file, kwargs_generating_mesh=kwargs_generating_mesh
    )
    area_triangles, _, _ = triangle_quantities(vertices, triangles)
    area_v = vertex_areas(triangles, area_triangles, vertices.shape[0])
    return vertices, triangles, edges, area_triangles, area_v


def load_example(
    example_name: str = None,
    path_to_mesh_file: str = None,
    path_to_setting_file: str = None,
    kwargs_generating_mesh: dict = None,
):
    """Load an example: geometry + normalized boundary densities + camera.

    Returns (example_id, GeometryData, camera_config).
    """
    kwargs_generating_mesh = kwargs_generating_mesh or {}
    is_pymesh = isinstance(kwargs_generating_mesh.get("n"), int)

    example_id, mesh_file, setting = load_example_file(
        example_name, path_to_mesh_file, path_to_setting_file, is_pymesh=is_pymesh
    )
    vertices, triangles, edges, area_triangles, area_v = _load_geometry(
        mesh_file, kwargs_generating_mesh
    )
    from dots_socp_torch.geometry.mesh_io import GeneratedMesh

    is_surrogate = (
        isinstance(mesh_file, GeneratedMesh) and mesh_file.surrogate_for is not None
    )
    try:
        mu0, mu1 = setting.get_mu(area_v, vertices)
        mu0 = np.asarray(mu0, dtype=np.float64)
        mu1 = np.asarray(mu1, dtype=np.float64)
        if mu0.shape != area_v.shape or mu1.shape != area_v.shape:
            raise ValueError(
                f"get_mu returned shapes {mu0.shape}/{mu1.shape} for "
                f"{area_v.shape[0]} vertices"
            )
        degenerate = not (
            np.isfinite(mu0).all()
            and np.isfinite(mu1).all()
            and mu0.sum() > 1e-12
            and mu1.sum() > 1e-12
        )
        if degenerate and not is_surrogate:
            raise ValueError(f"degenerate boundary densities for {example_id!r}")
    except Exception as exc:
        # On a surrogate mesh the example's densities may be tied to the real
        # blob (vertex indices, measured data, coordinate frames); substitute
        # a well-posed transport between two well-separated bumps so the
        # example still runs end-to-end.
        if not is_surrogate:
            raise
        warnings.warn(
            f"Example {example_id!r}'s densities are undefined on the "
            f"surrogate mesh ({exc}); substituting a gaussian pair at the "
            f"surface's extremal points."
        )
        mu0, mu1 = _fallback_mu(area_v, vertices)
        degenerate = False
    if degenerate:
        warnings.warn(
            f"Example {example_id!r}'s densities are degenerate on the "
            f"surrogate mesh; substituting a gaussian pair at the surface's "
            f"extremal points."
        )
        mu0, mu1 = _fallback_mu(area_v, vertices)
    mu0 /= mu0.sum()
    mu1 /= mu1.sum()

    geometry = GeometryData(
        vertices=vertices,
        triangles=triangles,
        edges=edges,
        mu0=mu0,
        mu1=mu1,
        area_triangles=area_triangles,
        area_vertices=area_v,
    )
    return example_id, geometry, get_camera(example_id)


def load_exact_transportation(
    t_array: np.ndarray,
    example_name: str = None,
    path_to_mesh_file: str = None,
    path_to_setting_file: str = None,
    kwargs_generating_mesh: dict = None,
):
    """Closed-form transport path for examples that define one (plane)."""
    kwargs_generating_mesh = kwargs_generating_mesh or {}
    is_pymesh = isinstance(kwargs_generating_mesh.get("n"), int)

    example_id, mesh_file, setting = load_example_file(
        example_name, path_to_mesh_file, path_to_setting_file, is_pymesh=is_pymesh
    )
    if not hasattr(setting, "get_exact_transportation"):
        raise ValueError(
            "the setting module must define get_exact_transportation(...)"
        )
    vertices, triangles, edges, _, area_v = _load_geometry(
        mesh_file, kwargs_generating_mesh
    )
    exact = setting.get_exact_transportation(np.asarray(t_array), vertices, area_v)

    scale0 = exact[0].sum()
    scale1 = exact[-1].sum()
    exact = exact / (0.5 * (scale0 + scale1))
    if abs(scale0 - scale1) > 1e-4:
        warnings.warn(
            f"large mass mismatch between endpoints: mu0 scale {scale0}, "
            f"mu1 scale {scale1}"
        )
    return example_id, exact
