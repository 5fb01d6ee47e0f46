# The port's own copy of dots_socp_tpu/models/registry.py; only the import paths differ.
"""Example registry: name -> (mesh file, settings module).

Parity with the reference's `data/load_example.py:227-322` match table,
including dynamic fallback for setting modules that exist on disk but are
not listed here.
"""

from __future__ import annotations

import warnings
from pathlib import Path

from dots_socp_torch.config import PATHS
import dots_socp_torch.models.examples as settings

# name -> (mesh file name, settings module)
_EXAMPLES = {
    # examples from lavenant-2021 (https://doi.org/10.1145/3272127.3275064)
    "airplane": ("airplane_62.off", settings.airplane),
    "armadillo": ("armadillo.off", settings.armadillo),
    "square_regular": ("square_regular_100.off", settings.square_regular),
    "face": ("face_vector_field_319.off", settings.face),
    "hand": ("hand_3k.off", settings.hand),
    "sphere": ("sphere_puncture.off", settings.sphere),
    # newly defined examples
    "punctured_ball": ("punctured_ball.off", settings.punctured_ball),
    "bunny": ("bunny.off", settings.bunny),
    "ring": ("ring.off", settings.ring),
    "eight": ("eight.off", settings.eight),
    "audi": ("audi.off", settings.audi),
    "knots_3": ("knots_3.off", settings.knots_3),
    "knots_5": ("knots_5.off", settings.knots_5),
    "hills": ("hills.off", settings.hills),
    "robot": ("robot.off", settings.robot),
    "plane": ("plane.off", settings.plane),  # .py generator when is_pymesh
    # refined variants
    "refined_airplane": ("refined_airplane_62.off", settings.refined_airplane),
    "refined_armadillo": ("refined_armadillo.off", settings.refined_armadillo),
    "refined_face": ("refined_face_vector_field_319.off", settings.refined_face),
    "refined_hand": ("refined_hand_3k.off", settings.refined_hand),
    "refined_punctured_ball": (
        "refined_punctured_ball.off",
        settings.refined_punctured_ball,
    ),
    "refined_bunny": ("refined_bunny.off", settings.refined_bunny),
}

EXAMPLE_NAMES = sorted(_EXAMPLES)

# Examples whose mesh can be generated procedurally (no .off blob needed).
_GENERATED = {"plane": "plane_generator.py"}

# Procedural SURROGATE geometry per example, used (with a loud warning) when
# the real .off blob is absent -- the reference ships its meshes as git-LFS
# pointers, so a bare checkout cannot run any named example. Surrogates
# approximate the real mesh's topology (sphere-like, torus, knot tube, height
# field; 'eight' is genus-2 but gets a genus-1 torus) and are sized so every
# vertex index referenced by the example's density settings exists. Results
# are self-consistent, not comparable to the blobs.
_SURROGATES = {
    "airplane": ("generate_sphere_mesh", {"n_subdiv": 4}),
    "refined_airplane": ("generate_sphere_mesh", {"n_subdiv": 5}),
    "armadillo": ("generate_sphere_mesh", {"n_subdiv": 4}),
    "refined_armadillo": ("generate_sphere_mesh", {"n_subdiv": 5}),
    "bunny": ("generate_sphere_mesh", {"n_subdiv": 4}),
    "refined_bunny": ("generate_sphere_mesh", {"n_subdiv": 5}),
    "hand": ("generate_sphere_mesh", {"n_subdiv": 4}),
    "refined_hand": ("generate_sphere_mesh", {"n_subdiv": 5}),
    # face settings index vertices up to 4492.
    "face": ("generate_sphere_mesh", {"n_subdiv": 5}),
    "refined_face": ("generate_sphere_mesh", {"n_subdiv": 5}),
    "robot": ("generate_sphere_mesh", {"n_subdiv": 4}),
    # audi's density boxes sit at radius ~1.0-1.4 in the blob's frame.
    "audi": ("generate_sphere_mesh", {"n_subdiv": 4, "radius": 1.39}),
    "sphere": ("generate_punctured_sphere_mesh", {"n_subdiv": 4}),
    "punctured_ball": (
        "generate_punctured_sphere_mesh",
        {"n_subdiv": 4, "radius": 0.55, "center": (0.5, 0.5, 0.5)},
    ),
    "refined_punctured_ball": (
        "generate_punctured_sphere_mesh",
        {"n_subdiv": 5, "radius": 0.55, "center": (0.5, 0.5, 0.5)},
    ),
    "ring": ("generate_torus_mesh", {"n_u": 64, "n_v": 48}),
    "eight": ("generate_torus_mesh", {"n_u": 64, "n_v": 48}),
    "knots_3": ("generate_knot_mesh", {"p": 2, "q": 3}),
    # knots_5 settings index vertices up to 2786.
    "knots_5": ("generate_knot_mesh", {"p": 2, "q": 5, "n_u": 160, "n_v": 21}),
    # hills settings index vertices up to 9505; n=100 gives V=11716.
    "hills": ("generate_hills_mesh", {"n": 100}),
    "square_regular": ("generate_plane_mesh", {"n": 100}),
}


def match_example(name: str, is_pymesh: bool = False):
    """Resolve an example name to (mesh_path_or_spec, settings_module).

    Generated meshes (plane) return the generator module path when
    `is_pymesh` or when the .off blob is absent; other examples whose .off
    blob is absent fall back to their procedural surrogate (warning).
    """
    mesh_dir = Path(PATHS["mesh_dir"])

    if name in _EXAMPLES:
        mesh_name, setting = _EXAMPLES[name]
        mesh_path = mesh_dir / mesh_name
        if name in _GENERATED and (is_pymesh or not mesh_path.exists()):
            # Use the in-package procedural generator.
            from dots_socp_torch.geometry import generators

            mesh_path = Path(generators.__file__)
        elif not mesh_path.exists() and name in _SURROGATES:
            from dots_socp_torch.geometry.mesh_io import GeneratedMesh

            generator, kwargs = _SURROGATES[name]
            warnings.warn(
                f"Mesh file {mesh_path} is absent (the reference distributes "
                f"its meshes via git-LFS); running {name!r} on a procedural "
                f"SURROGATE ({generator}{kwargs}). Results are well-defined "
                f"but not comparable to the published meshes."
            )
            return GeneratedMesh(generator, kwargs, surrogate_for=name), setting
        return mesh_path, setting

    # Dynamic fallback: any settings module shipped but not registered.
    if hasattr(settings, name):
        warnings.warn(
            f"Example {name!r} loaded dynamically: it has a settings module "
            f"but is not listed in the registry."
        )
        return mesh_dir / f"{name}.off", getattr(settings, name)

    raise ValueError(
        f"Unknown example {name!r}. Valid names: {', '.join(EXAMPLE_NAMES)}"
    )
