# The port's own copy of dots_socp_tpu/models/examples/__init__.py; only the import paths differ.
"""Predefined example settings: boundary densities per example.

Each module defines ``get_mu(area_vertices, vertices) -> (mu0, mu1)``
(vectorized); `plane` additionally defines ``get_exact_transportation``.
Density formulas match the reference's `data/settings/*.py` under the same
names; `tests/test_examples_golden.py` asserts per-example parity against
the reference settings modules, so solutions are directly comparable.
"""

from dots_socp_torch.models.examples import (
    airplane,
    armadillo,
    audi,
    bunny,
    default,
    eight,
    face,
    hand,
    hills,
    knots_3,
    knots_5,
    plane,
    punctured_ball,
    refined_airplane,
    refined_armadillo,
    refined_bunny,
    refined_face,
    refined_hand,
    refined_punctured_ball,
    ring,
    robot,
    sphere,
    square_regular,
)

__all__ = [
    "airplane", "armadillo", "audi", "bunny", "default", "eight", "face", "hand",
    "hills", "knots_3", "knots_5", "plane", "punctured_ball",
    "refined_airplane", "refined_armadillo", "refined_bunny", "refined_face",
    "refined_hand", "refined_punctured_ball", "ring", "robot", "sphere",
    "square_regular",
]
