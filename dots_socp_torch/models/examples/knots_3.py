# The port's own copy of dots_socp_tpu/models/examples/knots_3.py; only the import paths differ.
"""Trefoil knot: one masked gaussian source to two masked gaussian sinks
at fixed world-space centers (ref data/settings/knots_3.py:1-21)."""
import numpy as np

from dots_socp_torch.models.density import gaussian, radial_mask


def get_mu(area_vertices, vertices):
    center0 = np.array([0.0888, 1.282, 0.512])
    center11 = np.array([-1.035, -1.087, 0.300])
    center12 = np.array([1.212, -0.594, 0.455])
    mu0 = area_vertices * radial_mask(vertices, center0, 0.5) * gaussian(
        vertices, center0, 0.3
    )
    mu1 = area_vertices * (
        radial_mask(vertices, center11, 0.3) * gaussian(vertices, center11, 0.3)
        + radial_mask(vertices, center12, 0.3) * gaussian(vertices, center12, 0.3)
    )
    return mu0, mu1
