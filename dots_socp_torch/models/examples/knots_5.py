# The port's own copy of dots_socp_tpu/models/examples/knots_5.py; only the import paths differ.
"""Cinquefoil knot: gaussian source to two masked sinks (ref data/settings/knots_5.py)."""
import numpy as np

from dots_socp_torch.models.density import gaussian, radial_mask


def get_mu(area_vertices, vertices):
    center0 = vertices[2786, :]
    center1 = vertices[1232, :]
    center2 = vertices[406, :]
    mu0 = area_vertices * radial_mask(vertices, center0, 0.5) * gaussian(
        vertices, center0, 0.5
    )
    mu1 = area_vertices * (
        radial_mask(vertices, center1, 0.5) * gaussian(vertices, center1, 0.5)
        + radial_mask(vertices, center2, 0.5) * gaussian(vertices, center2, 0.5)
    )
    return mu0, mu1
