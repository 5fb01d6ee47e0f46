# The port's own copy of dots_socp_tpu/models/examples/bunny.py; only the import paths differ.
"""Bunny: body indicator to an ear band (ref data/settings/bunny.py)."""
import numpy as np

from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    x, y = vertices[:, 0], vertices[:, 1]
    mu0 = area_vertices * np.where(x > 0.03, 1.0, 0.0)
    mu1 = (
        area_vertices
        * cut_off(-y + 0.3, 0.5)
        * np.where(x < -0.06, 1.0, 0.0)
        * np.where(y < 0.11, 1.0, 0.0)
        * np.where(y > 0.05, 1.0, 0.0)
    )
    return mu0, mu1
