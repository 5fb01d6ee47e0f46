# The port's own copy of dots_socp_tpu/models/examples/hand.py; only the import paths differ.
"""Hand: y-halfspace indicators (ref data/settings/hand.py)."""
import numpy as np


def get_mu(area_vertices, vertices):
    mu0 = area_vertices * np.where(vertices[:, 1] < -0.5, 1.0, 0.0)
    mu1 = area_vertices * np.where(vertices[:, 1] > 0.4, 1.0, 0.0)
    return mu0, mu1
