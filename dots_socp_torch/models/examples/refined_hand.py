# The port's own copy of dots_socp_tpu/models/examples/refined_hand.py; only the import paths differ.
"""Refined hand: two gaussian blobs (at mesh vertices 5982 and 1347) to a
y-halfspace indicator — distinct from the base `hand` densities
(ref data/settings/refined_hand.py:1-22)."""
import numpy as np


def get_mu(area_vertices, vertices):
    length_scale = 0.1
    d0 = np.linalg.norm(vertices - vertices[5982, :], axis=1) ** 2
    d1 = np.linalg.norm(vertices - vertices[1347, :], axis=1) ** 2
    mu0 = area_vertices * (
        np.exp(-d0 / length_scale**2) + np.exp(-d1 / length_scale**2)
    )
    mu1 = area_vertices * np.where(vertices[:, 1] > 0.4, 1.0, 0.0)
    return mu0, mu1
