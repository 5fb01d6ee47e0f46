# The port's own copy of dots_socp_tpu/models/examples/refined_face.py; only the import paths differ.
"""Refined face: five gaussian sinks variant (ref data/settings/refined_face.py)."""
import numpy as np

from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    length_scale = 0.1
    centers = [vertices[i, :] for i in (10129, 9458, 11792, 12638, 3146)]

    alpha = 0.1 * vertices[:, 0] + vertices[:, 1]
    beta = -vertices[:, 0] + 0.1 * vertices[:, 1]
    gamma = vertices[:, 2]
    patch = (
        cut_off(-0.2 - alpha, 0.3)
        * cut_off(alpha - 0.15, 0.3)
        * cut_off(0.1 - beta, 0.3)
        * cut_off(beta - 0.45, 0.3)
    )
    mu0 = area_vertices * np.where(gamma >= -0.1, patch, 0.0)

    mu1 = np.zeros(vertices.shape[0])
    for c in centers:
        d2 = np.linalg.norm(vertices - c, axis=1) ** 2
        mu1 += area_vertices * np.exp(-d2 / length_scale**2)
    return mu0, mu1
