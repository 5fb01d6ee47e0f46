# The port's own copy of dots_socp_tpu/models/examples/face.py; only the import paths differ.
"""Face: oblique-slab patch to two gaussian blobs (ref data/settings/face.py)."""
import numpy as np

from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    length_scale = 0.1
    center0 = vertices[4492, :]
    center1 = vertices[4225, :]

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

    d0 = np.linalg.norm(vertices - center0, axis=1) ** 2
    d1 = np.linalg.norm(vertices - center1, axis=1) ** 2
    mu1 = area_vertices * (
        np.exp(-d0 / length_scale**2) + np.exp(-d1 / length_scale**2)
    )
    return mu0, mu1
