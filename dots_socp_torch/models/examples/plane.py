# The port's own copy of dots_socp_tpu/models/examples/plane.py; only the import paths differ.
"""Plane: gaussian-to-gaussian transport with a closed-form solution
(ref data/settings/plane.py, including get_exact_transportation)."""
import numpy as np

from dots_socp_torch.models.density import gaussian

CENTER0 = np.array([0.4, 0.4, 0.0])
SCALE0 = 2 * (0.1**2)
CENTER1 = np.array([0.6, 0.6, 0.0])
SCALE1 = 2 * (0.1**2)


def get_mu(area_vertices, vertices):
    mu0 = area_vertices * gaussian(vertices, CENTER0, SCALE0)
    mu1 = area_vertices * gaussian(vertices, CENTER1, SCALE1)
    return mu0, mu1


def get_exact_transportation(t_array, vertices, area_vertices):
    """Displacement interpolation of two gaussians: centers move linearly,
    the scale interpolates through its quarter power."""
    s0q = SCALE0**0.25
    s1q = SCALE1**0.25
    t = np.asarray(t_array)[:, None]
    sigma_t = ((1 - t) * s0q + t * s1q) ** 4  # (T, 1)
    center_t = (1 - np.asarray(t_array))[:, None] * CENTER0 + np.asarray(t_array)[
        :, None
    ] * CENTER1  # (T, 3)
    d2 = (
        np.linalg.norm(vertices[None, :, :] - center_t[:, None, :], axis=-1)
        ** 2
    )  # (T, V); norm-then-square for bit parity with data/util.py:6

    return area_vertices[None, :] * np.exp(-d2 / sigma_t)
