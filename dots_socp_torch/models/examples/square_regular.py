# The port's own copy of dots_socp_tpu/models/examples/square_regular.py; only the import paths differ.
"""Square (regular grid): one annulus source to two thin annulus sinks
(ref data/settings/square_regular.py:1-20)."""
import numpy as np

from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    def dist(center):
        return np.linalg.norm(vertices - np.asarray(center), axis=1)

    mu0 = area_vertices * cut_off(dist([0.33, 0.5, 0.0]) - 0.1, 0.1)
    mu1 = area_vertices * (
        cut_off((dist([0.8, 0.2, 0.0]) - 0.1) * 2.0, 0.1)
        + cut_off((dist([0.8, 0.8, 0.0]) - 0.1) * 2.0, 0.1)
    )
    return mu0, mu1
