# The port's own copy of dots_socp_tpu/models/examples/default.py; only the import paths differ.
"""Default densities for unspecified settings: cutoffs along x then y
(ref data/settings/default.py:1-13; same formula as robot)."""
from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    mu0 = area_vertices * cut_off(vertices[:, 0], 0.1)
    mu1 = area_vertices * cut_off(vertices[:, 1], 0.1)
    return mu0, mu1
