# The port's own copy of dots_socp_tpu/models/examples/airplane.py; only the import paths differ.
"""Airplane: slab cutoffs along the z axis (ref data/settings/airplane.py)."""
from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    mu0 = area_vertices * cut_off(-(vertices[:, 2] - 0.5), 0.3)
    mu1 = area_vertices * cut_off(vertices[:, 2] + 0.1, 0.3)
    return mu0, mu1
