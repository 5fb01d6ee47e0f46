# The port's own copy of dots_socp_tpu/models/examples/armadillo.py; only the import paths differ.
"""Armadillo: slab cutoffs along the x axis (ref data/settings/armadillo.py)."""
from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    mu0 = area_vertices * cut_off(-vertices[:, 0] + 0.1, 0.15)
    mu1 = area_vertices * cut_off(vertices[:, 0] + 0.1, 0.15)
    return mu0, mu1
