# The port's own copy of dots_socp_tpu/models/examples/ring.py; only the import paths differ.
"""Ring: opposite x-caps (ref data/settings/ring.py:1-13)."""
from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    x = vertices[:, 0]
    mu0 = area_vertices * cut_off(x - 0.5, 0.5)
    mu1 = area_vertices * cut_off(x + 0.7, 0.5)
    return mu0, mu1
