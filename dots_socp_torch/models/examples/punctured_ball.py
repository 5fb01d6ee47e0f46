# The port's own copy of dots_socp_tpu/models/examples/punctured_ball.py; only the import paths differ.
"""Punctured ball: opposite y-caps (ref data/settings/punctured_ball.py:1-13)."""
from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    y = vertices[:, 1]
    mu0 = area_vertices * cut_off(-y + 0.875, 0.1)
    mu1 = area_vertices * cut_off(y + 0.875, 0.1)
    return mu0, mu1
