# The port's own copy of dots_socp_tpu/models/examples/hills.py; only the import paths differ.
"""Hills: wide gaussian at one peak vertex to another
(ref data/settings/hills.py:1-18; centers are mesh vertices 1191 and 9505)."""
from dots_socp_torch.models.density import gaussian


def get_mu(area_vertices, vertices):
    center0 = vertices[1191, :]
    center1 = vertices[9505, :]
    mu0 = area_vertices * gaussian(vertices, center0, 1.0)
    mu1 = area_vertices * gaussian(vertices, center1, 1.0)
    return mu0, mu1
