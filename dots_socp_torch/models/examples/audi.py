# The port's own copy of dots_socp_tpu/models/examples/audi.py; only the import paths differ.
"""Audi: one box source on the body to three split box sinks
(ref data/settings/audi.py:1-37)."""
from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    x, y, z = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    band = cut_off(y + 0.9, 0.1)
    mu0 = (
        area_vertices
        * cut_off(x + 0.357, 0.007)
        * band
        * cut_off(-z + 0.02748, 0.00422)
    )
    rear = cut_off(-x + 0.715, 0.0143)
    mu1 = area_vertices * band * (
        rear * cut_off(z + 0.2389, 0.02114)
        + rear * cut_off(-z + 0.3023, 0.02114)
        + cut_off(-x + 0.286, 0.0143) * cut_off(z + 1.0844, 0.02114)
    )
    return mu0, mu1
