# The port's own copy of dots_socp_tpu/models/examples/eight.py; only the import paths differ.
"""Eight (genus-2 surface): one box source to two stacked box sinks
(ref data/settings/eight.py:1-29)."""
from dots_socp_torch.models.density import cut_off


def get_mu(area_vertices, vertices):
    x, y, z = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    ystrip = cut_off(y + 0.9108, 0.1012)
    mu0 = area_vertices * cut_off(x + 0.2626, 0.01) * ystrip
    xcap = cut_off(-x + 0.9696, 0.0202) * ystrip
    mu1 = area_vertices * xcap * (
        cut_off(z + 0.3371, 0.0337) + cut_off(z + 0.4383, 0.0337)
    )
    return mu0, mu1
