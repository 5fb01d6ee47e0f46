# The port's own copy of dots_socp_tpu/models/examples/refined_bunny.py; only the import paths differ.
"""Refined bunny: same densities as bunny on the refined mesh."""
from dots_socp_torch.models.examples.bunny import get_mu  # noqa: F401
