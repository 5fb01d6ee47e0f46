# The port's own copy of dots_socp_tpu/models/examples/refined_armadillo.py; only the import paths differ.
"""Refined armadillo: same densities as armadillo on the refined mesh."""
from dots_socp_torch.models.examples.armadillo import get_mu  # noqa: F401
