# The port's own copy of dots_socp_tpu/models/examples/refined_airplane.py; only the import paths differ.
"""Refined airplane: same densities as airplane on the refined mesh."""
from dots_socp_torch.models.examples.airplane import get_mu  # noqa: F401
