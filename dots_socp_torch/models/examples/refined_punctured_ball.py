# The port's own copy of dots_socp_tpu/models/examples/refined_punctured_ball.py; only the import paths differ.
"""Refined punctured ball: same densities on the refined mesh."""
from dots_socp_torch.models.examples.punctured_ball import get_mu  # noqa: F401
