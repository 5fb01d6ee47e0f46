# The port's own copy of dots_socp_tpu/models/__init__.py; only the import paths differ.
"""Problem definitions: example boundary densities, cameras, example registry.

The "model" of this framework is a DOT problem instance: a surface mesh plus
boundary densities (mu0, mu1). `examples/` holds one module per predefined
example (same names and density formulas as the reference's
`data/settings/*.py`, vectorized); `registry.py` maps example names to mesh
files and settings modules.
"""

from dots_socp_torch.models.registry import match_example, EXAMPLE_NAMES

__all__ = ["match_example", "EXAMPLE_NAMES"]
