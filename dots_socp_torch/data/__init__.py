# The port's own copy of dots_socp_tpu/data/__init__.py; only the import paths differ.
"""Data layer: example loading, mesh data, exact transport loading."""

from dots_socp_torch.data.loader import (
    load_example,
    load_example_file,
    load_exact_transportation,
)

__all__ = ["load_example", "load_example_file", "load_exact_transportation"]
