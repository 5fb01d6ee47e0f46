# The port's own copy of dots_socp_tpu/utils/__init__.py; only the import paths differ.
"""Host-side utilities: typed contracts, running history, validators, evaluation."""
