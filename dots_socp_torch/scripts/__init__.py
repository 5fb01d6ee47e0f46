"""Experiment scripts of the port (counterparts of the repository's
`scripts/` folder, which drives the JAX package)."""
