"""The benchmark of dots_socp_torch (see `run.py` and `README.md`)."""
