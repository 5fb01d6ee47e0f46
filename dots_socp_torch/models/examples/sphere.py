# The port's own copy of dots_socp_tpu/models/examples/sphere.py; only the import paths differ.
"""Punctured sphere: boundary densities loaded from measured data
(ref data/settings/sphere.py; data converted from data_mu/*.txt)."""
from pathlib import Path

import numpy as np

from dots_socp_torch.config import PATHS


def get_mu(area_vertices=None, vertices=None):
    mu_dir = Path(PATHS["mu_data_dir"])
    mu0 = np.load(mu_dir / "sphere_puncture_data_mu0.npy")
    mu1 = np.load(mu_dir / "sphere_puncture_data_mu1.npy")
    return mu0, mu1
