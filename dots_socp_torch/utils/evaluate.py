# The port's own copy of dots_socp_tpu/utils/evaluate.py; only the import paths differ.
"""Solution evaluation: physics invariants and accuracy vs exact transport.

Parity with reference `utils/evaluate_solution.py:7-69` including the logged
block formats.
"""

from __future__ import annotations

import logging

import numpy as np

from dots_socp_torch.config import LOG_LEVELS
from dots_socp_torch.utils.density import l1_norm, l2_norm, linf_norm, translate_density
from dots_socp_torch.utils.types import ErrorVersusExactData


def check_mass_conservation(mu, verbose=True):
    """RMS deviation of per-time-layer total mass from 1."""
    mass_layers = mu.sum(axis=1)
    error = float(np.linalg.norm(mass_layers - 1.0) / np.sqrt(mass_layers.shape[0]))
    if verbose:
        with np.printoptions(precision=4, suppress=True):
            layers = f"Sum of Mass at each time layer:\n{mass_layers}"
        logging.log(
            LOG_LEVELS["info"],
            "---- Mass Conservation ".ljust(42, "-") + "\n"
            f"{layers}\n"
            f"Mass Conservation Violation: {error:.2e}",
        )
    return error


def check_negative_mass(mu, verbose=True):
    """RMS of the negative-mass totals per time layer."""
    negative_layers = np.where(mu < 0, mu, 0.0).sum(axis=1)
    error = float(
        np.linalg.norm(negative_layers) / np.sqrt(negative_layers.shape[0])
    )
    if verbose:
        with np.printoptions(precision=4, suppress=True):
            layers = f"Sum of Negative Mass at each time layer:\n{negative_layers}"
        logging.log(
            LOG_LEVELS["info"],
            "---- Negative Mass ".ljust(42, "-") + "\n"
            f"{layers}\n"
            f"Non-Negative Mass Violation: {error:.2e}",
        )
    return error, negative_layers


def compare_with_exact_transportation(mu, mu_exact, geometry, verbose=True):
    """Relative weighted L1/L2/Linf errors of the density path vs exact."""
    mu_d = translate_density(np.asarray(mu), geometry)
    exact_d = translate_density(np.asarray(mu_exact), geometry)
    diff = mu_d - exact_d
    mesh_area = np.asarray(geometry["area_vertices"])[np.newaxis, :] / 3.0

    error = ErrorVersusExactData(
        l1=l1_norm(diff, weight=mesh_area) / (1.0 + l1_norm(exact_d, weight=mesh_area)),
        l2=l2_norm(diff, weight=mesh_area) / (1.0 + l2_norm(exact_d, weight=mesh_area)),
        linf=linf_norm(diff) / (1.0 + linf_norm(exact_d)),
    )
    if verbose:
        logging.log(
            LOG_LEVELS["info"],
            "---- Versus exact transportation ".ljust(42, "-") + "\n"
            f"L_1 Error: {error['l1']:.2e}\n"
            f"L_2 Error: {error['l2']:.2e}\n"
            f"L_Inf Error: {error['linf']:.2e}",
        )
    return error
