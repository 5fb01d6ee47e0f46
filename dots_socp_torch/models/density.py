# The port's own copy of dots_socp_tpu/models/density.py; only the import paths differ.
"""Vectorized density construction helpers.

Same mathematical functions as the reference's `data/util.py:6-27`
(gaussian bump, radial mask, smooth cutoff) operating on whole vertex
arrays at once.
"""

from __future__ import annotations

import numpy as np


def gaussian(vertices: np.ndarray, center, scale: float) -> np.ndarray:
    """exp(-||v - c||^2 / scale) per vertex. vertices: (V, 3).

    The squared distance is computed as norm-then-square (not a direct sum
    of squares) so results are bit-identical to the reference's
    `data/util.py:6` — exp() amplifies the last-ulp difference otherwise.
    """
    d2 = np.linalg.norm(vertices - np.asarray(center), axis=-1) ** 2
    return np.exp(-d2 / scale)


def radial_mask(vertices: np.ndarray, center, radius: float) -> np.ndarray:
    """1.0 inside the ball of `radius` around center, else 0.0."""
    d = np.linalg.norm(vertices - np.asarray(center), axis=-1)
    return (d < radius).astype(float)


def cut_off(x: np.ndarray, sigma: float) -> np.ndarray:
    """Smooth cutoff: 1 for x <= 0, 0 for x >= sigma, C^1 blend between
    ((t-1)^2 (t+1)^2 with t = x/sigma)."""
    t = np.asarray(x, dtype=float) / sigma
    blend = (t - 1.0) ** 2 * (t + 1.0) ** 2
    return np.where(t <= 0.0, 1.0, np.where(t >= 1.0, 0.0, blend))
