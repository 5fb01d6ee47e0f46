# The port's own copy of dots_socp_tpu/utils/density.py; only the import paths differ.
"""Density unit translation and weighted norms.

Parity with reference `utils/util.py:7-69`: densities convert between
"mass per vertex" and "density per area" via the vertex area (area/3); 2-D
norms carry the 1/T time weight.
"""

from __future__ import annotations

import numpy as np

from dots_socp_torch.utils.types import GeometryData


def translate_density(mu: np.ndarray, geometry: GeometryData, reverse=False):
    """Divide (default) or multiply (reverse=True) by the vertex area."""
    area = np.asarray(geometry["area_vertices"]) / 3.0
    if mu.ndim != 1:
        area = area[np.newaxis, :]
    return np.multiply(mu, area) if reverse else np.divide(mu, area)


def _time_weight(v: np.ndarray) -> float:
    if v.ndim == 1:
        return 1.0
    if v.ndim == 2:
        return 1.0 / v.shape[0]
    raise NotImplementedError("only 1-D and 2-D arrays are supported")


def l1_norm(v: np.ndarray, weight: np.ndarray = None) -> float:
    w = _time_weight(v)
    a = np.abs(v)
    return float(np.sum(a * weight if weight is not None else a) * w)


def l2_norm(v: np.ndarray, weight: np.ndarray = None) -> float:
    w = _time_weight(v)
    sq = np.square(v)
    return float(np.sqrt(np.sum(sq * weight if weight is not None else sq) * w))


def linf_norm(v: np.ndarray) -> float:
    return float(np.max(np.abs(v)))
