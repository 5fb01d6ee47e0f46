"""Weighted space-time norms (counterpart of `dots_socp_tpu/ops/norms.py`).

Squared norms weighted by vertex or triangle areas and averaged over the
number of time slices; the weights broadcast from the (V,) / (F,) vectors.
"""

from __future__ import annotations

import torch


def norm_sq_vertex(av, a, num_avg: int):
    """sum(a^2 * av[v]) / num_avg for a of shape (T_like, V)."""
    return torch.einsum("tv,v->", a * a, av) / num_avg


def norm_sq_triangle(area_f, a, num_avg: int):
    """sum(a^2 * area_f) / num_avg for a of shape (T_like, F, 3coord)."""
    return torch.einsum("tfc,f->", a * a, area_f) / num_avg


def norm_sq_decouple(area_f, a, num_avg: int):
    """sum(a^2 * area_f) / num_avg for a of shape (T, 2, F, 3, 3)."""
    return torch.einsum("tefkc,f->", a * a, area_f) / num_avg
