"""Weighted space-time norms (counterpart of `dots_socp_tpu/ops/norms.py`).

Squared norms weighted by vertex or triangle areas and averaged over the
number of time slices; the weights broadcast from the (V,) / (F,) vectors.
On a space shard (`mesh` given) each sum covers every shard: the shard's
partial sum, then one all-reduce (`ops.collectives.space_sum`), where the
JAX package's GSPMD inserts a psum. Padding slots hold zeros and add
nothing.

On a mesh with a time axis the staggered (T, ...) arrays are cut over time
too, so their sums cover every (time, space) shard (`staggered=True`:
`space_time_sum`). The centered (T+1, ...) arrays are whole on every
time-rank: their sums cross space only, and summing them over time as well
would count them once per time shard.
"""

from __future__ import annotations

import torch

from dots_socp_torch.ops.collectives import space_sum, space_time_sum


def norm_sq_vertex(av, a, num_avg: int, mesh=None, staggered=False):
    """sum(a^2 * av[v]) / num_avg for a of shape (T_like, V); `staggered`:
    `a` is a (T, V) array, cut over the mesh's time axis."""
    total = space_time_sum if staggered else space_sum
    return total(torch.einsum("tv,v->", a * a, av), mesh) / num_avg


def norm_sq_triangle(area_f, a, num_avg: int, mesh=None):
    """sum(a^2 * area_f) / num_avg for a of shape (T_like, F, 3coord)."""
    return space_sum(torch.einsum("tfc,f->", a * a, area_f), mesh) / num_avg


def norm_sq_decouple(area_f, a, num_avg: int, mesh=None):
    """sum(a^2 * area_f) / num_avg for a of shape (T, 2, F, 3, 3), a
    staggered array."""
    return space_time_sum(torch.einsum("tefkc,f->", a * a, area_f), mesh) / num_avg
