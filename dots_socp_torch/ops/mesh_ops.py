"""Surface calculus on device: gradient, divergence, vertex reductions.

Counterpart of `dots_socp_tpu/ops/mesh_ops.py` (unsharded form): gradients
are a gather of the 3 corner values plus a 3-term mul-sum; divergence and
triangle->vertex maps are a gather through the padded incidence table plus a
masked sum (no scatter, so results do not depend on atomics' order).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SurfaceOps(NamedTuple):
    """Static per-problem tensors consumed by the device operators.

    tri        : (F, 3) int64   -- vertex index of corner k of triangle f
    grad_basis : (F, 3, 3)      -- gradient of hat function of corner k
    area_f     : (F,)           -- triangle areas
    av         : (V,)           -- vertex areas (one-ring area / 3)
    inc_table  : (V, D) int64   -- flat corner-slot indices f*3+k per vertex
    inc_mask   : (V, D)         -- 1.0 valid / 0.0 padding
    diag_soc   : (F, 3)         -- sqrt(area_f / av[tri[f,k]]) cone scaling
    """

    tri: torch.Tensor
    grad_basis: torch.Tensor
    area_f: torch.Tensor
    av: torch.Tensor
    inc_table: torch.Tensor
    inc_mask: torch.Tensor
    diag_soc: torch.Tensor


def build_surface_ops(
    vertices: np.ndarray,
    triangles: np.ndarray,
    dtype=torch.float32,
    device="cpu",
) -> SurfaceOps:
    """Host-side assembly of the SurfaceOps arrays (NumPy), moved to device."""
    from dots_socp_tpu.geometry.surface import (
        build_incidence_table,
        triangle_quantities,
        vertex_areas,
    )

    triangles = np.asarray(triangles)
    n_vertices = np.asarray(vertices).shape[0]
    area_f, _, grad_basis = triangle_quantities(np.asarray(vertices), triangles)
    av = vertex_areas(triangles, area_f, n_vertices) / 3.0
    table, mask = build_incidence_table(triangles, n_vertices)
    diag_soc = np.sqrt(area_f[:, None] / av[triangles])

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    return SurfaceOps(
        tri=i(triangles),
        grad_basis=f(grad_basis),
        area_f=f(area_f),
        av=f(av),
        inc_table=i(table),
        inc_mask=f(mask),
        diag_soc=f(diag_soc),
    )


def vertex_gather(ops: SurfaceOps, values):
    """(..., V) vertex field -> (..., F, 3) per-corner values."""
    return values[..., ops.tri]


def vertex_reduce(ops: SurfaceOps, values):
    """Sum (..., F, 3) corner-slot data into vertices: (..., V).

    Adjoint of `vertex_gather`: gather + masked sum through the padded
    incidence table.
    """
    flat = values.reshape(values.shape[:-2] + (-1,))
    gathered = flat[..., ops.inc_table]  # (..., V, D)
    return (gathered * ops.inc_mask).sum(-1)


def grad_space(ops: SurfaceOps, phi):
    """P1 gradient: (..., V) -> (..., F, 3) tangent vectors per triangle.

    grad(phi)|_f = sum_k phi[tri[f,k]] * grad_basis[f,k].
    """
    corners = vertex_gather(ops, phi)  # (..., F, 3corner)
    return (corners[..., :, None] * ops.grad_basis).sum(dim=-2)


def div_space(ops: SurfaceOps, m):
    """Divergence, the negative adjoint of grad_space: (..., F, 3) -> (..., V).

    div(m)[v] = -sum_{(f,k): tri[f,k]=v} <grad_basis[f,k], m[f]>.
    """
    contrib = -(m[..., None, :] * ops.grad_basis).sum(dim=-1)
    return vertex_reduce(ops, contrib)


def laplacian_apply(ops: SurfaceOps, x):
    """Cotan Laplacian SpMV, matrix-free: L x = div(area_f * grad(x))."""
    grad = grad_space(ops, x)
    return div_space(ops, ops.area_f[:, None] * grad)


def triangle_mean_gather(ops: SurfaceOps, values):
    """(..., V) -> (..., F): mean of the 3 corner values per triangle."""
    return vertex_gather(ops, values).mean(dim=-1)


def weighted_vertex_reduce(ops: SurfaceOps, values):
    """Area-weighted triangle->vertex map: (..., F, 3) -> (..., V)."""
    return vertex_reduce(ops, ops.area_f[:, None] * values)
