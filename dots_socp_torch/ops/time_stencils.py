"""Time-axis stencil operators and space-staggered decoupling maps.

Counterpart of `dots_socp_tpu/ops/time_stencils.py`, with the same layout:
potentials on T+1 centered slices, momenta and densities on T interval
slices, and decoupled cone arrays as (T, endpoint, F, corner, coord).

On a mesh with a time axis (`mesh`, a `parallel.distributed.SolverMesh` with
time > 1) the (T, ...) arrays are this time-rank's block of T / time slices
and the (T+1, ...) arrays are whole on every time-rank (JAX
`parallel/mesh.py:47-83`). A map from T+1 to T slices then reads its block
of the whole array and moves nothing; a map from T to T+1 slices gathers
the blocks over the time group first (`ops.collectives.time_all_gather`),
so every time-rank ends with the same whole result. With `mesh=None` or one
time shard nothing changes and no collective is called.
"""

from __future__ import annotations

import math

import torch

from dots_socp_torch.ops.collectives import time_all_gather

SQRT3 = math.sqrt(3.0)


def _own_slices(centered, mesh):
    """The T / time + 1 centered slices that bound this time-rank's block of
    staggered slices (the whole array without a time axis)."""
    if mesh is None or mesh.time == 1:
        return centered
    block = mesh.time_block(centered.shape[0] - 1)
    return centered[block.start : block.stop + 1]


def grad_time(dt: float, phi, mesh=None):
    """Forward time difference: (T+1, ...) -> (T, ...)."""
    phi = _own_slices(phi, mesh)
    return torch.diff(phi, dim=0) / dt


def div_time(dt: float, m, mesh=None):
    """Negative adjoint of grad_time: (T, ...) -> (T+1, ...).

    out[0] = m[0]/dt, out[t] = (m[t]-m[t-1])/dt, out[T] = -m[T-1]/dt.
    """
    m = time_all_gather(m, mesh)
    return torch.cat([m[:1], torch.diff(m, dim=0), -m[-1:]], dim=0) / dt


def time_center_adjoint(x, mesh=None):
    """Adjoint of centered time averaging: (T, ...) -> (T+1, ...).

    out[0] = x[0]/2, out[t] = (x[t-1]+x[t])/2, out[T] = x[T-1]/2.
    """
    x = time_all_gather(x, mesh)
    zeros = torch.zeros_like(x[:1])
    lo = torch.cat([zeros, x], dim=0)
    hi = torch.cat([x, zeros], dim=0)
    return 0.5 * (lo + hi)


def decouple_space(b, scale_z=1.0, mesh=None):
    """Copy the momentum field onto the space-staggered cone grid.

    (T+1, F, 3coord) -> (T, 2, F, 3corner, 3coord), broadcast over corners:
    out[t, 0] = (scale_z/sqrt(3)) b[t], out[t, 1] = (scale_z/sqrt(3)) b[t+1].
    The result is a broadcast view; consumers only read it.
    """
    b_aux = (scale_z / SQRT3) * _own_slices(b, mesh)
    pair = torch.stack([b_aux[:-1], b_aux[1:]], dim=1)  # (T, 2, F, 3coord)
    n_time, _, n_f, _ = pair.shape
    return pair[:, :, :, None, :].expand(n_time, 2, n_f, 3, 3)


def decouple_space_adjoint(x, scale_z=1.0, mesh=None):
    """Adjoint of decouple_space: (T, 2, F, 3corner, 3coord) -> (T+1, F, 3coord).

    out[t] = (scale_z/sqrt(3)) (sum_k x[t, 0, :, k] + sum_k x[t-1, 1, :, k])
    with the obvious boundary truncation. The time blocks are gathered after
    the sum over corners: a third of the bytes.
    """
    summed = time_all_gather((scale_z / SQRT3) * x.sum(dim=3), mesh)  # (T, 2, F, 3coord)
    lo = torch.cat([summed[:, 0], torch.zeros_like(summed[:1, 0])], dim=0)
    hi = torch.cat([torch.zeros_like(summed[:1, 1]), summed[:, 1]], dim=0)
    return lo + hi
