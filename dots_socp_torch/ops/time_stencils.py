"""Time-axis stencil operators and space-staggered decoupling maps.

Counterpart of `dots_socp_tpu/ops/time_stencils.py`, with the same layout:
potentials on T+1 centered slices, momenta and densities on T interval
slices, and decoupled cone arrays as (T, endpoint, F, corner, coord).
"""

from __future__ import annotations

import math

import torch

SQRT3 = math.sqrt(3.0)


def grad_time(dt: float, phi):
    """Forward time difference: (T+1, ...) -> (T, ...)."""
    return torch.diff(phi, dim=0) / dt


def div_time(dt: float, m):
    """Negative adjoint of grad_time: (T, ...) -> (T+1, ...).

    out[0] = m[0]/dt, out[t] = (m[t]-m[t-1])/dt, out[T] = -m[T-1]/dt.
    """
    return torch.cat([m[:1], torch.diff(m, dim=0), -m[-1:]], dim=0) / dt


def time_center_adjoint(x):
    """Adjoint of centered time averaging: (T, ...) -> (T+1, ...).

    out[0] = x[0]/2, out[t] = (x[t-1]+x[t])/2, out[T] = x[T-1]/2.
    """
    zeros = torch.zeros_like(x[:1])
    lo = torch.cat([zeros, x], dim=0)
    hi = torch.cat([x, zeros], dim=0)
    return 0.5 * (lo + hi)


def decouple_space(b, scale_z=1.0):
    """Copy the momentum field onto the space-staggered cone grid.

    (T+1, F, 3coord) -> (T, 2, F, 3corner, 3coord), broadcast over corners:
    out[t, 0] = (scale_z/sqrt(3)) b[t], out[t, 1] = (scale_z/sqrt(3)) b[t+1].
    The result is a broadcast view; consumers only read it.
    """
    b_aux = (scale_z / SQRT3) * b
    pair = torch.stack([b_aux[:-1], b_aux[1:]], dim=1)  # (T, 2, F, 3coord)
    n_time, _, n_f, _ = pair.shape
    return pair[:, :, :, None, :].expand(n_time, 2, n_f, 3, 3)


def decouple_space_adjoint(x, scale_z=1.0):
    """Adjoint of decouple_space: (T, 2, F, 3corner, 3coord) -> (T+1, F, 3coord).

    out[t] = (scale_z/sqrt(3)) (sum_k x[t, 0, :, k] + sum_k x[t-1, 1, :, k])
    with the obvious boundary truncation.
    """
    summed = (scale_z / SQRT3) * x.sum(dim=3)  # (T, 2, F, 3coord)
    lo = torch.cat([summed[:, 0], torch.zeros_like(summed[:1, 0])], dim=0)
    hi = torch.cat([torch.zeros_like(summed[:1, 1]), summed[:, 1]], dim=0)
    return lo + hi
