"""Rescaling machinery as state transforms (counterpart of
`dots_socp_tpu/solver/scaling.py`): each returns a new state; the host
scheduler triggers them between iterations."""

from __future__ import annotations

import torch

from dots_socp_torch.ops.time_stencils import decouple_space_adjoint
from dots_socp_torch.solver.kkt import _norms
from dots_socp_torch.solver.problem import ProblemConfig, ProblemData
from dots_socp_torch.solver.state import SolverState


def compute_var_norms(config: ProblemConfig, data: ProblemData, state: SolverState):
    """Primal/dual variable group norms used to pick rescale factors.
    Returns (prim (3,), dual (2,))."""
    nst, _, nss, nsd = _norms(config, data)
    s = state
    prim = torch.stack(
        [
            torch.sqrt(nst(s.dt_phi) + nss(s.dx_phi)),
            torch.sqrt(nst(s.A) + nss(s.B)),
            torch.sqrt(nst(s.z_fst) + nsd(s.z_mid) + nst(s.z_end)),
        ]
    )
    dual = torch.stack(
        [
            s.r * torch.sqrt(nst(s.mu) + nss(s.E)),
            s.r * torch.sqrt(nst(s.beta_fst) + nsd(s.beta_mid) + nst(s.beta_end)),
        ]
    )
    return prim, dual


def _scalar(state: SolverState, value):
    return torch.as_tensor(value, dtype=state.r.dtype, device=state.r.device)


def apply_prim_dual_scale(state: SolverState, prim_rescale, dual_rescale):
    """Divide primal variables by prim_rescale and duals by
    dual_rescale^2/prim_rescale; fold the ratio into r, congestion and the
    normalization constants."""
    pr = _scalar(state, prim_rescale)
    dr = _scalar(state, dual_rescale)
    dual_factor = dr * dr / pr
    ratio = dr / pr
    return state._replace(
        phi=state.phi / pr,
        A=state.A / pr,
        B=state.B / pr,
        lambda_c=state.lambda_c / pr,
        dt_phi=state.dt_phi / pr,
        dx_phi=state.dx_phi / pr,
        z_fst=state.z_fst / pr,
        z_mid=state.z_mid / pr,
        z_end=state.z_end / pr,
        boundary=state.boundary / dual_factor,
        mu=state.mu / dual_factor,
        E=state.E / dual_factor,
        beta_fst=state.beta_fst / dual_factor,
        beta_mid=state.beta_mid / dual_factor,
        beta_end=state.beta_end / dual_factor,
        r=state.r * ratio,
        congestion=state.congestion * ratio,
        constant_d=state.constant_d / pr,
        norm_constant_d=state.norm_constant_d / pr,
        norm_boundary=state.norm_boundary / dr,
        prim_scale=state.prim_scale * pr,
        dual_scale=state.dual_scale * dr,
    )


def apply_z_scale(state: SolverState, factor):
    """Rescale the cone block by `factor`: z multiplied by the new cumulative
    scale, betas by its inverse, and (mu, E) re-derived from the betas."""
    f = _scalar(state, factor)
    sz = state.scale_z * f
    mu = sz * (state.beta_fst - state.beta_end)
    E = -decouple_space_adjoint(state.beta_mid / sz, sz)
    return state._replace(
        z_fst=state.z_fst * sz,
        z_mid=state.z_mid * sz,
        z_end=state.z_end * sz,
        beta_fst=state.beta_fst / sz,
        beta_mid=state.beta_mid / sz,
        beta_end=state.beta_end / sz,
        mu=mu / sz,
        E=E,
        constant_d=state.constant_d * f,
        norm_constant_d=state.norm_constant_d * f,
        scale_z=sz,
    )


def apply_penalty_factor(state: SolverState, factor):
    """sigma-update: r *= factor, duals and boundary divided by factor."""
    f = _scalar(state, factor)
    return state._replace(
        r=state.r * f,
        mu=state.mu / f,
        E=state.E / f,
        boundary=state.boundary / f,
        beta_fst=state.beta_fst / f,
        beta_mid=state.beta_mid / f,
        beta_end=state.beta_end / f,
    )
