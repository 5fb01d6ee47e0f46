"""All seven relative KKT residuals (counterpart of `dots_socp_tpu/solver/kkt.py`).

  column 0: error in ORIGINAL units  (the reference's `org_kkt_errors`)
  column 1: error in SCALED units    (the reference's `kkt_errors`); rows 4-6
            carry NaN.
"""

from __future__ import annotations

import math

import torch

from dots_socp_torch.ops.mesh_ops import div_space, triangle_mean_gather, vertex_reduce
from dots_socp_torch.ops.norms import norm_sq_decouple, norm_sq_triangle, norm_sq_vertex
from dots_socp_torch.ops.time_stencils import (
    decouple_space,
    decouple_space_adjoint,
    div_time,
    time_center_adjoint,
)
from dots_socp_torch.solver.problem import ProblemConfig, ProblemData
from dots_socp_torch.solver.state import SolverState


def _norms(config: ProblemConfig, data: ProblemData):
    av = data.ops.av
    area_f = data.ops.area_f
    T = config.n_time

    def nst(a):  # (T, V), weight av, averaged over T slices
        return norm_sq_vertex(av, a, T)

    def nsc(a):  # (T+1, V), weight av, averaged over T+1 slices
        return norm_sq_vertex(av, a, T + 1)

    def nss(a):  # (T+1, F, 3), weight area_f, averaged over T+1
        return norm_sq_triangle(area_f, a, T + 1)

    def nsd(a):  # (T, 2, F, 3, 3), weight area_f, averaged over T
        return norm_sq_decouple(area_f, a, T)

    return nst, nsc, nss, nsd


def kkt_table(config: ProblemConfig, data: ProblemData, state: SolverState):
    """Return the (7, 2) KKT error table [original, scaled] on the device."""
    ops = data.ops
    dt = config.stepsize_time
    nst, nsc, nss, nsd = _norms(config, data)
    s = state
    nan = torch.tensor(math.nan, dtype=s.r.dtype, device=s.r.device)

    def dual_valued(resi, const, norm_sum, scale):
        return torch.stack([resi / (const / scale + norm_sum), resi / (const + norm_sum)])

    # --- 0: primal feasibility (phi, q) -------------------------------------
    resi_mu = s.dt_phi - s.A - s.lambda_c
    resi_e = s.dx_phi - s.B
    norm_sum = (
        torch.sqrt(nst(s.dt_phi) + nss(s.dx_phi))
        + torch.sqrt(nst(s.A) + nss(s.B))
        + torch.sqrt(nst(s.lambda_c))
    )
    prim_resi = torch.sqrt(nst(resi_mu) + nss(resi_e))
    kkt0 = dual_valued(prim_resi, data.c_prim_q, norm_sum, s.prim_scale)

    # --- 1: primal feasibility (q, z) ---------------------------------------
    dec_b = decouple_space(s.B, s.scale_z)
    r_fst = s.z_fst + s.scale_z * s.A - s.constant_d
    r_mid = s.scale_z * (s.z_mid - dec_b)
    r_end = s.z_end - s.scale_z * s.A - s.constant_d
    prim_resi_z = torch.sqrt(nst(r_fst) + nst(r_end) + nsd(r_mid))
    kkt1 = dual_valued(prim_resi_z, data.c_prim_z, s.norm_constant_d, s.prim_scale)

    # --- 2: dual feasibility (alpha) ----------------------------------------
    dual_aux = (s.r * dt) * (
        s.boundary
        + div_time(dt, s.mu * ops.av[None, :])
        + div_space(ops, s.E * ops.area_f[None, :, None])
    ) / ops.av[None, :]
    dual_resi = torch.sqrt(nsc(dual_aux))
    kkt2 = dual_valued(dual_resi, data.c_dual_alpha, s.norm_boundary, s.dual_scale)

    # --- 3: dual feasibility (beta) -----------------------------------------
    aux1 = s.scale_z * (s.beta_end - s.beta_fst)
    aux2 = decouple_space_adjoint(s.beta_mid, s.scale_z)
    norm_sum3 = s.r * (
        torch.sqrt(nst(s.mu) + nss(s.E)) + torch.sqrt(nst(aux1) + nss(aux2))
    )
    resi3 = s.r * torch.sqrt(nst(s.mu + aux1) + nss(s.E + aux2))
    kkt3 = dual_valued(resi3, data.c_dual_beta, norm_sum3, s.dual_scale)

    # --- 4: complementarity (rho, f(q)) -- original units only --------------
    mu_o = (s.dual_scale * s.r) * s.mu
    a_o = s.prim_scale * s.A
    b_o = s.prim_scale * s.B
    dec_b1 = decouple_space(b_o, 1.0)
    sq = (dec_b1 * dec_b1).sum(dim=(1, 4))  # (T, F, 3corner)
    resi_aux = a_o + 0.25 * vertex_reduce(ops, ops.area_f[:, None] * sq) / ops.av[None, :]
    norm_sum4 = torch.sqrt(nst(mu_o)) + torch.sqrt(nst(resi_aux))
    proj_gap = torch.clamp(resi_aux + mu_o, min=0.0) - mu_o
    resi4 = torch.sqrt(nst(proj_gap))
    kkt4 = torch.stack([resi4 / (data.c_comp_rho + norm_sum4), nan])

    # --- 5: complementarity (m, rho o B) -- original units only -------------
    m_o = (s.dual_scale * s.r) * s.E
    rho_adj = time_center_adjoint(mu_o)  # (T+1, V)
    rho_tri = triangle_mean_gather(ops, rho_adj)
    aux5 = rho_tri[:, :, None] * b_o
    norm_sum5 = torch.sqrt(nss(m_o)) + torch.sqrt(nss(aux5))
    resi5 = torch.sqrt(nss(aux5 - m_o))
    kkt5 = torch.stack([resi5 / (data.c_comp_m + norm_sum5), nan])

    # --- 6: complementarity (rho, congestion) -- original units only --------
    lam_o = s.prim_scale * s.lambda_c
    norm_sum6 = torch.sqrt(nst(mu_o)) + torch.sqrt(nst(lam_o))
    resi6 = torch.sqrt(nst(s.congestion * mu_o - lam_o))
    kkt6 = torch.stack([resi6 / (data.c_comp_rho + norm_sum6), nan])

    return torch.stack([kkt0, kkt1, kkt2, kkt3, kkt4, kkt5, kkt6])


#: Standalone entry (tests, final validation). PyTorch runs eagerly, so it
#: is `kkt_table` itself.
compute_kkt = kkt_table


def objective_functional(config: ProblemConfig, data: ProblemData, state: SolverState):
    """Transport cost and Lagrangian value in original units (0-d tensors)."""
    nst, _, _, _ = _norms(config, data)
    dt = config.stepsize_time
    phi = state.prim_scale * state.phi
    boundary = (state.dual_scale * state.r) * state.boundary
    trans_cost = dt * (
        torch.dot(phi[0], boundary[0].to(phi.dtype))
        + torch.dot(phi[-1], boundary[-1].to(phi.dtype))
    )
    congestion_orig = state.congestion * state.prim_scale / state.dual_scale
    lam = state.prim_scale * state.lambda_c
    penalty = torch.where(
        congestion_orig > 1e-10,
        1.0 / (2.0 * torch.clamp(congestion_orig, min=1e-10)) * nst(lam),
        torch.zeros_like(congestion_orig),
    )
    return trans_cost, trans_cost - penalty
