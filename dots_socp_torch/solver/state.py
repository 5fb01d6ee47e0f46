"""The solver state (counterpart of `dots_socp_tpu/solver/state.py`).

Everything the iALM iteration reads and writes, including the scaling
scalars, which are 0-d tensors on the device so that sigma updates and
rescalings never need the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SolverState(NamedTuple):
    """Primal/dual state + scaling scalars. T = n_time, V vertices, F
    triangles; cone arrays use the layout (T, 2, F, 3corner, 3coord)."""

    # Primal variables
    phi: torch.Tensor        # (T+1, V) potential
    A: torch.Tensor          # (T, V) time component of q
    B: torch.Tensor          # (T+1, F, 3) spatial momentum component
    lambda_c: torch.Tensor   # (T, V) congestion slack
    z_fst: torch.Tensor      # (T, V) cone head
    z_mid: torch.Tensor      # (T, 2, F, 3, 3) cone tail block
    z_end: torch.Tensor      # (T, V) cone tail scalar
    # Dual variables
    mu: torch.Tensor         # (T, V) transported density (dual)
    E: torch.Tensor          # (T+1, F, 3) momentum (dual)
    beta_fst: torch.Tensor   # (T, V)
    beta_mid: torch.Tensor   # (T, 2, F, 3, 3)
    beta_end: torch.Tensor   # (T, V)
    # Gradients of phi from the most recent step 2 (consumed by KKT)
    dt_phi: torch.Tensor     # (T, V)
    dx_phi: torch.Tensor     # (T+1, F, 3)
    # Boundary source term (rows 0 / -1 carry -/+ mu0/mu1 / (r dt))
    boundary: torch.Tensor   # (T+1, V)
    # Scalars (0-d tensors)
    r: torch.Tensor              # ALM penalty sigma
    congestion: torch.Tensor     # congestion parameter (in scaled units)
    constant_d: torch.Tensor     # cone offset d (scaled)
    norm_constant_d: torch.Tensor
    norm_boundary: torch.Tensor
    prim_scale: torch.Tensor
    dual_scale: torch.Tensor
    scale_z: torch.Tensor
    tau: torch.Tensor            # multiplier step size
    eps: torch.Tensor            # proximal regularization of the phi step


def init_state(
    n_time: int,
    n_vertices: int,
    n_triangles: int,
    mu0,
    mu1,
    dt: float,
    grad_time_fn,
    grad_space_fn,
    decouple_adjoint_fn,
    init_solution: dict | None = None,
    congestion: float = 0.0,
    tau: float = 1.9,
    eps: float = 0.0,
    r: float = 1.0,
    norm_constant_d: float = 1.0,
    norm_boundary: float = 1.0,
    dtype=torch.float32,
    phi_dtype=None,
    device="cpu",
) -> SolverState:
    """Build the initial state, optionally warm-starting from a previous
    solution. phi_dtype : dtype for `phi` only (mixed-precision refinement
    carries phi in float64 while the rest stays in `dtype`)."""
    init = init_solution or {}
    phi_dtype = dtype if phi_dtype is None else phi_dtype

    def arr(a, dt_=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt_, device=device)

    def get(name, shape):
        if init.get(name) is not None:
            return arr(init[name])
        return torch.zeros(shape, dtype=dtype, device=device)

    T, V, F = n_time, n_vertices, n_triangles
    if init.get("phi") is not None:
        phi = arr(init["phi"], phi_dtype)
    else:
        phi = torch.zeros((T + 1, V), dtype=phi_dtype, device=device)
    A = arr(init["A"]) if init.get("A") is not None else grad_time_fn(phi).to(dtype)
    B = arr(init["B"]) if init.get("B") is not None else grad_space_fn(phi).to(dtype)
    lambda_c = get("lambda_c", (T, V))
    z_fst = get("z_fst", (T, V))
    z_end = get("z_end", (T, V))
    z_mid = get("z_mid", (T, 2, F, 3, 3))
    beta_fst = (1.0 / r) * get("beta_fst", (T, V))
    beta_end = (1.0 / r) * get("beta_end", (T, V))
    beta_mid = (1.0 / r) * get("beta_mid", (T, 2, F, 3, 3))
    if init.get("mu") is not None:
        mu = (1.0 / r) * arr(init["mu"])
    else:
        mu = beta_fst - beta_end
    if init.get("E") is not None:
        E = (1.0 / r) * arr(init["E"])
    else:
        E = -decouple_adjoint_fn(beta_mid, 1.0)

    boundary = torch.zeros((T + 1, V), dtype=dtype, device=device)
    boundary[0] = -arr(mu0) / (r * dt)
    boundary[-1] = arr(mu1) / (r * dt)

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return SolverState(
        phi=phi,
        A=A,
        B=B,
        lambda_c=lambda_c,
        z_fst=z_fst,
        z_mid=z_mid,
        z_end=z_end,
        mu=mu,
        E=E,
        beta_fst=beta_fst,
        beta_mid=beta_mid,
        beta_end=beta_end,
        dt_phi=grad_time_fn(phi).to(dtype),
        dx_phi=grad_space_fn(phi).to(dtype),
        boundary=boundary,
        r=scalar(r),
        congestion=scalar(congestion),
        constant_d=scalar(1.0),
        norm_constant_d=scalar(norm_constant_d),
        norm_boundary=scalar(norm_boundary),
        prim_scale=scalar(1.0),
        dual_scale=scalar(1.0),
        scale_z=scalar(1.0),
        tau=scalar(tau),
        eps=scalar(eps),
    )
