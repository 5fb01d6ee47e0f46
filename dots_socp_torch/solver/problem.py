"""One-time problem assembly: operators, Laplacian factor, KKT constants.

Counterpart of `dots_socp_tpu/solver/problem.py` (single device, unsharded).
Everything is assembled on the host with numpy/scipy and moved to the
device once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dots_socp_torch.ops import resolve_device
from dots_socp_torch.ops.laplacian import (
    CGOperator,
    SpectralFactor,
    build_cg_operator,
    build_spectral_factor,
)
from dots_socp_torch.ops.mesh_ops import SurfaceOps
from dots_socp_tpu.geometry.surface import (
    build_incidence_table,
    cotan_laplacian,
    triangle_quantities,
    vertex_areas,
)
from dots_socp_tpu.utils.types import GeometryData


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Static solver configuration.

    n_vertices / n_triangles are the PADDED sizes (array shapes); the _real
    fields track the actual mesh for slicing results back.
    """

    n_time: int
    n_vertices: int
    n_triangles: int
    stepsize_time: float
    n_vertices_real: int = 0
    n_triangles_real: int = 0
    is_palm: bool = False
    laplacian_mode: str = "spectral"  # "spectral" | "cg"
    cg_max_iters: int = 200
    cg_rtol: float = 1e-9
    dtype: str = "float32"
    # Mixed-precision phi: state.phi is carried in float64 and the CG
    # phi-solve runs f64 iterative refinement around the f32 inner CG.
    phi_refine: bool = False

    @property
    def torch_dtype(self):
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def phi_dtype(self):
        return torch.float64 if self.phi_refine else self.torch_dtype

    @property
    def np_dtype(self):
        return np.float64 if self.dtype == "float64" else np.float32


class ProblemData(NamedTuple):
    """Per-problem device tensors."""

    ops: SurfaceOps
    spectral: Optional[SpectralFactor]
    cg_op: Optional[CGOperator]
    # Relative-KKT normalization constants: means of the weight arrays.
    c_prim_q: torch.Tensor
    c_prim_z: torch.Tensor
    c_dual_alpha: torch.Tensor
    c_dual_beta: torch.Tensor
    c_comp_rho: torch.Tensor
    c_comp_m: torch.Tensor


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def build_problem(
    n_time: int,
    geometry: GeometryData,
    eps: float = 0.0,
    is_palm: bool = False,
    laplacian_mode: str = "auto",
    max_dense_vertices: int = 16384,
    cg_max_iters: int = 200,
    cg_rtol: float = 1e-9,
    cg_deflation_k: int | None = None,
    dtype: str = "float32",
    pad_multiple: int = 1,
    phi_refine="auto",
    device="cuda",
):
    """Assemble (ProblemConfig, ProblemData, extras) on `device`.

    pad_multiple : pad the vertex and triangle counts to this multiple.
        Dummy vertices carry mean vertex area, zero density and no incident
        real triangles; dummy triangles carry zero area/basis.
    phi_refine : "auto" | "on" | "off" | bool. auto enables mixed-precision
        phi exactly when laplacian_mode == "cg" and dtype == "float32".

    extras holds host floats {norm_constant_d, area_mesh}, NumPy av / area_f
    (real sizes), padded mu0/mu1 and the vertex/triangle placement maps.
    """
    device = resolve_device(device)
    vertices = np.asarray(geometry["vertices"], dtype=np.float64)
    triangles = np.asarray(geometry["triangles"])
    n_vertices = vertices.shape[0]
    n_triangles = triangles.shape[0]
    dt = 1.0 / n_time
    tdtype = torch.float64 if dtype == "float64" else torch.float32

    area_f, angles, grad_basis = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, n_vertices) / 3.0

    v_pad = _round_up(n_vertices, pad_multiple)
    f_pad = _round_up(n_triangles, pad_multiple)
    vertex_slot = np.arange(n_vertices, dtype=np.int64)
    triangle_slot = np.arange(n_triangles, dtype=np.int64)
    tri_p = np.concatenate(
        [
            triangles,
            np.full((f_pad - n_triangles, 3), v_pad - 1 if v_pad > n_vertices else 0),
        ]
    ).astype(np.int64)
    grad_basis_p = np.concatenate([grad_basis, np.zeros((f_pad - n_triangles, 3, 3))])
    area_f_p = np.concatenate([area_f, np.zeros(f_pad - n_triangles)])
    av_p = np.concatenate(
        [av, np.full(v_pad - n_vertices, av.mean() if av.size else 1.0)]
    )
    # Incidence from REAL triangles only, over the padded vertex range.
    table, mask = build_incidence_table(triangles, v_pad)

    diag_soc_p = np.sqrt(
        np.where(area_f_p[:, None] > 0, area_f_p[:, None], av_p[tri_p]) / av_p[tri_p]
    )  # dummy triangles get diag 1 (avoids 0/0 in the cone step)

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=tdtype, device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

    ops = SurfaceOps(
        tri=i(tri_p),
        grad_basis=f(grad_basis_p),
        area_f=f(area_f_p),
        av=f(av_p),
        inc_table=i(table),
        inc_mask=f(mask),
        diag_soc=f(diag_soc_p),
    )

    lap = cotan_laplacian(triangles, angles, v_pad)

    if laplacian_mode == "auto":
        laplacian_mode = "spectral" if v_pad <= max_dense_vertices else "cg"

    if phi_refine in ("auto", None):
        phi_refine = laplacian_mode == "cg" and dtype == "float32"
    elif phi_refine in ("on", "off"):
        phi_refine = phi_refine == "on"
    phi_refine = bool(phi_refine) and laplacian_mode == "cg"

    spectral = None
    cg_op = None
    if laplacian_mode == "spectral":
        spectral = build_spectral_factor(
            n_time, dt, av_p, lap, eps=eps, dtype=tdtype, device=device
        )
    elif laplacian_mode == "cg":
        if cg_deflation_k is None:
            # Deflating k modes cuts the Jacobi-CG condition number ~V/k.
            cg_deflation_k = int(min(256, max(64, v_pad // 256)))
        # Padded coordinates enable the spatial-sort window ordering
        # (dummy vertices sit at the centroid; their Laplacian rows are empty).
        coords_p = np.concatenate(
            [
                vertices,
                np.broadcast_to(
                    vertices.mean(axis=0, keepdims=True)
                    if n_vertices
                    else np.zeros((1, vertices.shape[1])),
                    (v_pad - n_vertices, vertices.shape[1]),
                ),
            ]
        )
        cg_op = build_cg_operator(
            n_time,
            dt,
            av_p,
            lap,
            eps=eps,
            dtype=tdtype,
            deflation_k=cg_deflation_k,
            rtol=cg_rtol,
            refine=phi_refine,
            coords=coords_p,
            device=device,
        )
    else:
        raise ValueError(f"unknown laplacian_mode: {laplacian_mode}")

    # KKT constants from the REAL mesh (padding must not bias them).
    mean_av = float(av.mean())
    mean_af = float(area_f.mean())

    config = ProblemConfig(
        n_time=n_time,
        n_vertices=v_pad,
        n_triangles=f_pad,
        stepsize_time=dt,
        n_vertices_real=n_vertices,
        n_triangles_real=n_triangles,
        is_palm=is_palm,
        laplacian_mode=laplacian_mode,
        cg_max_iters=cg_max_iters,
        cg_rtol=cg_rtol,
        dtype=dtype,
        phi_refine=phi_refine,
    )
    data = ProblemData(
        ops=ops,
        spectral=spectral,
        cg_op=cg_op,
        c_prim_q=f((mean_av + mean_af) / 2.0),
        c_prim_z=f((mean_av + mean_af + mean_av) / 3.0),
        c_dual_alpha=f(mean_av),
        c_dual_beta=f((mean_av + mean_af) / 2.0),
        c_comp_rho=f(mean_av),
        c_comp_m=f(mean_af),
    )
    mu0 = np.zeros(v_pad)
    mu0[vertex_slot] = np.asarray(geometry["mu0"], dtype=np.float64)
    mu1 = np.zeros(v_pad)
    mu1[vertex_slot] = np.asarray(geometry["mu1"], dtype=np.float64)
    extras = {
        "area_mesh": float(area_f.sum()),
        "norm_constant_d": math.sqrt(2.0 * float(area_f.sum())),
        "av": av,
        "area_f": area_f,
        "mu0_padded": mu0,
        "mu1_padded": mu1,
        "vertex_slot": vertex_slot,
        "triangle_slot": triangle_slot,
    }
    return config, data, extras
