"""One-time problem assembly: operators, Laplacian factor, KKT constants.

Counterpart of `dots_socp_tpu/solver/problem.py`. Everything is assembled
on the host with numpy/scipy and moved to the device once; on one device
the process keeps the last mesh's assembly for the next call on it
(`build_problem`, `clear`). With `space_partitions` > 1 the problem takes
the blocked shard layout (`parallel.partition`) and carries the halo
tables, the per-shard window operator and the f64 ops of the refinement,
for every shard; `parallel.mesh.shard_problem` then keeps one rank's shard.
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
    _ritz_cache_dir,
    build_cg_operator,
    build_spectral_factor,
)
from dots_socp_torch.ops.mesh_ops import SurfaceOps
from dots_socp_torch.geometry.surface import (
    build_incidence_table,
    cotan_laplacian,
    triangle_quantities,
    vertex_areas,
)
from dots_socp_torch.utils import trace
from dots_socp_torch.utils.types import GeometryData


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
    # (time, space) mesh axis sizes when the solve is sharded; with space > 1
    # and a blocked layout, the incidence ops take the shard-local halo path.
    mesh_axes: Optional[tuple] = None

    def spmd_kwargs(self, data) -> dict:
        """kwargs routing the mesh ops through the halo path on a shard
        (JAX `problem.py:62-70`); empty on one device."""
        if (
            self.mesh_axes is not None
            and self.mesh_axes[1] > 1
            and data.halo is not None
            and data.mesh is not None
        ):
            return {"halo": data.halo, "mesh": data.mesh}
        return {}

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
    # Halo tables (`parallel.halo.HaloTables`), present when the problem
    # was built with space_partitions > 1.
    halo: Optional[tuple] = None
    # float64 SurfaceOps (shared int tables), present on space-sharded
    # problems with phi_refine: the refinement's f64 true residual runs
    # through the halo incidence form.
    ops_hi: Optional[SurfaceOps] = None
    # The `SolverMesh` of this rank's shard (set by `shard_problem`).
    mesh: Optional[object] = None


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
    space_partitions: int = 1,
    mesh_axes=None,
    phi_refine="auto",
    device="cuda",
    mesh=None,
):
    """Assemble (ProblemConfig, ProblemData, extras) on `device`.

    pad_multiple : pad the vertex and triangle counts to this multiple.
        Dummy vertices carry mean vertex area, zero density and no incident
        real triangles; dummy triangles carry zero area/basis.
    space_partitions : number of space shards. With > 1, vertices and
        triangles are re-ordered into BFS-blocked per-shard chunks
        (replacing pad_multiple), `data.halo` carries every shard's exchange
        tables, and the CG operator the per-shard window tiles.
    mesh_axes : (time, space) mesh axis sizes, stored on the config.
    phi_refine : "auto" | "on" | "off" | bool. auto enables mixed-precision
        phi exactly when laplacian_mode == "cg" and dtype == "float32".
    mesh : the `SolverMesh` of the solve whose shards this problem will
        feed: its world rank 0 alone computes the Ritz pairs (`build_cg_operator`).

    extras holds host floats {norm_constant_d, area_mesh}, NumPy av / area_f
    (real sizes), padded mu0/mu1 and the vertex/triangle placement maps.

    Everything but the padded densities depends on the mesh and the options
    alone. On one device (no `mesh`, one space partition) that part is kept
    for the last mesh and its options (`_cached_assembly`), so that a call
    on the same mesh with new densities builds and moves nothing: it returns
    the same config, the same `data` and the same NumPy arrays (read-only)
    in `extras`. No caller may write a tensor of `data` in place.
    """
    device = resolve_device(device)
    options = dict(
        eps=eps,
        is_palm=is_palm,
        laplacian_mode=laplacian_mode,
        max_dense_vertices=max_dense_vertices,
        cg_max_iters=cg_max_iters,
        cg_rtol=cg_rtol,
        cg_deflation_k=cg_deflation_k,
        dtype=dtype,
        pad_multiple=pad_multiple,
        mesh_axes=tuple(mesh_axes) if mesh_axes is not None else None,
        phi_refine=phi_refine,
        device=device,
    )
    if mesh is not None or space_partitions > 1:
        # A sharded build runs collectives (`build_cg_operator`): never cached.
        config, data, extras = _assemble(
            n_time, geometry, space_partitions=space_partitions, mesh=mesh, **options
        )
    else:
        config, data, extras = _cached_assembly(n_time, geometry, options)
    padded = {}
    for name in ("mu0", "mu1"):
        mu = padded[f"{name}_padded"] = np.zeros(config.n_vertices)
        mu[extras["vertex_slot"]] = np.asarray(geometry[name], dtype=np.float64)
    return config, data, dict(extras, **padded)


#: `build_problem`'s lookups of the last mesh's assembly in this process.
ASSEMBLY_COUNTS = {"hits": 0, "misses": 0}
trace.add_counters(lambda: {f"assembly.{k}": v for k, v in ASSEMBLY_COUNTS.items()})

#: (key, (config, data, extras)) of the last mesh assembled on one device.
_KEPT = None


def clear():
    """Forget the kept assembly (its device tensors with it)."""
    global _KEPT
    _KEPT = None


def _content(a) -> tuple:
    """What a cache key holds of an array: its shape, dtype and bytes (a
    copy, so that an array edited in place after the call misses)."""
    a = np.asarray(a)
    return a.shape, a.dtype.str, a.tobytes()


def _cached_assembly(n_time, geometry, options):
    """`_assemble` on one device, kept for the last mesh: keyed on the
    content of the vertices and triangles, every option, and the factor
    cache's directory (a run pointed at a fresh one computes fresh factors).
    A miss drops the kept operators before it builds, so that a solve's
    peak device memory does not hold two problems."""
    global _KEPT
    key = (
        _content(geometry["vertices"]),
        _content(geometry["triangles"]),
        n_time,
        tuple(options.items()),
        _ritz_cache_dir(),
    )
    if _KEPT is not None and _KEPT[0] == key:
        ASSEMBLY_COUNTS["hits"] += 1
        return _KEPT[1]
    ASSEMBLY_COUNTS["misses"] += 1
    _KEPT = None
    config, data, extras = _assemble(n_time, geometry, **options)
    for name in ("av", "area_f", "vertex_slot", "triangle_slot"):
        extras[name].setflags(write=False)
    _KEPT = key, (config, data, extras)
    return _KEPT[1]


def _assemble(
    n_time,
    geometry,
    eps,
    is_palm,
    laplacian_mode,
    max_dense_vertices,
    cg_max_iters,
    cg_rtol,
    cg_deflation_k,
    dtype,
    pad_multiple,
    mesh_axes,
    phi_refine,
    device,
    space_partitions=1,
    mesh=None,
):
    """`build_problem` but the padded densities: everything the mesh and
    the options give."""
    vertices = np.asarray(geometry["vertices"], dtype=np.float64)
    triangles = np.asarray(geometry["triangles"])
    n_vertices = vertices.shape[0]
    n_triangles = triangles.shape[0]
    dt = 1.0 / n_time
    tdtype = torch.float64 if dtype == "float64" else torch.float32

    area_f, angles, grad_basis = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, n_vertices) / 3.0

    halo = None
    if space_partitions > 1:
        # Blocked shard-local layout (JAX `problem.py:175-201`): real
        # entities scattered into per-shard chunks.
        from dots_socp_torch.parallel.halo import HaloTables
        from dots_socp_torch.parallel.partition import blocked_layout

        layout = blocked_layout(triangles, n_vertices, space_partitions)
        v_pad = space_partitions * layout.v_chunk
        f_pad = space_partitions * layout.f_chunk
        vertex_slot = layout.vertex_slot.astype(np.int64)
        triangle_slot = layout.triangle_slot.astype(np.int64)
        tri_p = layout.tri_new.astype(np.int64)
        grad_basis_p = np.zeros((f_pad, 3, 3))
        grad_basis_p[triangle_slot] = grad_basis
        area_f_p = np.zeros(f_pad)
        area_f_p[triangle_slot] = area_f
        av_p = np.full(v_pad, av.mean() if av.size else 1.0)
        av_p[vertex_slot] = av
        table, mask = layout.inc_table, layout.inc_mask
        lap_triangles = vertex_slot[triangles]
        halo = HaloTables(
            *(
                torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
                for a in (layout.vtx_export, layout.tri_local, layout.slot_export, layout.inc_local)
            )
        )
    else:
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
        lap_triangles = triangles

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

    lap = cotan_laplacian(lap_triangles, angles, v_pad)

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
        coords_p = None
        if space_partitions == 1:
            # Padded coordinates enable the spatial-sort window ordering
            # (dummy vertices sit at the centroid; their Laplacian rows are
            # empty).
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
            shard_parts=space_partitions if space_partitions > 1 else None,
            mesh=mesh,
        )
    else:
        raise ValueError(f"unknown laplacian_mode: {laplacian_mode}")

    # Refinement on a space-sharded problem: the f64 true residual runs
    # through the halo incidence form, which needs f64 float leaves (JAX
    # `problem.py:315-334`). Int tables are shared with `ops`.
    ops_hi = None
    if phi_refine and space_partitions > 1:
        f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)
        ops_hi = ops._replace(
            grad_basis=f64(grad_basis_p), area_f=f64(area_f_p), av=f64(av_p), inc_mask=f64(mask)
        )

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
        mesh_axes=mesh_axes,
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
        halo=halo,
        ops_hi=ops_hi,
    )
    extras = {
        "area_mesh": float(area_f.sum()),
        "norm_constant_d": math.sqrt(2.0 * float(area_f.sum())),
        "av": av,
        "area_f": area_f,
        "vertex_slot": vertex_slot,
        "triangle_slot": triangle_slot,
    }
    return config, data, extras


def initial_state(config: ProblemConfig, data: ProblemData, extras: dict, **init_kw):
    """The whole initial state of a built problem, on the problem's device:
    `solver.state.init_state` with this problem's sizes, boundary densities
    and gradient operators. `init_kw` passes its other arguments on (a warm
    start, the penalty, the KKT normalisation constants, which stay 1
    otherwise)."""
    from dots_socp_torch.ops.mesh_ops import grad_space
    from dots_socp_torch.ops.time_stencils import decouple_space_adjoint, grad_time
    from dots_socp_torch.solver.state import init_state

    dt = config.stepsize_time
    return init_state(
        config.n_time,
        config.n_vertices,
        config.n_triangles,
        extras["mu0_padded"],
        extras["mu1_padded"],
        dt,
        grad_time_fn=lambda p: grad_time(dt, p),
        grad_space_fn=lambda p: grad_space(data.ops, p),
        decouple_adjoint_fn=decouple_space_adjoint,
        dtype=config.torch_dtype,
        phi_dtype=config.phi_dtype,
        device=data.ops.av.device,
        **init_kw,
    )
