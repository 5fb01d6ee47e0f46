"""Carry a problem and a state across from the JAX package.

`problem_from_reference` and `state_from_reference` take the reference's
`ProblemConfig`, `ProblemData` and `SolverState` with numpy leaves (e.g.
`jax.tree.map(np.asarray, data)`) and return the port's containers on a
given device, so that both sides can start from identical arrays. Only
attribute names are read; nothing here imports jax. The reference's dense
window tiles become the port's compressed `WindowOperator`, its per-shard
dense tiles the port's `ShardedWindow`; a space-sharded problem (halo
tables, sharded window, f64 ops) becomes one rank's shard.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dots_socp_torch.ops import resolve_device
from dots_socp_torch.ops.laplacian import CGOperator, SpectralFactor
from dots_socp_torch.ops.mesh_ops import SurfaceOps
from dots_socp_torch.ops.sharded_window import ShardedWindow, sharded_window_to_torch
from dots_socp_torch.ops.window_spmv import WindowOperator, compress_rows
from dots_socp_torch.parallel.halo import HaloTables
from dots_socp_torch.solver.problem import ProblemConfig, ProblemData
from dots_socp_torch.solver.state import SolverState


def _tensor(a, device, dtype=None):
    """numpy -> torch on `device` (a copy: the reference's arrays are
    read-only views); floats take `dtype` when given, else keep their own;
    integers become int64 (indices)."""
    a = np.array(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    t = torch.as_tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def _convert(nt, cls, device, dtype, skip=()):
    fields = {}
    for name in cls._fields:
        if name in skip or not hasattr(nt, name):
            continue
        value = getattr(nt, name)
        fields[name] = None if value is None else _tensor(value, device, dtype)
    return cls(**fields)


def _compress_tiles(a_tiles):
    """(lcol, vals, D) of dense window tiles: each row's nonzeros in column
    order, padded with (0, 0.0) as the port's builders pad them."""
    a_tiles = np.asarray(a_tiles, dtype=np.float32)
    rows, cols = np.nonzero(a_tiles)  # row-major: columns ascend in a row
    return compress_rows(rows, cols, a_tiles[rows, cols], a_tiles.shape[0])


def window_from_reference(wop, device="cpu") -> WindowOperator:
    """The port's window operator from the reference's dense-tile one."""
    device = resolve_device(device)
    a_tiles = np.asarray(wop.a_tiles)
    starts = np.asarray(wop.starts, dtype=np.int64)
    sub_off = np.asarray(wop.sub_off, dtype=np.int64)
    n_tiles = sub_off.shape[0]
    group = n_tiles // starts.shape[0]
    lcol, vals, d = _compress_tiles(a_tiles)
    f32 = lambda a: torch.as_tensor(np.array(a, dtype=np.float32), device=device)
    return WindowOperator(
        tile_start=torch.as_tensor(
            (np.repeat(starts, group) + sub_off).astype(np.int32), device=device
        ),
        lcol=torch.as_tensor(lcol, device=device),
        vals=torch.as_tensor(vals, device=device),
        perm=_tensor(wop.perm, device),
        iperm=_tensor(wop.iperm, device),
        av_p=f32(wop.av_p),
        jacobi_p=f32(wop.jacobi_p),
        s_p=f32(wop.s_p),
        defl_q_p=f32(wop.defl_q_p),
        tile_rows=a_tiles.shape[0] // n_tiles,
        width=a_tiles.shape[1],
        nnz_width=d,
    )


def sharded_window_from_reference(swop, device="cpu") -> ShardedWindow:
    """The port's per-shard window operator (every shard, as the port's
    builder returns it) from the reference's dense-tile one."""
    a_tiles = np.asarray(swop.a_tiles)  # (S, n_pad * TV, W)
    starts = np.asarray(swop.starts, dtype=np.int64)
    sub_off = np.asarray(swop.sub_off, dtype=np.int64)
    n_parts, n_tiles = sub_off.shape
    group = n_tiles // starts.shape[1]
    parts = [_compress_tiles(a) for a in a_tiles]
    dp = max(lc.shape[1] for lc, _, _ in parts)
    pad = lambda a: np.pad(a, ((0, 0), (0, dp - a.shape[1])))
    host = ShardedWindow(
        tile_start=np.repeat(starts, group, axis=1) + sub_off,
        lcol=np.stack([pad(lc) for lc, _, _ in parts]),
        vals=np.stack([pad(v) for _, v, _ in parts]),
        exp_codes=swop.exp_codes,
        win_codes=swop.win_codes,
        state_in=swop.state_in,
        state_out=swop.state_out,
        av_p=swop.av_p,
        jacobi_p=swop.jacobi_p,
        s_p=swop.s_p,
        defl_q_p=swop.defl_q_p,
        real_p=swop.real_p,
        tile_rows=a_tiles.shape[1] // n_tiles,
        width=a_tiles.shape[2],
        nnz_width=max(d for _, _, d in parts),
    )
    return sharded_window_to_torch(host, device)


def problem_from_reference(config, data, device="cpu", dtype=None, mesh=None):
    """(ProblemConfig, ProblemData) of the port from the reference's.

    dtype : torch dtype for the float leaves (None keeps each array's own);
    the refinement's float64 leaves and the window's float32 leaves keep
    theirs either way.
    mesh : for a space-sharded problem (built with space_partitions > 1),
    the `SolverMesh` whose rank's shard is returned, on mesh.device.
    """
    device = resolve_device(device)
    ref = dataclasses.asdict(config)
    port_config = ProblemConfig(
        **{f.name: ref[f.name] for f in dataclasses.fields(ProblemConfig)}
    )
    if dtype is not None:
        port_config = dataclasses.replace(
            port_config, dtype="float64" if dtype == torch.float64 else "float32"
        )
    ops = _convert(data.ops, SurfaceOps, device, dtype)
    ops_hi = None
    if getattr(data, "ops_hi", None) is not None:
        ops_hi = _convert(data.ops_hi, SurfaceOps, device, None)
    halo = None
    if getattr(data, "halo", None) is not None:
        halo = _convert(data.halo, HaloTables, device, None)
    spectral = None
    if data.spectral is not None:
        spectral = _convert(data.spectral, SpectralFactor, device, dtype)
    cg_op = None
    if data.cg_op is not None:
        hi = ("ell_w_hi", "av_hi", "shifts_hi", "u_time_hi")
        cg_op = _convert(data.cg_op, CGOperator, device, dtype, skip=("window", "swindow") + hi)
        extra = {
            name: _tensor(getattr(data.cg_op, name), device, torch.float64)
            for name in hi
            if getattr(data.cg_op, name, None) is not None
        }
        if getattr(data.cg_op, "window", None) is not None:
            extra["window"] = window_from_reference(data.cg_op.window, device)
        if getattr(data.cg_op, "swindow", None) is not None:
            extra["swindow"] = sharded_window_from_reference(data.cg_op.swindow, device)
        cg_op = cg_op._replace(**extra)
    consts = {
        name: _tensor(getattr(data, name), device, dtype)
        for name in ProblemData._fields
        if name.startswith("c_")
    }
    port_data = ProblemData(
        ops=ops, spectral=spectral, cg_op=cg_op, halo=halo, ops_hi=ops_hi, **consts
    )
    if mesh is not None:
        from dots_socp_torch.parallel.mesh import shard_problem

        port_data = shard_problem(mesh, port_data)
    return port_config, port_data


def state_from_reference(state, device="cpu", dtype=None, phi_dtype=None) -> SolverState:
    """The port's SolverState from the reference's (numpy leaves). dtype /
    phi_dtype: torch dtypes for the float leaves / phi (None keeps each
    array's own)."""
    device = resolve_device(device)
    fields = {
        name: _tensor(getattr(state, name), device, phi_dtype if name == "phi" else dtype)
        for name in SolverState._fields
    }
    return SolverState(**fields)
