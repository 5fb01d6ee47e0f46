"""Carry a problem and a state across from the JAX package.

`problem_from_reference` and `state_from_reference` take the reference's
`ProblemConfig`, `ProblemData` and `SolverState` with numpy leaves (e.g.
`jax.tree.map(np.asarray, data)`) and return the port's containers on a
given device, so that both sides can start from identical arrays. Only
attribute names are read; nothing here imports jax. The reference's dense
window tiles become the port's compressed `WindowOperator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dots_socp_torch.ops import resolve_device
from dots_socp_torch.ops.laplacian import CGOperator, SpectralFactor
from dots_socp_torch.ops.mesh_ops import SurfaceOps
from dots_socp_torch.ops.window_spmv import WindowOperator
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
    """(lcol, vals) of dense window tiles: each row's nonzeros in column
    order, padded to the widest row with (0, 0.0)."""
    a_tiles = np.asarray(a_tiles, dtype=np.float32)
    n_rows = a_tiles.shape[0]
    rows, cols = np.nonzero(a_tiles)  # row-major: columns ascend in a row
    counts = np.bincount(rows, minlength=n_rows)
    d = max(int(counts.max(initial=0)), 1)
    slots = np.arange(rows.size) - np.repeat(np.cumsum(counts) - counts, counts)
    lcol = np.zeros((n_rows, d), dtype=np.int32)
    vals = np.zeros((n_rows, d), dtype=np.float32)
    lcol[rows, slots] = cols
    vals[rows, slots] = a_tiles[rows, cols]
    return lcol, vals


def window_from_reference(wop, device="cpu") -> WindowOperator:
    """The port's window operator from the reference's dense-tile one."""
    device = resolve_device(device)
    a_tiles = np.asarray(wop.a_tiles)
    starts = np.asarray(wop.starts, dtype=np.int64)
    sub_off = np.asarray(wop.sub_off, dtype=np.int64)
    n_tiles = sub_off.shape[0]
    group = n_tiles // starts.shape[0]
    lcol, vals = _compress_tiles(a_tiles)
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
    )


def problem_from_reference(config, data, device="cpu", dtype=None):
    """(ProblemConfig, ProblemData) of the port from the reference's.

    dtype : torch dtype for the float leaves (None keeps each array's own);
    the refinement's float64 leaves and the window's float32 leaves keep
    theirs either way.
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
    spectral = None
    if data.spectral is not None:
        spectral = _convert(data.spectral, SpectralFactor, device, dtype)
    cg_op = None
    if data.cg_op is not None:
        hi = ("ell_w_hi", "av_hi", "shifts_hi", "u_time_hi")
        cg_op = _convert(data.cg_op, CGOperator, device, dtype, skip=("window",) + hi)
        extra = {
            name: _tensor(getattr(data.cg_op, name), device, torch.float64)
            for name in hi
            if getattr(data.cg_op, name, None) is not None
        }
        if getattr(data.cg_op, "window", None) is not None:
            extra["window"] = window_from_reference(data.cg_op.window, device)
        cg_op = cg_op._replace(**extra)
    consts = {
        name: _tensor(getattr(data, name), device, dtype)
        for name in ProblemData._fields
        if name.startswith("c_")
    }
    port_data = ProblemData(ops=ops, spectral=spectral, cg_op=cg_op, **consts)
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
