"""Periodic on-disk snapshot / resume of the solver state (counterpart of
`dots_socp_tpu/utils/snapshot.py`, and the same file format: a snapshot
written by either package is resumed by the other, given the same padding).

A crash-safe periodic snapshot of the full `SolverState` plus the host-side
schedule state (sigma cadence, adaptive-KKT cadence, converged mask, the
adaptive inner CG tolerance), so a resumed run continues the exact
trajectory instead of restarting schedules.

Format: a single .npz (atomic rename on write), one array per state field
under its name, and the host schedule's scalars JSON-encoded as bytes under
`__meta__`. The device tensors reach the host in one transfer per snapshot.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

SNAPSHOT_VERSION = 1

#: SolverState array fields, in NamedTuple order.
_STATE_FIELDS = (
    "phi", "A", "B", "lambda_c", "z_fst", "z_mid", "z_end",
    "mu", "E", "beta_fst", "beta_mid", "beta_end",
    "dt_phi", "dx_phi", "boundary",
    "r", "congestion", "constant_d", "norm_constant_d", "norm_boundary",
    "prim_scale", "dual_scale", "scale_z", "tau", "eps",
)


def _to_host(tensors):
    """numpy copies of `tensors`, moved off the device in one transfer: the
    tensors' bytes are packed into one buffer there and cut up here."""
    tensors = [t.detach().contiguous() for t in tensors]
    packed = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors]).cpu().numpy()
    out, offset = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(packed[offset : offset + n].view(dtype).reshape(tuple(t.shape)).copy())
        offset += n
    return out


def save_snapshot(path: str, state, host_meta: dict) -> None:
    """Atomically write `state` (SolverState) and host schedule metadata."""
    arrays = dict(zip(_STATE_FIELDS, _to_host(tuple(state))))
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"version": SNAPSHOT_VERSION, **host_meta}).encode(), dtype=np.uint8
    )
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_snapshot(path: str):
    """Return (state_arrays: dict[str, np.ndarray], host_meta: dict)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("version") != SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot version {meta.get('version')} != {SNAPSHOT_VERSION}"
            )
        arrays = {f: data[f] for f in _STATE_FIELDS}
    return arrays, meta


def state_from_arrays(arrays: dict, dtype, phi_dtype=None, device="cpu"):
    """Rebuild a SolverState on `device` from saved arrays (cast to the run
    dtype; `phi` to phi_dtype when given -- mixed-precision refinement
    carries it in float64)."""
    from dots_socp_torch.solver.state import SolverState

    return SolverState(
        **{
            f: torch.as_tensor(np.asarray(arrays[f])).to(
                device=device,
                dtype=phi_dtype if f == "phi" and phi_dtype is not None else dtype,
            )
            for f in _STATE_FIELDS
        }
    )
