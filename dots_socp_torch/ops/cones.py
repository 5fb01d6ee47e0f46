"""Batched second-order cone projection (counterpart of
`dots_socp_tpu/ops/cones.py`).

One cone per (time interval, vertex): (z_fst[t,v]; {x_mid over corner slots
incident to v}, z_end[t,v]) is projected onto { (s, y) : s >= ||y|| } in the
diagonal-rescaled coordinates x_mid = diag_soc * z_mid. With n = ||tail||,
lam = clip(0.5 (1 + s/n), 0, 1): the tail scales by lam and the head becomes
lam * n (identity when lam saturates at 1, zero when lam = 0).
"""

from __future__ import annotations

import torch

from dots_socp_torch.ops.mesh_ops import SurfaceOps, vertex_gather, vertex_reduce


def project_soc(ops: SurfaceOps, to_fst, to_mid, to_end):
    """Project points onto the per-(t, v) second-order cones.

    to_fst : (T, V) cone head; to_mid : (T, 2, F, 3, 3) tail block, already
    scaled by diag_soc; to_end : (T, V) tail scalar. Returns (z_fst, z_mid,
    z_end) with z_mid scaled back to original z coordinates.
    """
    sq = (to_mid * to_mid).sum(dim=(1, 4))  # (T, F, 3corner)
    norm_sq = vertex_reduce(ops, sq) + to_end * to_end
    norm = torch.sqrt(norm_sq)

    # Zero-norm guard: for a zero tail the projection is the identity when
    # to_fst >= 0 and the origin when to_fst < 0. Flooring the norm at the
    # smallest normal float makes the lam formula produce exactly that
    # (clip saturates) instead of 0/0 = NaN poisoning the state.
    safe_norm = torch.clamp(norm, min=torch.finfo(norm.dtype).tiny)
    lam = torch.clamp(0.5 * (1.0 + to_fst / safe_norm), 0.0, 1.0)
    inside = lam >= 1.0  # point already inside the cone: identity

    z_fst = torch.where(inside, to_fst, lam * norm)
    z_end = lam * to_end

    lam_slots = vertex_gather(ops, lam) / ops.diag_soc
    z_mid = lam_slots[:, None, :, :, None] * to_mid
    return z_fst, z_mid, z_end
