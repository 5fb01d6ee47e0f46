"""Host-side blocked mesh layout for shard-local space sharding.

Counterpart of `dots_socp_tpu/parallel/partition.py`, copied as numpy-only
code (the port imports nothing of the JAX package). Computed once per
problem:

  * a BFS-blocked vertex ordering (contiguous graph-connected blocks, one per
    space shard, each padded to a common chunk size);
  * a triangle ordering grouping each triangle with the block owning the
    majority of its corners;
  * halo exchange tables: which (few, boundary) vertex values / corner slots
    each shard must export so every shard can complete its gathers and
    reductions from [local block ++ gathered halo buffer] only.

The consumers are `parallel.halo` (one all-gather of the exported entries
per gather or reduce) and `ops.sharded_window`. The BFS partitioner is
`geometry.native.bfs_partition`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from dots_socp_torch.geometry.native import bfs_partition


class BlockedLayout(NamedTuple):
    """Everything downstream needs about the blocked ordering.

    n_parts, v_chunk, f_chunk : shard count and per-shard padded sizes
        (v_pad = n_parts * v_chunk, f_pad = n_parts * f_chunk).
    vertex_slot : (V_real,) int32 -- padded new position of each original
        vertex (block-contiguous; dummy slots fill each block's tail).
    triangle_slot : (F_real,) int32 -- padded new position per triangle.
    tri_new : (f_pad, 3) int32 -- corner vertex positions (new order) per
        new triangle slot; dummy slots reference a vertex of their own
        block so gathers stay local.
    real_triangle : (f_pad,) bool -- True at real triangle slots.
    inc_table : (v_pad, D) int32 -- global incidence (flat codes
        f_new*3 + k), for the single-device / host path.
    inc_mask : (v_pad, D) float64
    vtx_export : (n_parts, Vb) int32 -- per shard, LOCAL vertex indices to
        export (boundary vertices referenced by other blocks' triangles).
    tri_local : (f_pad, 3) int32 -- gather codes: < v_chunk = local vertex,
        >= v_chunk = v_chunk + owner*Vb + rank into the halo buffer.
    slot_export : (n_parts, Fb) int32 -- per shard, LOCAL flat corner-slot
        indices to export (slots reduced into another block's vertex).
    inc_local : (v_pad, D) int32 -- reduce codes: < 3*f_chunk = local slot,
        >= 3*f_chunk = 3*f_chunk + owner*Fb + rank into the halo buffer.
    """

    n_parts: int
    v_chunk: int
    f_chunk: int
    vertex_slot: np.ndarray
    triangle_slot: np.ndarray
    tri_new: np.ndarray
    real_triangle: np.ndarray
    inc_table: np.ndarray
    inc_mask: np.ndarray
    vtx_export: np.ndarray
    tri_local: np.ndarray
    slot_export: np.ndarray
    inc_local: np.ndarray


#: Per-shard chunk sizes of the blocked layout are multiples of this.
LANE = 8


def _round_up(x: int, multiple: int) -> int:
    return max(-(-x // multiple) * multiple, multiple)


def _majority_owner(owners3: np.ndarray) -> np.ndarray:
    """Block owning the most corners of each triangle (ties -> smallest id)."""
    a, b, c = owners3[:, 0], owners3[:, 1], owners3[:, 2]
    out = np.minimum(np.minimum(a, b), c)  # all-distinct case: smallest id
    out = np.where(b == c, b, out)  # pair majorities override
    out = np.where(a == c, a, out)
    out = np.where(a == b, a, out)
    return out


def blocked_layout(
    triangles: np.ndarray, n_vertices: int, n_parts: int, lane: int = LANE
) -> BlockedLayout:
    """Compute the blocked layout and halo tables for `n_parts` space shards.

    lane : per-shard chunk sizes are rounded up to this multiple (alignment
        of every shard's slice).
    """
    triangles = np.asarray(triangles, dtype=np.int32)
    n_tri = triangles.shape[0]

    # ---- vertex blocks ------------------------------------------------------
    _, perm = bfs_partition(triangles, n_vertices, n_parts)
    target = -(-n_vertices // n_parts)
    v_chunk = _round_up(target, lane)
    vertex_slot = np.empty(n_vertices, dtype=np.int64)
    new_contig = np.arange(n_vertices)
    block = np.minimum(new_contig // target, n_parts - 1)
    rank = new_contig - block * target
    vertex_slot[perm] = block * v_chunk + rank
    v_pad = n_parts * v_chunk

    # ---- triangle blocks ----------------------------------------------------
    corners_new = vertex_slot[triangles]  # (F, 3) new vertex positions
    owner_f = _majority_owner(corners_new // v_chunk)
    counts = np.bincount(owner_f, minlength=n_parts)
    f_chunk = _round_up(int(counts.max()) if n_tri else 1, lane)
    f_pad = n_parts * f_chunk
    order = np.argsort(owner_f, kind="stable")
    within = np.arange(n_tri) - np.concatenate([[0], np.cumsum(counts)])[
        owner_f[order]
    ]
    triangle_slot = np.empty(n_tri, dtype=np.int64)
    triangle_slot[order] = owner_f[order] * f_chunk + within

    # Dummy triangle slots reference a vertex of their own block: a padding
    # vertex when the block has one (its state is pinned at zero), else the
    # block's first vertex (harmless: dummy triangles carry zero area/basis
    # and their corner slots are never reduced).
    real_count_v = np.minimum(
        np.maximum(n_vertices - np.arange(n_parts) * target, 0), target
    )
    block_dummy_vertex = np.where(
        real_count_v < v_chunk,
        np.arange(n_parts) * v_chunk + real_count_v,
        np.arange(n_parts) * v_chunk,
    )
    tri_owner_new = np.repeat(np.arange(n_parts), f_chunk)
    tri_new = np.broadcast_to(
        block_dummy_vertex[tri_owner_new][:, None], (f_pad, 3)
    ).copy()
    tri_new[triangle_slot] = corners_new
    real_triangle = np.zeros(f_pad, dtype=bool)
    real_triangle[triangle_slot] = True

    # ---- gather halo: boundary vertices each shard exports ------------------
    ref_owner = tri_new // v_chunk  # (f_pad, 3)
    remote_ref = real_triangle[:, None] & (ref_owner != tri_owner_new[:, None])
    exported_per_block = [
        np.unique(tri_new[remote_ref & (ref_owner == c)]) for c in range(n_parts)
    ]
    vb = _round_up(max((e.size for e in exported_per_block), default=1), lane)
    vtx_export = np.empty((n_parts, vb), dtype=np.int64)
    for c, exp in enumerate(exported_per_block):
        local = exp - c * v_chunk  # exported entries are block-c positions
        vtx_export[c] = np.pad(local, (0, vb - local.size))

    tri_local = tri_new - tri_owner_new[:, None] * v_chunk  # local by default
    for c in range(n_parts):
        sel = remote_ref & (ref_owner == c)
        if not sel.any():
            continue
        rank_in_c = np.searchsorted(exported_per_block[c], tri_new[sel])
        tri_local[sel] = v_chunk + c * vb + rank_in_c

    # ---- incidence (global codes) and reduce halo ---------------------------
    # Slots of real triangles, grouped by target vertex.
    slot_flat = (
        triangle_slot[:, None] * 3 + np.arange(3)[None, :]
    ).reshape(-1)  # flat code f_new*3+k per (original triangle, corner)
    target_v = corners_new.reshape(-1)
    deg = np.bincount(target_v, minlength=v_pad)
    max_deg = int(deg.max()) if deg.size else 0
    sort = np.argsort(target_v, kind="stable")
    starts = np.zeros(v_pad + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    pos_in_row = np.arange(target_v.size) - starts[target_v[sort]]
    inc_table = np.zeros((v_pad, max_deg), dtype=np.int64)
    inc_mask = np.zeros((v_pad, max_deg), dtype=np.float64)
    inc_table[target_v[sort], pos_in_row] = slot_flat[sort]
    inc_mask[target_v[sort], pos_in_row] = 1.0

    # Slots whose triangle block differs from the target vertex's block must
    # be exported by the triangle's block.
    slot_owner = slot_flat // 3 // f_chunk
    vertex_owner = target_v // v_chunk
    cross = slot_owner != vertex_owner
    slot_exported_per_block = [
        np.unique(slot_flat[cross & (slot_owner == c)]) for c in range(n_parts)
    ]
    fb = _round_up(
        max((e.size for e in slot_exported_per_block), default=1), lane
    )
    slot_export = np.empty((n_parts, fb), dtype=np.int64)
    for c, exp in enumerate(slot_exported_per_block):
        local = exp - c * f_chunk * 3
        slot_export[c] = np.pad(local, (0, fb - local.size))

    inc_local = inc_table - (inc_table // 3 // f_chunk) * f_chunk * 3
    for c in range(n_parts):
        sel = (inc_mask > 0) & (inc_table // 3 // f_chunk == c) & (
            np.arange(v_pad)[:, None] // v_chunk != c
        )
        if not sel.any():
            continue
        rank_in_c = np.searchsorted(slot_exported_per_block[c], inc_table[sel])
        inc_local[sel] = 3 * f_chunk + c * fb + rank_in_c

    return BlockedLayout(
        n_parts=n_parts,
        v_chunk=v_chunk,
        f_chunk=f_chunk,
        vertex_slot=vertex_slot.astype(np.int32),
        triangle_slot=triangle_slot.astype(np.int32),
        tri_new=tri_new.astype(np.int32),
        real_triangle=real_triangle,
        inc_table=inc_table.astype(np.int32),
        inc_mask=inc_mask,
        vtx_export=vtx_export.astype(np.int32),
        tri_local=tri_local.astype(np.int32),
        slot_export=slot_export.astype(np.int32),
        inc_local=inc_local.astype(np.int32),
    )
