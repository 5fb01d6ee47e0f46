"""Space-sharded window SpMV: kernel B2, the CG matvec of a sharded solve.

Counterpart of `dots_socp_tpu/ops/sharded_window.py`. Each rank owns the
contiguous blocked row range of `parallel.partition.blocked_layout`.

Per shard, on the host, once per problem:

  1. The EXTENDED vertex set: the local block plus the remote columns its
     Laplacian rows reference.
  2. Reverse Cuthill-McKee on the extended subgraph (`_rcm_positions`)
     interleaves the remote vertices among the locals, so each tile of TV
     rows reaches only a narrow window of W extended positions.
  3. The CG state is carried in "compressed window order": the shard's
     local vertices sorted by extended-RCM rank (`state_in` / `state_out`).

Per matvec, on the device:

  exports = x_local[exp_codes]                      # boundary values
  buf     = all_gather(exports)                     # the one collective
  y       = kernel B2 on (x_local, buf)             # (lead, v_chunk)

Kernel B2 (`csrc/window_spmv.cu::dots_sharded_window_spmv_f32`) has the
body of B1 and gathers its window vector in the staging: window position p
of the shard holds [x_local ++ buf ++ 0][win_codes[p]], read by the kernel
through `win_codes`, so no (lead, Nw) window vector is ever written. (The
plain version builds it, `window_vector`.) As in B1, the TPU's dense
(TV, W) tiles become each row's nonzeros as window-local (column, value)
pairs, padded to a width DP that is a multiple of 4, taken straight from
the shard's CSR. The Mosaic-only parts of the reference's construction
(super-windows G / Ws, the VMEM budget, the 128-lane traffic model) are
gone; TV comes from B1's rule (`window_spmv.tile_candidates`) on one
shard's rows.

`shard_spmv` launches the kernel on CUDA tensors and runs the plain
version (`sharded_window_matvec_plain`) on CPU tensors; nothing else picks
between them. `KERNEL_LAUNCHES` counts the kernel's launches, those that
CUDA graph replays make included (`ops.graphs.register_counter`): inside a
captured segment the exports' all-gather and the kernel run at every
replay, on the buffers the capture allocated.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from dots_socp_torch.ops import graphs
from dots_socp_torch.ops.collectives import space_all_gather
from dots_socp_torch.ops.window_spmv import (
    MODE_GROUP,
    check_kernel_input,
    check_kernel_tiles,
    compress_rows,
    fits_block,
    tile_candidates,
)

#: Launches of kernel B2 in this process (the wrapper adds one per launch;
#: the plain version does not count).
KERNEL_LAUNCHES = 0


def _set_launches(n):
    global KERNEL_LAUNCHES
    KERNEL_LAUNCHES = n


# A launch recorded in a CUDA graph counts at every replay (`ops.graphs`).
graphs.register_counter(lambda: KERNEL_LAUNCHES, _set_launches, "sharded_window.launches")


class ShardedWindow(NamedTuple):
    """Per-shard compressed window form of the blocked (V, V) Laplacian.

    Built for every shard on the host (leading S axis on the first seven
    fields; V-long arrays whole); `parallel.mesh.shard_problem` keeps one
    shard's row of each and its (v_chunk,) block of the window-layout arrays.

    tile_start : (S, n_tiles) int32 window start of each tile of TV rows
    lcol       : (S, n_tiles * TV, DP) int32 window-local column of each
                 nonzero of compressed row r (0 on padding slots)
    vals       : (S, n_tiles * TV, DP) float32 matching values (0.0 padding)
    exp_codes  : (S, Wb) int64 compressed positions of the boundary values
                 each shard exports (padding repeats a valid position)
    win_codes  : (S, Nw) int32 gather codes of the window vector: < v_chunk
                 local compressed position, else v_chunk + owner * Wb +
                 rank in the gathered buffer; padding points at the zero slot
    state_in   : (S, v_chunk) int64 blocked-local index of the vertex at each
                 compressed window position (entry permute)
    state_out  : (S, v_chunk) int64 compressed position of each
                 blocked-local vertex (exit permute)
    av_p, s_p, real_p : (V,) float32 window-layout vertex areas, av^{-1/2},
                 real-vertex mask
    jacobi_p   : (T+1, V) float32 window-layout Jacobi preconditioner
    defl_q_p   : (V, k) float32 window-layout Ritz vectors
    tile_rows  : TV, a multiple of 16
    width      : W, the window positions one tile stages
    nnz_width  : D, the widest row's nonzero count (DP = D rounded up to 4)
    """

    tile_start: torch.Tensor
    lcol: torch.Tensor
    vals: torch.Tensor
    exp_codes: torch.Tensor
    win_codes: torch.Tensor
    state_in: torch.Tensor
    state_out: torch.Tensor
    av_p: torch.Tensor
    jacobi_p: torch.Tensor
    s_p: torch.Tensor
    defl_q_p: torch.Tensor
    real_p: torch.Tensor
    tile_rows: int
    width: int
    nnz_width: int


#: The trailing fields of ShardedWindow that are plain ints, not arrays.
_N_SCALARS = 3


def _rcm_positions(rows_csr, n_local, n_ext):
    """Extended-RCM rank of every extended node of one shard (the
    reference's `_rcm_positions`, `sharded_window.py:95-122`).

    rows_csr : (n_local, n_ext) CSR of the shard's rows over its extended
    column space (locals first). The ordering graph is the symmetrized
    pattern; isolated nodes (padding slots) sort to the end.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    pat = sp.csr_matrix(
        (np.ones_like(rows_csr.data), rows_csr.indices, rows_csr.indptr),
        shape=rows_csr.shape,
    )
    if n_ext == n_local:  # no remote columns: square symmetric pattern
        ext = pat
    else:
        ext = sp.bmat(
            [[pat[:, :n_local], pat[:, n_local:]], [pat[:, n_local:].T, None]],
            format="csr",
        )
    order = np.asarray(reverse_cuthill_mckee(ext, symmetric_mode=True))
    pos = np.empty(n_ext, dtype=np.int64)
    pos[order] = np.arange(n_ext)
    return pos


def _tile_starts(pos, ext_rows, crank, n_rows, tv):
    """(width, per-tile window start) of one shard's tiles of tv compressed
    rows, in window positions (`shard_tile_geometry` of the reference)."""
    n_tiles = -(-n_rows // tv)
    nnz_rows = np.repeat(np.arange(n_rows), np.diff(ext_rows.indptr))
    tile_of = crank[nnz_rows] // tv
    wpos = pos[ext_rows.indices]
    lo = np.full(n_tiles, np.iinfo(np.int64).max, dtype=np.int64)
    hi = np.full(n_tiles, -1, dtype=np.int64)
    np.minimum.at(lo, tile_of, wpos)
    np.maximum.at(hi, tile_of, wpos)
    filled = hi >= 0
    width = int((hi[filled] - lo[filled] + 1).max(initial=8))
    starts = np.where(filled, lo, -1)
    # Structurally empty tiles inherit a neighbouring tile's start.
    for t in range(1, n_tiles):
        if starts[t] < 0:
            starts[t] = starts[t - 1]
    for t in range(n_tiles - 2, -1, -1):
        if starts[t] < 0:
            starts[t] = starts[t + 1]
    return -(-max(width, 8) // 8) * 8, np.maximum(starts, 0)


def build_sharded_window(
    lap_space,
    v_chunk: int,
    n_parts: int,
    av: np.ndarray,
    jacobi: np.ndarray,
    s_vec: np.ndarray,
    defl_q: np.ndarray,
    real: np.ndarray,
    tile_rows: int | None = None,
    n_modes: int = MODE_GROUP,
):
    """Host-side: per-shard extended-RCM ordering, compressed window tiles,
    exchange codes and window-layout preconditioner copies.

    lap_space : scipy sparse (V, V) cotan Laplacian in BLOCKED order: shard s
        owns rows [s * v_chunk, (s + 1) * v_chunk).
    av / jacobi / s_vec / defl_q / real : preconditioner arrays in blocked
        order, copied out in window layout.
    tile_rows : TV; None picks the first of `tile_candidates` for one
        shard's rows and `n_modes` modes (every shard runs on a card of its
        own) whose block fits shared memory.

    Returns (ShardedWindow of numpy arrays for every shard, meta), or None
    when no candidate fits shared memory (the CG then uses the halo
    incidence matvec).
    """
    import scipy.sparse as sp

    csr = sp.csr_matrix(lap_space).tocsr()
    csr.sum_duplicates()
    v_pad = csr.shape[0]
    if v_pad != n_parts * v_chunk:
        raise ValueError(f"V={v_pad} is not {n_parts} shards of {v_chunk}")
    owner = np.arange(v_pad) // v_chunk

    # ---- per-shard extended sets + export lists ---------------------------
    remote_by_shard = []  # global indices of remote columns, sorted
    for s_id in range(n_parts):
        lo, hi = s_id * v_chunk, (s_id + 1) * v_chunk
        cols = csr.indices[csr.indptr[lo] : csr.indptr[hi]]
        remote_by_shard.append(np.unique(cols[(cols < lo) | (cols >= hi)]))
    # Export list of block o = every remote reference owned by o.
    export_by_block = [
        np.unique(
            np.concatenate(
                [r[owner[r] == o] for r in remote_by_shard] + [np.empty(0, dtype=np.int64)]
            )
        )
        for o in range(n_parts)
    ]
    wb = max(-(-max((e.size for e in export_by_block), default=1) // 8) * 8, 8)

    # ---- per-shard extended-RCM ordering and compressed order -------------
    shards = []  # (pos, ext_rows, order, crank) per shard
    nw = 8
    for s_id in range(n_parts):
        lo = s_id * v_chunk
        remote = remote_by_shard[s_id]
        n_ext = v_chunk + remote.size
        rows = csr[lo : lo + v_chunk]
        cols = rows.indices.copy()
        local_sel = (cols >= lo) & (cols < lo + v_chunk)
        cols[local_sel] -= lo
        if remote.size:
            ridx = np.searchsorted(remote, rows.indices)
            cols[~local_sel] = v_chunk + ridx[~local_sel]
        ext_rows = sp.csr_matrix((rows.data, cols, rows.indptr), shape=(v_chunk, n_ext))
        pos = _rcm_positions(ext_rows, v_chunk, n_ext)
        order = np.argsort(pos[:v_chunk], kind="stable")  # compressed -> local
        crank = np.empty(v_chunk, dtype=np.int64)
        crank[order] = np.arange(v_chunk)
        shards.append((pos, ext_rows, order, crank))
        nw = max(nw, n_ext)
    nw = -(-nw // 8) * 8

    # ---- TV: fill the SMs with one shard's rows ----------------------------
    # Each row keeps its nonzeros only (explicit zeros of the CSR dropped).
    kept = []
    for _, ext_rows, _, _ in shards:
        nz = ext_rows.copy()
        nz.eliminate_zeros()
        kept.append(nz)
    d = max(max(int(np.diff(nz.indptr).max(initial=0)), 1) for nz in kept)
    dp = -(-d // 4) * 4
    groups = -(-int(n_modes) // MODE_GROUP)
    for tv in tile_candidates(v_chunk, groups, tile_rows):
        geo = [_tile_starts(pos, ext, crank, v_chunk, tv) for pos, ext, _, crank in shards]
        width = max(g[0] for g in geo)
        if fits_block(tv, width, d):
            break
    else:
        return None
    n_tiles = -(-v_chunk // tv)

    # ---- assemble the arrays ----------------------------------------------
    tile_start = np.zeros((n_parts, n_tiles), dtype=np.int32)
    lcol = np.zeros((n_parts, n_tiles * tv, dp), dtype=np.int32)
    vals = np.zeros((n_parts, n_tiles * tv, dp), dtype=np.float32)
    exp_codes = np.zeros((n_parts, wb), dtype=np.int64)
    win_codes = np.full((n_parts, nw), v_chunk + n_parts * wb, dtype=np.int64)
    state_in = np.zeros((n_parts, v_chunk), dtype=np.int64)
    state_out = np.zeros((n_parts, v_chunk), dtype=np.int64)
    for s_id, ((pos, _, order, crank), (_, st), nz) in enumerate(zip(shards, geo, kept)):
        lo = s_id * v_chunk
        remote = remote_by_shard[s_id]
        state_in[s_id] = order
        state_out[s_id] = crank
        tile_start[s_id] = st

        # Export codes: compressed positions of this shard's exported
        # boundary vertices (export lists hold global indices).
        exp = export_by_block[s_id] - lo
        exp_codes[s_id, : exp.size] = crank[exp]
        if exp.size:
            exp_codes[s_id, exp.size :] = crank[exp[0]]

        # Window codes: where each window rank's value lives in
        # [x_local (compressed) ++ gathered export buffer ++ zero].
        n_ext = v_chunk + remote.size
        nodes = np.empty(n_ext, dtype=np.int64)
        nodes[pos] = np.arange(n_ext)  # window rank -> extended node
        is_local = nodes < v_chunk
        codes = np.empty(n_ext, dtype=np.int64)
        codes[is_local] = crank[nodes[is_local]]
        if remote.size:
            rg = remote[nodes[~is_local] - v_chunk]  # global remote index
            own = owner[rg]
            rank_in_owner = np.empty(rg.size, dtype=np.int64)
            for o in np.unique(own):
                m = own == o
                rank_in_owner[m] = np.searchsorted(export_by_block[o], rg[m])
            codes[~is_local] = v_chunk + own * wb + rank_in_owner
        win_codes[s_id, :n_ext] = codes

        # Nonzeros: row = compressed position, column = window position
        # minus the tile's start; each row's in column order.
        cr = crank[np.repeat(np.arange(v_chunk), np.diff(nz.indptr))]
        lc = pos[nz.indices] - st[cr // tv]
        sort = np.lexsort((lc, cr))
        lc_s, vals_s, _ = compress_rows(cr[sort], lc[sort], nz.data[sort], n_tiles * tv)
        lcol[s_id, :, : lc_s.shape[1]] = lc_s
        vals[s_id, :, : lc_s.shape[1]] = vals_s

    # Window-layout preconditioner copies (blocked index of each slot).
    perm_global = (np.arange(n_parts)[:, None] * v_chunk + state_in).reshape(-1)
    f32 = lambda a: np.asarray(a, dtype=np.float32)
    c_order = np.ascontiguousarray  # `a[:, perm]` comes back column-major
    meta = {
        "tile_rows": int(tv),
        "width": int(width),
        "window": int(nw),
        "export_width": int(wb),
        "nnz_width": int(d),
        "nnz_pad": int(dp),
        "tiles": int(n_tiles),
    }
    sw = ShardedWindow(
        tile_start=tile_start,
        lcol=lcol,
        vals=vals,
        exp_codes=exp_codes,
        win_codes=win_codes,
        state_in=state_in,
        state_out=state_out,
        av_p=f32(av)[perm_global],
        jacobi_p=c_order(f32(jacobi)[:, perm_global]),
        s_p=f32(s_vec)[perm_global],
        defl_q_p=f32(defl_q)[perm_global],
        real_p=f32(real)[perm_global],
        tile_rows=int(tv),
        width=int(width),
        nnz_width=int(d),
    )
    logging.getLogger(__name__).info(
        "sharded window SpMV: S=%d TV=%d W=%d D=%d Nw=%d Wb=%d",
        n_parts, tv, width, d, nw, wb,
    )
    return sw, meta


def sharded_window_to_torch(sw: ShardedWindow, device="cpu") -> ShardedWindow:
    """`build_sharded_window`'s numpy arrays as tensors on `device` (int32 tile arrays
    and window codes for the kernel, int64 index arrays, float32 values)."""

    def conv(name, a):
        if name in ("tile_start", "lcol", "win_codes"):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a.astype(np.float32), device=device)

    leaves = {n: conv(n, getattr(sw, n)) for n in ShardedWindow._fields[:-_N_SCALARS]}
    return sw._replace(**leaves)


def shard_of(sw: ShardedWindow, rank: int, device=None) -> ShardedWindow:
    """Shard `rank` of an every-shard ShardedWindow: its row of the
    per-shard arrays and its (v_chunk,) block of the window-layout arrays,
    contiguous, on `device` (None: where they are)."""
    n_parts, v_chunk = sw.state_in.shape
    blk = slice(rank * v_chunk, (rank + 1) * v_chunk)
    take = lambda x: x.contiguous() if device is None else x.contiguous().to(device)
    per_shard = {n: take(getattr(sw, n)[rank]) for n in ShardedWindow._fields[:7]}
    return sw._replace(
        **per_shard,
        av_p=take(sw.av_p[blk]),
        jacobi_p=take(sw.jacobi_p[:, blk]),
        s_p=take(sw.s_p[blk]),
        defl_q_p=take(sw.defl_q_p[blk]),
        real_p=take(sw.real_p[blk]),
    )


def window_permute(sw: ShardedWindow, x, inverse=False):
    """Shard-local permute of (lead..., v_chunk) arrays: forward = blocked
    -> compressed window order (gather by state_in), inverse = back (gather
    by state_out)."""
    return x[..., sw.state_out if inverse else sw.state_in]


def export_buffer(sw: ShardedWindow, mesh, x):
    """Every shard's exported boundary values, (lead..., S * Wb): one
    all-gather over the space group."""
    return space_all_gather(x[..., sw.exp_codes], mesh, dim=-1)


def window_vector(sw: ShardedWindow, x, buf):
    """The shard's window vector (lead..., Nw) from its state x (lead...,
    v_chunk, compressed window order) and the gathered export buffer. The
    plain version's input; kernel B2 gathers the same values in its staging."""
    zero = x.new_zeros(x.shape[:-1] + (1,))
    return torch.cat([x, buf, zero], dim=-1)[..., sw.win_codes.long()]


def sharded_window_matvec(sw: ShardedWindow, mesh, x):
    """P L P^T @ x on one shard: x (lead..., v_chunk) in compressed window
    order -> y (lead..., v_chunk), same order. The exports' all-gather, then
    kernel B2 (or its plain version on the CPU)."""
    return shard_spmv(sw, x, export_buffer(sw, mesh, x))


def sharded_window_matvec_plain(sw: ShardedWindow, xw):
    """Plain PyTorch version of kernel B2: rows of the shard's Laplacian
    times its window vector xw (lead..., Nw) -> (lead..., v_chunk). Gathers
    xw at tile_start[row // TV] + lcol, multiplies by vals and sums each
    row, in float32."""
    v_chunk = sw.state_in.shape[-1]
    row_start = sw.tile_start.long().repeat_interleave(sw.tile_rows)[:v_chunk]
    cols = row_start[:, None] + sw.lcol[:v_chunk].long()  # (v_chunk, DP)
    xf = xw.to(torch.float32)
    return (xf[..., cols] * sw.vals[:v_chunk]).sum(-1).to(xw.dtype)


def shard_spmv(sw: ShardedWindow, x, buf):
    """The shard's rows of L times its window vector, given as the shard's
    state x (lead..., v_chunk) and the gathered export buffer buf (lead...,
    S * Wb); at most 128 leading modes. On CPU tensors: the plain version on
    `window_vector(sw, x, buf)`. On CUDA tensors: kernel B2, which takes
    contiguous float32 only and gathers the window itself; a refused launch
    raises."""
    if x.device != buf.device:
        raise ValueError(f"shard_spmv: x on {x.device}, buf on {buf.device}")
    if x.device.type == "cpu":
        return sharded_window_matvec_plain(sw, window_vector(sw, x, buf))
    if x.device.type != "cuda":
        raise ValueError(f"shard_spmv: unsupported device {x.device}")
    return _shard_spmv_cuda(sw, x, buf)


def _shard_spmv_cuda(sw: ShardedWindow, x, buf):
    global KERNEL_LAUNCHES
    from dots_socp_torch.ops import _build

    what = "sharded window kernel"
    v_chunk = sw.state_in.shape[-1]
    lead, lanes = check_kernel_input(what, x, v_chunk)
    n_buf = buf.shape[-1] if buf.dim() else 0
    if tuple(buf.shape[:-1]) != lead:
        raise ValueError(f"{what}: buf of shape {tuple(buf.shape)} against x {tuple(x.shape)}")
    check_kernel_input(what + " (export buffer)", buf, n_buf)
    n_tiles = check_kernel_tiles(what, sw, v_chunk, x.device)
    codes = sw.win_codes
    if (codes.device != x.device or codes.dtype != torch.int32 or codes.dim() != 1
            or not codes.is_contiguous()):
        raise ValueError(f"{what}: win_codes must be one shard's contiguous int32 on {x.device}")
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.dots_sharded_window_spmv_f32(
            x.data_ptr(), buf.data_ptr(), codes.data_ptr(), sw.tile_start.data_ptr(),
            sw.lcol.data_ptr(), sw.vals.data_ptr(), y.data_ptr(), v_chunk, n_buf,
            codes.shape[0], lanes, n_tiles, sw.tile_rows, sw.width, sw.lcol.shape[1],
            sw.nnz_width, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sharded window SpMV kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return y
