"""Windowed cotan-Laplacian SpMV: the CG matvec, as a Hopper CUDA kernel.

Counterpart of `dots_socp_tpu/ops/pallas_spmv.py`. The CG phi-solve runs in
a vertex order (natural, RCM or PCA, picked by `build_window_tiles`) in which each
tile of TV consecutive rows touches only a window of W consecutive columns.
The TPU kernel multiplied dense (TV, W) tiles on its matrix unit; the CUDA
kernel (`csrc/window_spmv.cu`, which explains its design) stages each
tile's x window in shared memory and keeps only the nonzeros of L, as
window-local (column, value) pairs padded to a row width DP that is a
multiple of 4. It reads x and writes y modes-major, (lanes, V), as the CG
holds them: one launch per matvec, no transpose.

The operator's values are float32 (kernel B1) or float64 (kernel B1-f64,
the same body in float64 for the float64 CG: `build_window_tiles` and
`window_operator` with `value_bytes=8` / `dtype=torch.float64`).
`window_matvec` launches the kernel of the operator's dtype on a CUDA tensor
of that dtype and runs the plain PyTorch version (`window_matvec_plain`) on
a CPU tensor; nothing else picks between them. `KERNEL_LAUNCHES` counts B1's
launches, `KERNEL_LAUNCHES_F64` B1-f64's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dots_socp_torch.ops import graphs

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; the plain version does not count): B1, and B1-f64 apart.
KERNEL_LAUNCHES = 0
KERNEL_LAUNCHES_F64 = 0


def _set_launches(n):
    global KERNEL_LAUNCHES
    KERNEL_LAUNCHES = n


def _set_launches_f64(n):
    global KERNEL_LAUNCHES_F64
    KERNEL_LAUNCHES_F64 = n


# A launch recorded in a CUDA graph counts at every replay (`ops.graphs`).
graphs.register_counter(lambda: KERNEL_LAUNCHES, _set_launches, "window_spmv.launches")
graphs.register_counter(lambda: KERNEL_LAUNCHES_F64, _set_launches_f64,
                        "window_spmv.launches_f64")

#: Time modes per kernel block: one per warp lane.
MODE_GROUP = 32

#: Shared memory one block may use on Hopper (227 KB).
SMEM_BYTES = 232_448

#: Streaming multiprocessors of an H100: the tiles are cut to fill them.
SM_COUNT = 132

#: A kernel block runs warps of 16 rows each (8 in tiles of up to 192 rows),
#: at most 32 warps: TV is a multiple of 16 up to 512. Unpinned, the
#: builders go no lower than 64 rows, the smallest size timed.
ROWS_PER_WARP = 16
MIN_TILE_ROWS = 64
MAX_TILE_ROWS = 512


class WindowOperator(NamedTuple):
    """Compressed window form of the (V, V) cotan Laplacian, permuted.

    tile_start : (n_tiles,) int32 -- window start of each tile of TV rows
    lcol       : (n_tiles * TV, DP) int32 -- window-local column of each
                 nonzero of permuted row r (0 on padding slots)
    vals       : (n_tiles * TV, DP) float32 (B1) or float64 (B1-f64) --
                 matching values (0.0 on padding)
    perm       : (V,) int64 -- new position -> old index (x_p = x[:, perm])
    iperm      : (V,) int64 -- inverse permutation
    av_p       : (V,) permuted vertex areas (vals' dtype, as below)
    jacobi_p   : (T+1, V) permuted Jacobi preconditioner
    s_p        : (V,) permuted av^{-1/2}
    defl_q_p   : (V, k) row-permuted Ritz vectors
    tile_rows  : TV, a multiple of 16
    width      : W, the window positions one tile stages
    nnz_width  : D, the widest row's nonzero count (DP = D rounded up to 4)
    """

    tile_start: torch.Tensor
    lcol: torch.Tensor
    vals: torch.Tensor
    perm: torch.Tensor
    iperm: torch.Tensor
    av_p: torch.Tensor
    jacobi_p: torch.Tensor
    s_p: torch.Tensor
    defl_q_p: torch.Tensor
    tile_rows: int
    width: int
    nnz_width: int


class WindowTiles(NamedTuple):
    """Host arrays of `build_window_tiles`: the ordering (`perm`, `iperm`),
    the choice made (`meta`) and the compressed form the CUDA kernel reads."""

    perm: np.ndarray
    iperm: np.ndarray
    meta: dict
    tile_start: np.ndarray
    lcol: np.ndarray
    vals: np.ndarray


def smem_bytes(tile_rows: int, width: int, nnz_pad: int, value_bytes: int = 4) -> int:
    """Dynamic shared memory of one kernel block: the mbarrier, the tile's
    (lcol, vals) block, and the window win[32][W | 1], whose memory the output
    tile ytile[32][TV + 1] reuses; values of `value_bytes` (B1-f64: 8)."""
    tile_floats = MODE_GROUP * max(width | 1, tile_rows + 1)
    return 16 + tile_rows * nnz_pad * (4 + value_bytes) + tile_floats * value_bytes


def tile_candidates(n_rows: int, groups: int = 1, tile_rows: int | None = None):
    """Tile sizes in the order `build_window_tiles` and `build_sharded_window`
    take them (the first whose block fits shared memory): for k = 1, 2, ...
    the smallest multiple of 16 in [64, 512] that cuts the rows, times the
    mode groups, into at most k blocks per SM. Timed on an H100 at every
    size of a grid, one wave of blocks beat every tiling of more, smaller
    or fewer, larger tiles (PERF.md). A pinned `tile_rows` is the only
    candidate."""
    if tile_rows is not None:
        tv = int(tile_rows)
        if tv < ROWS_PER_WARP or tv > MAX_TILE_ROWS or tv % ROWS_PER_WARP:
            raise ValueError(f"tile_rows must be a multiple of 16 in [16, 512], got {tv}")
        return (tv,)
    sizes = []
    waves = 0
    while not sizes or sizes[-1] > MIN_TILE_ROWS:
        waves += 1
        per_block = -(-n_rows * groups // (SM_COUNT * waves))
        tv = max(-(-per_block // ROWS_PER_WARP) * ROWS_PER_WARP, MIN_TILE_ROWS)
        if tv <= MAX_TILE_ROWS and tv not in sizes:
            sizes.append(tv)
    return tuple(sizes)


def fits_block(tile_rows: int, width: int, nnz: int, value_bytes: int = 4) -> bool:
    """Whether one kernel block of such a tile fits shared memory."""
    nnz_pad = -(-max(nnz, 1) // 4) * 4
    return smem_bytes(tile_rows, width, nnz_pad, value_bytes) <= SMEM_BYTES


def _tile_geometry(p_csr, tv):
    """(padded max window width, per-tile window start) over tv-row tiles of
    a permuted CSR matrix with sorted indices."""
    v = p_csr.shape[0]
    n_tiles = -(-v // tv)
    counts = np.diff(p_csr.indptr)
    filled = counts > 0
    big = np.iinfo(np.int64).max
    lo = np.full(n_tiles * tv, big, dtype=np.int64)
    hi = np.full(n_tiles * tv, -1, dtype=np.int64)
    lo[:v][filled] = p_csr.indices[p_csr.indptr[:-1][filled]]
    hi[:v][filled] = p_csr.indices[p_csr.indptr[1:][filled] - 1]
    lo = lo.reshape(n_tiles, tv).min(axis=1)
    hi = hi.reshape(n_tiles, tv).max(axis=1)
    has = hi >= 0
    width = int((hi[has] - lo[has] + 1).max(initial=8))  # never zero
    st = np.where(has, lo, -1)
    # Structurally empty tiles inherit a neighbouring tile's start.
    for t in range(1, n_tiles):
        if st[t] < 0:
            st[t] = st[t - 1]
    for t in range(n_tiles - 2, -1, -1):
        if st[t] < 0:
            st[t] = st[t + 1]
    return -(-max(width, 8) // 8) * 8, np.maximum(st, 0)


def compress_rows(rows, lcols, data, n_rows_pad, dtype=np.float32):
    """(lcol, vals, D): nonzeros given as (row, window-local column, value)
    triples sorted by row then column, laid out one row per line and padded
    with (0, 0.0) to DP = D rounded up to a multiple of 4, D the widest row;
    values in `dtype`."""
    counts = np.bincount(rows, minlength=n_rows_pad)
    d = max(int(counts.max(initial=0)), 1)
    dp = -(-d // 4) * 4
    slots = np.arange(rows.size) - np.repeat(np.cumsum(counts) - counts, counts)
    lcol = np.zeros((n_rows_pad, dp), dtype=np.int32)
    vals = np.zeros((n_rows_pad, dp), dtype=dtype)
    lcol[rows, slots] = lcols
    vals[rows, slots] = np.asarray(data, dtype=dtype)
    return lcol, vals, d


def build_window_tiles(
    lap_space,
    tile_rows: int | None = None,
    coords=None,
    n_modes: int = MODE_GROUP,
    value_bytes: int = 4,
) -> WindowTiles | None:
    """Host-side: order the Laplacian for narrow windows and cut it into tiles.

    The candidate orderings are the reference's
    (`dots_socp_tpu/ops/pallas_spmv.py:90-218`): natural, reverse
    Cuthill-McKee and (with `coords`) a sort along the dominant PCA axis. Its
    TPU traffic model, super-windows G and 12 MiB budget are gone: TV is the
    first of `tile_candidates` for `n_modes` modes (or is pinned) at which
    some ordering's block fits the 227 KB of shared memory, and the ordering
    with the narrowest window there wins, as in the reference (tested tile
    for tile). Each tile row keeps only its nonzeros, taken straight from
    the permuted CSR. `value_bytes` 8 cuts the tiles for B1-f64's block
    (float64 values and window) and stores the values in float64. Returns
    None when no candidate fits; `cg_solve` then uses the ELL matvec.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = sp.csr_matrix(lap_space)
    csr.sum_duplicates()
    v = csr.shape[0]

    candidates = {"natural": np.arange(v, dtype=np.int64)}
    try:
        candidates["rcm"] = np.asarray(
            reverse_cuthill_mckee(csr, symmetric_mode=True), dtype=np.int64
        )
    except ValueError:  # scipy rejects some degenerate graphs; skip the candidate
        pass
    if coords is not None and len(coords) == v:
        c = np.asarray(coords, dtype=np.float64)
        c = c - c.mean(axis=0)
        _, u = np.linalg.eigh(c.T @ c)
        candidates["spatial"] = np.argsort(
            c @ u[:, -1], kind="stable"
        ).astype(np.int64)

    # The windows span every stored entry (explicit zeros included, as in
    # the reference); columns in order.
    permuted = {}
    for name, cand in candidates.items():
        p = csr[cand][:, cand].tocsr()
        p.sort_indices()
        permuted[name] = p
    best = None
    for tv in tile_candidates(v, -(-int(n_modes) // MODE_GROUP), tile_rows):
        for name, p in permuted.items():
            w, st = _tile_geometry(p, tv)
            nnz = int(np.diff(p.indptr).max(initial=0))
            if fits_block(tv, w, nnz, value_bytes) and (best is None or w < best[0]):
                best = (w, name, tv, st)
        if best is not None:
            break
    if best is None:
        return None
    width, name, tv, st = best
    perm, p = candidates[name], permuted[name]

    # Each permuted row keeps its nonzeros only, in column order.
    p.eliminate_zeros()
    counts = np.diff(p.indptr)
    rows = np.repeat(np.arange(v), counts)
    lcol, vals, d = compress_rows(rows, p.indices - st[rows // tv], p.data, st.shape[0] * tv,
                                  np.float64 if value_bytes == 8 else np.float32)

    iperm = np.empty(v, dtype=np.int32)
    iperm[perm] = np.arange(v, dtype=np.int32)
    meta = {
        "ordering": name,
        "tile_rows": int(tv),
        "width": int(width),
        "nnz_width": int(d),
        "nnz_pad": int(lcol.shape[1]),
        "tiles": int(st.shape[0]),
        "smem_bytes": smem_bytes(tv, width, lcol.shape[1], value_bytes),
    }
    return WindowTiles(
        perm=perm.astype(np.int32),
        iperm=iperm,
        meta=meta,
        tile_start=st.astype(np.int32),
        lcol=lcol,
        vals=vals,
    )


def window_operator(
    tiles: WindowTiles, av, jacobi, s_vec, defl_q, device="cpu", dtype=torch.float32
) -> WindowOperator:
    """The device operator of `tiles`, with the preconditioner arrays
    permuted into window order in `dtype` (the CG work dtype of the kernel:
    float32 for B1, float64 for B1-f64, whose tiles hold float64 values).
    av, s_vec (V,), jacobi (T+1, V) and defl_q (V, k) are in original order."""
    perm = np.asarray(tiles.perm, dtype=np.int64)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def leaf(a):
        # C order: `a[:, perm]` comes back column-major from numpy, and the CG
        # vectors computed from such a leaf would inherit its layout, while
        # the kernel reads the CG state modes-major, contiguous.
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np_dtype), device=device)

    def idx(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return WindowOperator(
        tile_start=idx(tiles.tile_start, torch.int32),
        lcol=idx(tiles.lcol, torch.int32),
        vals=leaf(tiles.vals),
        perm=idx(perm, torch.int64),
        iperm=idx(tiles.iperm, torch.int64),
        av_p=leaf(np.asarray(av)[perm]),
        jacobi_p=leaf(np.asarray(jacobi)[:, perm]),
        s_p=leaf(np.asarray(s_vec)[perm]),
        defl_q_p=leaf(np.asarray(defl_q)[perm]),
        tile_rows=int(tiles.meta["tile_rows"]),
        width=int(tiles.meta["width"]),
        nnz_width=int(tiles.meta["nnz_width"]),
    )


def window_matvec_plain(op: WindowOperator, x):
    """Plain PyTorch version of the kernel: P L P^T @ x for x (..., V) in
    permuted order. Gathers x at tile_start[row // TV] + lcol, multiplies by
    vals and sums each row, in the dtype of vals."""
    v = op.perm.shape[0]
    row_start = op.tile_start.long().repeat_interleave(op.tile_rows)[:v]
    cols = row_start[:, None] + op.lcol[:v].long()  # (V, D) global columns
    xf = x.to(op.vals.dtype)
    return (xf[..., cols] * op.vals[:v]).sum(-1).to(x.dtype)


def window_matvec(op: WindowOperator, x):
    """P L P^T @ x for x (..., V) in permuted order; at most 128 leading modes.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel of the
    operator's dtype (B1: float32, B1-f64: float64), which takes contiguous x
    of that dtype only; a refused launch raises.
    """
    if x.device.type == "cpu":
        return window_matvec_plain(op, x)
    if x.device.type != "cuda":
        raise ValueError(f"window_matvec: unsupported device {x.device}")
    return _window_matvec_cuda(op, x)


def check_kernel_input(what, x, n_last, dtype=torch.float32):
    """The kernels' common input contract: contiguous `dtype` of shape
    (..., n_last) with at most 128 leading modes. Returns (lead shape, lanes)."""
    if x.dtype != dtype:
        raise TypeError(f"{what} takes {dtype}, got {x.dtype}")
    lead = tuple(x.shape[:-1])
    lanes = int(np.prod(lead)) if lead else 1
    if x.dim() == 0 or x.shape[-1] != n_last or not 1 <= lanes <= 128:
        raise ValueError(
            f"{what}: x of shape {tuple(x.shape)} against a last axis of {n_last}, "
            "1 to 128 leading modes"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what} reads x modes-major in place: it must be contiguous")
    return lead, lanes


def check_kernel_tiles(what, op, n_rows, device, values=torch.float32):
    """The tile arrays of a window operator (B1's, B1-f64's with `values`
    float64, or one shard's of B2) against what the kernel reads; returns the
    tile count."""
    for name, dtype in (("tile_start", torch.int32), ("lcol", torch.int32), ("vals", values)):
        t = getattr(op, name)
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {dtype} on {device}")
    n_tiles = -(-n_rows // op.tile_rows)
    dp = op.lcol.shape[-1]
    if (op.tile_start.dim() != 1 or op.tile_start.shape[0] < n_tiles or op.lcol.dim() != 2
            or op.lcol.shape[0] < n_tiles * op.tile_rows or op.vals.shape != op.lcol.shape
            or dp % 4 or op.nnz_width > dp or op.tile_rows % ROWS_PER_WARP
            or not ROWS_PER_WARP <= op.tile_rows <= MAX_TILE_ROWS
            or smem_bytes(op.tile_rows, op.width, dp, values.itemsize) > SMEM_BYTES):
        raise ValueError(f"{what}: the tile arrays do not cover the rows, or do not fit a block")
    return n_tiles


def _window_matvec_cuda(op: WindowOperator, x):
    global KERNEL_LAUNCHES, KERNEL_LAUNCHES_F64
    from dots_socp_torch.ops import _build

    v = op.perm.shape[0]
    values = op.vals.dtype
    if values not in (torch.float32, torch.float64):
        raise TypeError(f"window kernel: values of {values}; B1 takes float32, B1-f64 float64")
    lead, lanes = check_kernel_input("window kernel", x, v, values)
    n_tiles = check_kernel_tiles("window kernel", op, v, x.device, values)
    y = torch.empty_like(x)
    lib = _build.load()
    f64 = values == torch.float64
    kernel = lib.dots_window_spmv_f64 if f64 else lib.dots_window_spmv_f32
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = kernel(
            x.data_ptr(), op.tile_start.data_ptr(), op.lcol.data_ptr(),
            op.vals.data_ptr(), y.data_ptr(), v, v, lanes, n_tiles, op.tile_rows,
            op.width, op.lcol.shape[1], op.nnz_width,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"window SpMV kernel launch failed: CUDA error {err}")
    if f64:
        KERNEL_LAUNCHES_F64 += 1
    else:
        KERNEL_LAUNCHES += 1
    return y
