"""Windowed cotan-Laplacian SpMV: the CG matvec, as a Hopper CUDA kernel.

Counterpart of `dots_socp_tpu/ops/pallas_spmv.py`. The CG phi-solve runs in
a vertex order (natural, RCM or PCA, picked by the builder) in which each
tile of TV consecutive rows touches only a window of W consecutive columns.
The TPU kernel multiplied dense (TV, W) tiles on its matrix unit; the CUDA
kernel (`csrc/window_spmv.cu`, which explains its design) stages each
tile's x window in shared memory and keeps only the nonzeros of L, as
window-local (column, value) pairs padded to a fixed row width D.

`window_matvec` launches the kernel on a CUDA tensor and runs the plain
PyTorch version (`window_matvec_plain`) on a CPU tensor; nothing else picks
between them. `KERNEL_LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; the plain version does not count).
KERNEL_LAUNCHES = 0

#: Time modes per kernel block: one per warp lane.
MODE_GROUP = 32

#: Shared memory one block may use on Hopper (227 KB). A tile candidate
#: whose staged window W * 32 modes * 4 B exceeds it is skipped.
SMEM_BYTES = 232_448

#: Lane width in the builder's traffic model. It is the reference's 128-lane
#: TPU buffer; keeping the model unchanged makes the builder choose the same
#: ordering, TV and G as `dots_socp_tpu.ops.pallas_spmv.build_window_tiles`.
_MODEL_LANES = 128


class WindowOperator(NamedTuple):
    """Compressed window form of the (V, V) cotan Laplacian, permuted.

    tile_start : (n_pad,) int32 -- window start of each tile of TV rows
                 (= starts[t // G] + sub_off[t] of the builder)
    lcol       : (n_pad * TV, D) int32 -- window-local column of each
                 nonzero of permuted row r (0 on padding slots)
    vals       : (n_pad * TV, D) float32 -- matching values (0.0 on padding)
    perm       : (V,) int64 -- new position -> old index (x_p = x[:, perm])
    iperm      : (V,) int64 -- inverse permutation
    av_p       : (V,) permuted vertex areas (float32)
    jacobi_p   : (T+1, V) permuted Jacobi preconditioner (float32)
    s_p        : (V,) permuted av^{-1/2} (float32)
    defl_q_p   : (V, k) row-permuted Ritz vectors (float32)
    tile_rows  : TV
    width      : W, the rows of x one tile stages
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


class WindowTiles(NamedTuple):
    """Host arrays of `build_window_tiles`.

    The first six fields are what the reference builder returns beside its
    dense tiles (super-window `starts`, `sub_off`, super-window width `ws`,
    `perm`, `iperm`, `meta`); the last three are the compressed form the
    CUDA kernel reads.
    """

    starts: np.ndarray
    sub_off: np.ndarray
    ws: int
    perm: np.ndarray
    iperm: np.ndarray
    meta: dict
    tile_start: np.ndarray
    lcol: np.ndarray
    vals: np.ndarray


def _tile_width(p_csr, tv):
    """Padded max window width over tv-row tiles of a permuted CSR matrix."""
    v = p_csr.shape[0]
    n_tiles = -(-v // tv)
    width = 8  # never zero; a multiple of 8
    for t in range(n_tiles):
        lo, hi = t * tv, min((t + 1) * tv, v)
        cols = p_csr.indices[p_csr.indptr[lo] : p_csr.indptr[hi]]
        if cols.size:
            width = max(width, int(cols.max()) - int(cols.min()) + 1)
    return -(-width // 8) * 8


def build_window_tiles(
    lap_space,
    tile_rows: int | None = None,
    coords=None,
    group: int | None = None,
) -> WindowTiles | None:
    """Host-side: order the Laplacian for narrow windows and cut it into tiles.

    The reference builder (`dots_socp_tpu/ops/pallas_spmv.py:90-218`) with
    one rule changed: its 12 MiB TPU VMEM budget gives way to Hopper's shared
    memory, so a candidate whose window W * 32 modes * 4 B exceeds 227 KB is
    skipped. Candidate orderings are natural, reverse Cuthill-McKee and (with
    `coords`) a sort along the dominant PCA axis; TV in {256, 512} and G in
    {1, 2, 4} unless pinned. The cheapest candidate under the reference's
    traffic model wins; its windows and tiles are the reference's (tested),
    but each tile row keeps only its nonzeros, taken straight from the
    permuted CSR. Returns None when no candidate fits; `cg_solve` then uses
    the ELL matvec.
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

    tv_grid = (256, 512) if tile_rows is None else (int(tile_rows),)
    g_grid = (1, 2, 4) if group is None else (int(group),)

    def tile_starts(p, tv):
        n_tiles = -(-v // tv)
        st = np.full(n_tiles, -1, dtype=np.int64)
        for t in range(n_tiles):
            lo, hi = t * tv, min((t + 1) * tv, v)
            cols = p.indices[p.indptr[lo] : p.indptr[hi]]
            if cols.size:
                st[t] = int(cols.min())
        # Structurally empty tiles inherit a neighbouring tile's start.
        for t in range(1, n_tiles):
            if st[t] < 0:
                st[t] = st[t - 1]
        for t in range(n_tiles - 2, -1, -1):
            if st[t] < 0:
                st[t] = st[t + 1]
        return np.maximum(st, 0)

    best = None
    for name, cand in candidates.items():
        p = csr[cand][:, cand].tocsr()
        for tv in tv_grid:
            w = _tile_width(p, tv)
            if w * MODE_GROUP * 4 > SMEM_BYTES:
                continue  # the staged window would not fit shared memory
            st = tile_starts(p, tv)
            n_tiles = st.shape[0]
            for g in g_grid:
                n_pad = -(-n_tiles // g) * g
                stp = np.concatenate([st, np.repeat(st[-1:], n_pad - n_tiles)])
                sup = stp.reshape(-1, g)
                s_sup = sup.min(axis=1)
                ws = int((sup - s_sup[:, None] + w).max())
                ws = -(-ws // 8) * 8
                traffic = v * w * 4 + s_sup.shape[0] * ws * _MODEL_LANES * 4
                if best is None or traffic < best[0]:
                    best = (traffic, name, cand, p, tv, w, g, st)
    if best is None:
        return None
    traffic, name, perm, p, tv, width, g, st = best

    n_tiles = st.shape[0]
    n_pad = -(-n_tiles // g) * g
    st = np.concatenate([st, np.repeat(st[-1:], n_pad - n_tiles)])
    starts = st.reshape(-1, g).min(axis=1).astype(np.int32)  # (n_super,)
    sub_off = (st - np.repeat(starts.astype(np.int64), g)).astype(np.int32)
    ws = int((st + width - np.repeat(starts.astype(np.int64), g)).max())
    ws = -(-ws // 8) * 8

    # Each permuted row's nonzeros in column order, at window-local columns,
    # padded to the widest row with (0, 0.0).
    p = p.copy()
    p.eliminate_zeros()
    p.sort_indices()
    counts = np.diff(p.indptr)
    d = max(int(counts.max(initial=0)), 1)
    rows = np.repeat(np.arange(v), counts)
    slots = np.arange(p.nnz) - np.repeat(p.indptr[:-1], counts)
    lcol = np.zeros((n_pad * tv, d), dtype=np.int32)
    vals = np.zeros((n_pad * tv, d), dtype=np.float32)
    lcol[rows, slots] = p.indices - st[rows // tv]
    vals[rows, slots] = p.data.astype(np.float32)

    iperm = np.empty(v, dtype=np.int32)
    iperm[perm] = np.arange(v, dtype=np.int32)
    meta = {
        "ordering": name,
        "tile_rows": int(tv),
        "width": int(width),
        "group": int(g),
        "super_width": int(ws),
        "traffic_bytes": int(traffic),
        "nnz_width": int(lcol.shape[1]),
    }
    return WindowTiles(
        starts=starts,
        sub_off=sub_off,
        ws=ws,
        perm=perm.astype(np.int32),
        iperm=iperm,
        meta=meta,
        tile_start=st.astype(np.int32),
        lcol=lcol,
        vals=vals,
    )


def window_operator(
    tiles: WindowTiles, av, jacobi, s_vec, defl_q, device="cpu"
) -> WindowOperator:
    """The device operator of `tiles`, with the preconditioner arrays
    permuted into window order in float32 (the CG work dtype of the kernel).
    av, s_vec (V,), jacobi (T+1, V) and defl_q (V, k) are in original order."""
    perm = np.asarray(tiles.perm, dtype=np.int64)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    def idx(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return WindowOperator(
        tile_start=idx(tiles.tile_start, torch.int32),
        lcol=idx(tiles.lcol, torch.int32),
        vals=f32(tiles.vals),
        perm=idx(perm, torch.int64),
        iperm=idx(tiles.iperm, torch.int64),
        av_p=f32(np.asarray(av)[perm]),
        jacobi_p=f32(np.asarray(jacobi)[:, perm]),
        s_p=f32(np.asarray(s_vec)[perm]),
        defl_q_p=f32(np.asarray(defl_q)[perm]),
        tile_rows=int(tiles.meta["tile_rows"]),
        width=int(tiles.meta["width"]),
    )


def window_matvec_plain(op: WindowOperator, x):
    """Plain PyTorch version of the kernel: P L P^T @ x for x (..., V) in
    permuted order. Gathers x at tile_start[row // TV] + lcol, multiplies by
    vals and sums each row, in float32."""
    v = op.perm.shape[0]
    row_start = op.tile_start.long().repeat_interleave(op.tile_rows)[:v]
    cols = row_start[:, None] + op.lcol[:v].long()  # (V, D) global columns
    xf = x.to(torch.float32)
    return (xf[..., cols] * op.vals[:v]).sum(-1).to(x.dtype)


def window_matvec(op: WindowOperator, x):
    """P L P^T @ x for x (..., V) in permuted order; at most 128 leading modes.

    On a CPU tensor: the plain version. On a CUDA tensor: the kernel, which
    takes float32 only; a refused launch raises.
    """
    if x.device.type == "cpu":
        return window_matvec_plain(op, x)
    if x.device.type != "cuda":
        raise ValueError(f"window_matvec: unsupported device {x.device}")
    return _window_matvec_cuda(op, x)


def _window_matvec_cuda(op: WindowOperator, x):
    global KERNEL_LAUNCHES
    from dots_socp_torch.ops import _build

    if x.dtype != torch.float32:
        raise TypeError(f"window kernel takes float32, got {x.dtype}")
    v = op.perm.shape[0]
    lead = tuple(x.shape[:-1])
    lanes = int(np.prod(lead)) if lead else 1
    if x.shape[-1] != v or lanes > 128:
        raise ValueError(
            f"window kernel: x of shape {tuple(x.shape)} against V={v}, "
            "at most 128 leading modes"
        )
    for name, dtype in (("tile_start", torch.int32), ("lcol", torch.int32), ("vals", torch.float32)):
        t = getattr(op, name)
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"window operator's {name} must be contiguous {dtype} on {x.device}")
    n_tiles = -(-v // op.tile_rows)
    if (op.tile_start.shape[0] < n_tiles or op.lcol.shape[0] < n_tiles * op.tile_rows
            or op.vals.shape != op.lcol.shape or op.width * MODE_GROUP * 4 > SMEM_BYTES):
        raise ValueError("window operator's arrays do not cover its tiles, or W is too wide")
    # Vertex-major (V, lanes) for coalesced window rows, as the reference
    # transposes at pallas_spmv.py:309-312.
    xt = x.reshape(lanes, v).t().contiguous()
    y = torch.empty((v, lanes), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):  # the C side launches on the current device
        err = lib.dots_window_spmv_f32(
            xt.data_ptr(), op.tile_start.data_ptr(), op.lcol.data_ptr(),
            op.vals.data_ptr(), y.data_ptr(), v, lanes, n_tiles, op.tile_rows,
            op.width, op.lcol.shape[1], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"window SpMV kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    if not lead:
        return y[:, 0]
    return y.t().reshape(lead + (v,))
