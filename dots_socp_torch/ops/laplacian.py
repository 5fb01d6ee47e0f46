"""Space-time Laplacian inverse (counterpart of `dots_socp_tpu/ops/laplacian.py`).

The phi-step solves (L_time (x) diag(av) + I (x) L_space) phi = rhs on the
(T+1, V) grid. The time Laplacian is diagonalised, which splits the system
into T+1 shifted spatial solves, done one of two ways:

* spectral (dense factor, small meshes): with C = av^{-1/2}(-L)av^{-1/2} =
  Q diag(w) Q^T, every shifted solve is two (T+1, V) x (V, V) GEMMs
  (`spectral_solve`), in full FP32/FP64 (TF32 is pinned off in `ops`);
* matrix-free CG (large meshes): Jacobi plus low-rank Ritz-deflation
  preconditioned CG batched over all T+1 shifts (`cg_solve`), with f64
  iterative refinement around the f32 inner CG. The inner matvec is the
  windowed SpMV of `ops.window_spmv` (kernel B1 on the card) when the
  work dtype is float32, B1-f64 when it is float64 (a float64 solve, no
  refinement); the padded-ELL gather otherwise. On one shard of a
  space-sharded problem it is the per-shard window SpMV of
  `ops.sharded_window` (kernel B2), or the halo incidence form; every dot
  product and deflation product then sums over the shards
  (`ops.collectives`). On one card with the window SpMV, the rest of each
  inner iteration is kernel K4 (`ops.cg_step`), in float64 K4-f64.

The host-side builders are numpy/scipy copies of the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from dots_socp_torch.ops import cg_step as fused
from dots_socp_torch.ops import graphs
from dots_socp_torch.ops.collectives import object_from_rank0, space_any, space_sum
from dots_socp_torch.ops.mesh_ops import SurfaceOps, laplacian_apply
from dots_socp_torch.ops.sharded_window import (
    ShardedWindow,
    build_sharded_window,
    sharded_window_matvec,
    sharded_window_to_torch,
    window_permute,
)
from dots_socp_torch.ops.window_spmv import (
    WindowOperator,
    build_window_tiles,
    window_matvec,
    window_operator,
)
from dots_socp_torch.utils import trace

log = logging.getLogger(__name__)


def build_time_laplacian(n_time: int, stepsize_time: float) -> np.ndarray:
    """Dense (T+1, T+1) Neumann 1-D Laplacian, scaled by 1/dt^2.

    Interior rows are the [1, -2, 1] stencil; boundary rows [-1, 1].
    Negative semidefinite.
    """
    n = n_time + 1
    lap = np.zeros((n, n))
    idx = np.arange(1, n - 1)
    lap[idx, idx] = -2.0
    lap[idx, idx - 1] = 1.0
    lap[idx, idx + 1] = 1.0
    lap[0, 0] = lap[-1, -1] = -1.0
    lap[0, 1] = lap[-1, -2] = 1.0
    return lap / stepsize_time**2


class SpectralFactor(NamedTuple):
    """Precomputed spectral factorization of the space-time Laplacian.

    u_time : (T+1, T+1) eigenvectors of the time Laplacian
    s      : (V,) av^{-1/2}
    q      : (V, V) eigenvectors of C (ascending eigenvalues w)
    invfac : (T+1, V) masked 1 / (lam_a - eps - w_i)
    """

    u_time: torch.Tensor
    s: torch.Tensor
    q: torch.Tensor
    invfac: torch.Tensor


def build_spectral_factor(
    n_time: int,
    stepsize_time: float,
    av: np.ndarray,
    lap_space,
    eps: float = 0.0,
    dtype=torch.float32,
    device="cpu",
) -> SpectralFactor:
    """Factor the pencil once at setup, with host LAPACK eigh (the
    reference's default, `laplacian.py:102-106`); the factor then moves to
    `device` once."""
    pairs = spectral_eigenpairs(n_time, stepsize_time, av, lap_space, dtype)
    return spectral_factor_from_eigh(*pairs, eps=eps, dtype=dtype, device=device)


def spectral_eigenpairs(n_time: int, stepsize_time: float, av: np.ndarray, lap_space, dtype):
    """Host (lam_t, u_time, s, w, q): the time Laplacian's eigenpairs,
    s = av^{-1/2}, and the eigenpairs of C = av^{-1/2}(-L)av^{-1/2}
    (float64 eigh; cached as `dtype` stores them)."""
    lap_time = build_time_laplacian(n_time, stepsize_time)
    lam_t, u_time = np.linalg.eigh(lap_time)  # lam_t <= 0 ascending

    av = np.asarray(av, dtype=np.float64)
    s = 1.0 / np.sqrt(av)
    dense = lap_space.toarray() if hasattr(lap_space, "toarray") else np.asarray(lap_space)
    c = -(s[:, None] * dense * s[None, :])
    c = 0.5 * (c + c.T)  # enforce symmetry
    w, q = _spectral_eigh_cached(lap_space, av, c, dtype)
    return lam_t, u_time, s, w, q


def spectral_factor_from_eigh(lam_t, u_time, s, w, q, eps=0.0, dtype=torch.float32, device="cpu"):
    """The SpectralFactor of host eigenpairs: the time Laplacian's (lam_t,
    u_time), C's (w, q) and s = av^{-1/2}, cast to `dtype` on `device`."""

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    w = t(w)
    lam_t = t(lam_t)
    denom = (lam_t[:, None] - eps) - w[None, :]  # (T+1, V), <= 0
    scale = w.max() - lam_t.min() + 1.0
    tiny = t(1e-12 if dtype == torch.float64 else 1e-6) * scale
    invfac = torch.where(denom.abs() > tiny, 1.0 / denom, torch.zeros_like(denom))
    return SpectralFactor(u_time=t(u_time), s=t(s), q=t(q), invfac=invfac)


def _spectral_eigh_cached(lap_space, av, c, dtype, min_cache_v: int = 4096):
    """Host eigh of C = av^{-1/2}(-L)av^{-1/2} with an on-disk cache keyed by
    (L_space, av, dtype); the same cache files as the reference's. Small
    factors (V < min_cache_v) are not cached. Cache IO failures fall back to
    computing."""
    import hashlib
    import os

    v = av.shape[0]
    if v < min_cache_v or not hasattr(lap_space, "tocsr"):
        return np.linalg.eigh(c)

    import scipy.sparse as sp

    csr = sp.csr_matrix(lap_space)
    csr.sum_duplicates()
    dtype_tag = "f64" if dtype == torch.float64 else "f32"
    h = hashlib.sha256()
    h.update(dtype_tag.encode())
    for part in (
        np.int64([v]),
        csr.indptr.astype(np.int64),
        csr.indices.astype(np.int64),
        np.asarray(csr.data, dtype=np.float64),
        np.asarray(av, dtype=np.float64),
    ):
        h.update(part.tobytes())
    cache_dir = _ritz_cache_dir()
    path = os.path.join(cache_dir, f"eigh_{h.hexdigest()[:32]}.npz")
    try:
        with np.load(path) as f:
            return np.array(f["w"]), np.array(f["q"])  # writable copies
    except (OSError, KeyError, ValueError):
        pass
    w, q = np.linalg.eigh(c)
    store = np.float64 if dtype == torch.float64 else np.float32
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, w=w.astype(store), q=q.astype(store))
        os.replace(tmp, path)
    except OSError:
        pass
    return w, q


# The longest summation chain of `blocked_matmul`. A host BLAS sums K in
# blocks of a few hundred and the TPU's MXU in passes of 128; the card's
# SGEMM sums far longer chains. One library GEMM over all of K made the
# card's float32 spectral solve 2.5-3.7x less accurate than the host's in
# the energy norm at K = 4,096-12,288 (the `make main` sweep's larger
# meshes then stalled above tol 1e-4). Chains of 32-256 bring it to
# 0.4-1.14x of the host's, chains of 512 to 1.5-2.9x
# (`scripts/spectral_floor.py`, on an H100): 256 is the longest within 1.25x.
SPECTRAL_BLOCK_K = 256


@functools.lru_cache(maxsize=64)
def chain_length(k: int, longest: int = SPECTRAL_BLOCK_K) -> int:
    """The chain length `blocked_matmul` sums K in: the largest divisor of
    k from longest / 2 to longest, so that K splits into equal blocks and
    no ragged last block costs a product of its own (4,810 -> 185); else
    `longest`."""
    for length in range(longest, longest // 2, -1):
        if k % length == 0:
            return length
    return longest


def blocked_matmul(a, b, block: int | None = None):
    """a @ b for a (M, K) and b (K, N) of any strides, summed over K in
    chains of `block` (default `chain_length(K)`): one batched product of
    (nb, M, block) x (nb, block, N), the nb partials summed, and the product
    of a ragged last block of K added; the result is contiguous. The blocks
    are views (a (V, V) operand's row or column blocks), never a copy."""
    k = a.shape[-1]
    block = block or chain_length(k)
    nb, ragged = divmod(k, block)
    full = nb * block
    (m, n), (a0, a1), (b0, b1) = (a.shape[0], b.shape[1]), a.stride(), b.stride()
    out = torch.bmm(a.as_strided((nb, m, block), (block * a1, a0, a1)),
                    b.as_strided((nb, block, n), (block * b0, b0, b1))).sum(0)
    return torch.addmm(out, a[:, full:], b[full:]) if ragged else out


def spectral_solve(factor: SpectralFactor, rhs, mesh=None):
    """Apply the space-time Laplacian pseudo-inverse to rhs (T+1, V): two
    small time-transform GEMMs and two (V, V) x (V, T+1) GEMMs, the latter
    summed in short chains over their K (`blocked_matmul`), as a host BLAS
    and the TPU sum it, on every device and in every dtype.

    The solve runs on the transposed (V, T+1) arrays: with the (V, V)
    factor on the left the card's library picks faster kernels for the
    batched products than with it on the right.

    On one shard of a space-sharded problem (`mesh`; rhs, `s` and the rows
    of `q` are this shard's vertex block, `u_time` and `invfac` whole) the
    time transforms and scalings are local, the first GEMM gives this
    shard's partial eigen-coefficients (K: the shard's vertices), and one
    all-reduce of the (V, T+1) array sums them; the second GEMM (K: every
    vertex) then gives this shard's block.

    Its span runs only where the Python runs: eagerly, and while the
    iteration segment is captured; a replay is the `iteration` run's."""
    with trace.span("spectral_solve"):
        y_t = (rhs.T @ factor.u_time) * factor.s[:, None]  # time transform
        coef_t = space_sum(blocked_matmul(factor.q.T, y_t), mesh)
        coef_t = coef_t * factor.invfac.T
        z_t = blocked_matmul(factor.q, coef_t) * factor.s[:, None]
        return factor.u_time @ z_t.T


class CGOperator(NamedTuple):
    """Matrix-free shifted-Laplacian systems for the CG path.

    shifts   : (T+1,) lam_a - eps (time eigenvalues, shifted)
    jacobi   : (T+1, V) inverse diagonal of -(L_space + shift * diag(av))
    null_row : (T+1,) 1.0 where the shifted system is singular (shift ~ 0)
    u_time   : (T+1, T+1) time eigenvectors
    av_unit  : (V,) av / sum(av)
    s        : (V,) av^{-1/2}
    defl_q   : (V, k) Ritz vectors of C (k = 0 disables deflation)
    defl_winv: (T+1, k) masked 1 / (ritz_w_i - shift_a)
    rtol     : () relative tolerance, a 0-d tensor the host may replace
               between iterations (inexact-ALM inner-tolerance schedule)
    ell_idx  : (V, D) int64 padded-ELL column indices of L_space
    ell_w    : (V, D) matching values (0 on padding slots)
    window   : `WindowOperator` for the windowed SpMV, or None (ELL matvec)
    swindow  : `ShardedWindow` of a space-sharded problem (kernel B2), or None
    ell_w_hi, av_hi, shifts_hi, u_time_hi : float64 leaves of the iterative
               refinement's true residual; None disables refinement
    real_mask: (V,) 1.0 on real vertices, 0.0 on padding slots
    """

    shifts: torch.Tensor
    jacobi: torch.Tensor
    null_row: torch.Tensor
    u_time: torch.Tensor
    av_unit: torch.Tensor
    s: torch.Tensor
    defl_q: torch.Tensor
    defl_winv: torch.Tensor
    rtol: torch.Tensor
    ell_idx: torch.Tensor
    ell_w: torch.Tensor
    window: Optional[WindowOperator] = None
    swindow: Optional[ShardedWindow] = None
    ell_w_hi: Optional[torch.Tensor] = None
    av_hi: Optional[torch.Tensor] = None
    shifts_hi: Optional[torch.Tensor] = None
    u_time_hi: Optional[torch.Tensor] = None
    real_mask: Optional[torch.Tensor] = None


@dataclasses.dataclass
class CGCounters:
    """Work counted by `cg_solve` in this process (read by the smoke run)."""

    solves: int = 0
    refined_solves: int = 0  # solves that ran f64 iterative refinement
    iterations: int = 0  # inner CG iterations, every pass included
    window_matvecs: int = 0  # matvecs through the window SpMV (B1 or B2)
    fused_steps: int = 0  # inner iterations through `ops.cg_step` (no-ops included)
    flag_reads: int = 0  # the loops' reads of a flag on the host (blocks, passes, iterations)
    passes: int = 0  # inner PCG passes started (each starts with one matvec)
    # Live inner iterations through K4-f64: taken where `iterations` is (a
    # replay's count would hold the latched blocks' no-ops).
    f64_fused_steps: int = 0

    def reset(self):
        self.solves = self.refined_solves = self.iterations = 0
        self.window_matvecs = self.fused_steps = self.flag_reads = self.passes = 0
        self.f64_fused_steps = 0


CG_COUNTERS = CGCounters()
#: Counted through replays (`graphs.counters()` exports them); the tracer
#: takes the others itself.
_REPLAYED = ("window_matvecs", "fused_steps")
for _name in _REPLAYED:
    graphs.register_counter(lambda name=_name: getattr(CG_COUNTERS, name),
                            lambda n, name=_name: setattr(CG_COUNTERS, name, n), f"cg.{_name}")
trace.add_counters(lambda: {f"cg.{k}": v for k, v in vars(CG_COUNTERS).items()
                            if k not in _REPLAYED})


def _ritz_cache_dir() -> str:
    """Directory for persisted Ritz pairs and eigh factors (env
    DOTS_SOCP_CACHE_DIR, default <repo>/output/ritz_cache): the reference's
    cache, whose files are content-keyed and shared."""
    import os
    from pathlib import Path

    env = os.environ.get("DOTS_SOCP_CACHE_DIR")
    if env:
        return env
    return str(Path(__file__).resolve().parents[2] / "output" / "ritz_cache")


def _ritz_pairs_cached(lap_space, av: np.ndarray, k: int, seed: int = 7):
    """`_ritz_pairs` with an on-disk cache keyed by the exact problem."""
    import hashlib
    import os

    import scipy.sparse as sp

    csr = sp.csr_matrix(lap_space)
    csr.sum_duplicates()
    h = hashlib.sha256()
    for part in (
        np.int64([k, seed, csr.shape[0]]),
        csr.indptr.astype(np.int64),
        csr.indices.astype(np.int64),
        np.asarray(csr.data, dtype=np.float64),
        np.asarray(av, dtype=np.float64),
    ):
        h.update(part.tobytes())
    cache_dir = _ritz_cache_dir()
    path = os.path.join(cache_dir, f"ritz_{h.hexdigest()[:32]}.npz")

    try:
        with np.load(path) as f:
            return np.array(f["q"]), np.array(f["w"])  # writable copies
    except (OSError, KeyError, ValueError):
        pass

    q, w = _ritz_pairs(csr, av, k, seed)

    if q.shape[1] == 0:
        return q, w  # never cache a failed computation

    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, q=q, w=w)
        os.replace(tmp, path)
    except OSError:
        pass
    return q, w


def _ritz_pairs(lap_space, av: np.ndarray, k: int, seed: int = 7):
    """The k smallest eigenpairs of C = av^{-1/2}(-L)av^{-1/2} (host, once),
    for the CG deflation preconditioner: shift-invert Lanczos on a SuperLU
    factor of C + delta I, with Jacobi-preconditioned LOBPCG as the fallback.
    Any failure degrades to Jacobi-only preconditioning (empty deflation)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import LinearOperator, eigsh, lobpcg, splu

    v = av.shape[0]
    k = int(min(k, max(v // 4, 1)))
    if k <= 0:
        return np.zeros((v, 0)), np.zeros(0)
    s = 1.0 / np.sqrt(av)
    c = -sp.csr_matrix(lap_space)
    c = (sp.diags(s) @ c @ sp.diags(s)).tocsc()
    diag_max = float(np.max(c.diagonal(), initial=1.0))

    with np.errstate(all="ignore"):
        try:
            delta = 1e-8 * diag_max  # C is PSD; makes C + delta*I PD
            lu = splu(c + delta * sp.identity(v, format="csc"))
            op_inv = LinearOperator((v, v), matvec=lu.solve)
            w, q = eigsh(
                c,
                k=k,
                sigma=-delta,
                which="LM",  # nearest sigma => smallest eigenvalues of C
                OPinv=op_inv,
                v0=np.sqrt(av),  # known null vector of C
                tol=1e-8,
            )
            if np.isfinite(q).all() and np.isfinite(w).all():
                return q, np.maximum(w, 0.0)
        except Exception:  # SuperLU / ARPACK failure: take the fallback
            pass
        try:
            precond = LinearOperator(
                (v, v), matvec=lambda x: x / np.maximum(c.diagonal(), 1e-30)
            )
            rng = np.random.default_rng(seed)
            x0 = rng.standard_normal((v, k))
            x0[:, 0] = np.sqrt(av)
            w, q = lobpcg(c, x0, M=precond, largest=False, tol=1e-4, maxiter=128)
            if not np.isfinite(q).all():
                return np.zeros((v, 0)), np.zeros(0)
            q, _ = np.linalg.qr(q)
            small = q.T @ (c @ q)
            w, u = np.linalg.eigh(0.5 * (small + small.T))
        except Exception:  # degrade to Jacobi-only preconditioning
            return np.zeros((v, 0)), np.zeros(0)
    q, w = q @ u, np.maximum(w, 0.0)
    if not (np.isfinite(q).all() and np.isfinite(w).all()):
        return np.zeros((v, 0)), np.zeros(0)
    return q, w


def _ell_arrays(lap_space):
    """Padded-ELL (indices, values) of the sparse (V, V) cotan Laplacian:
    rows padded to the max row length with (own index, 0.0)."""
    import scipy.sparse as sp

    csr = sp.csr_matrix(lap_space)
    csr.sum_duplicates()
    v = csr.shape[0]
    nnz_per_row = np.diff(csr.indptr)
    width = max(int(nnz_per_row.max(initial=0)), 1)
    idx = np.repeat(np.arange(v, dtype=np.int32)[:, None], width, axis=1)
    w = np.zeros((v, width), dtype=np.float64)
    rows = np.repeat(np.arange(v), nnz_per_row)
    slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_per_row)
    idx[rows, slots] = csr.indices.astype(np.int32)
    w[rows, slots] = csr.data
    return idx, w


def build_cg_operator(
    n_time: int,
    stepsize_time: float,
    av: np.ndarray,
    lap_space,
    eps: float = 0.0,
    dtype=torch.float32,
    deflation_k: int = 64,
    rtol: float = 1e-6,
    spmv_tile_rows: int | None = None,
    refine: bool = False,
    coords=None,
    device="cpu",
    shard_parts: int | None = None,
    mesh=None,
) -> CGOperator:
    """Set up the matrix-free CG solver for meshes too large to densify.

    The windowed SpMV operator is built when the T+1 modes fit the kernel
    (<= 128) and the builder finds tiles, on every device (on the CPU its
    plain version runs), in the inner CG's work dtype: float32 (dtype
    float32, or any dtype under `refine`; kernel B1), or float64 (dtype
    float64 without `refine`, on one shard; kernel B1-f64, tiles cut for its
    8-byte values). Otherwise the CG uses the ELL matvec (a sharded float64
    problem: the halo incidence form).

    spmv_tile_rows : rows per window tile (None: the tile model picks).
    refine : attach the float64 leaves of mixed-precision iterative
        refinement (`cg_solve`).
    shard_parts : the number of space shards of a blocked-layout problem
        (`parallel.partition`); builds the per-shard window operator
        (`swindow`, kernel B2) instead of B1's. JAX builds it only on a TPU
        backend (`laplacian.py:476-478`); the card is the port's.
    mesh : a `SolverMesh`; its world rank 0 alone computes the Ritz pairs and
        sends them to the others (concurrent cache writes would race, and
        every shard must deflate with the same vectors).
    """
    lap_time = build_time_laplacian(n_time, stepsize_time)
    lam_t, u_time = np.linalg.eigh(lap_time)
    av = np.array(av, dtype=np.float64)  # a writable copy (tensors may share it)
    lap_diag = np.asarray(
        lap_space.diagonal() if hasattr(lap_space, "diagonal") else lap_space
    )
    shifts = lam_t - eps  # (T+1,)
    diag = -(lap_diag[None, :] + shifts[:, None] * av[None, :])
    scale = np.abs(shifts).max() * av.max() + np.abs(lap_diag).max()
    null_row = (np.abs(shifts) * av.max() < 1e-10 * scale).astype(np.float64)
    jacobi = 1.0 / np.maximum(diag, 1e-30 * scale)
    # Padding slots (structurally empty rows): zero their ~1/0 Jacobi
    # entries on the singular row (see `real_mask`).
    real = (lap_diag != 0).astype(np.float64)
    jacobi = np.where((null_row[:, None] > 0.5) & (real[None, :] < 0.5), 0.0, jacobi)

    if deflation_k > 0 and hasattr(lap_space, "diagonal"):
        q, w = object_from_rank0(lambda: _ritz_pairs_cached(lap_space, av, deflation_k), mesh)
    else:
        q, w = np.zeros((av.shape[0], 0)), np.zeros(0)
    denom = w[None, :] - shifts[:, None]  # (T+1, k), >= 0
    tiny = 1e-10 * max(scale / max(av.max(), 1e-30), 1.0)
    with np.errstate(divide="ignore"):
        winv = np.where(np.abs(denom) > tiny, 1.0 / denom, 0.0)
    if q.shape[1] > 0:
        # On the singular rows, the Ritz pair aligned with the null vector
        # sqrt(av) contributes nothing (zeroed by alignment).
        v0 = np.sqrt(av)
        v0 /= np.linalg.norm(v0)
        null_aligned = np.abs(q.T @ v0) > 0.5  # (k,)
        winv = np.where(null_row.astype(bool)[:, None] & null_aligned[None, :], 0.0, winv)

    ell_idx, ell_w = _ell_arrays(lap_space)

    window = swindow = None
    work = torch.float32 if dtype == torch.float32 or refine else dtype
    windowed = n_time + 1 <= 128 and hasattr(lap_space, "diagonal")
    if windowed and shard_parts and work == torch.float32:
        built = build_sharded_window(
            lap_space,
            av.shape[0] // shard_parts,
            shard_parts,
            av=av,
            jacobi=jacobi,
            s_vec=1.0 / np.sqrt(av),
            defl_q=q,
            real=real,
            tile_rows=spmv_tile_rows,
            n_modes=n_time + 1,
        )
        if built is None:
            log.info("sharded window SpMV: no tile candidate fits shared memory; "
                     "CG uses the halo incidence matvec")
        else:
            swindow = sharded_window_to_torch(built[0], device=device)
    elif windowed and not shard_parts:
        tiles = build_window_tiles(
            lap_space, tile_rows=spmv_tile_rows, coords=coords, n_modes=n_time + 1,
            value_bytes=torch.finfo(work).bits // 8,
        )
        if tiles is None:
            log.info("window SpMV: no tile candidate fits shared memory; CG uses the ELL matvec")
        else:
            log.info(
                "window SpMV: ordering=%(ordering)s TV=%(tile_rows)d W=%(width)d "
                "D=%(nnz_width)d tiles=%(tiles)d smem=%(smem_bytes)d B",
                tiles.meta,
            )
            window = window_operator(
                tiles, av, jacobi, 1.0 / np.sqrt(av), q, device=device, dtype=work
            )

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    hi = {}
    if refine:
        f64 = torch.float64
        hi = dict(
            ell_w_hi=t(ell_w, f64),
            av_hi=t(av, f64),
            shifts_hi=t(shifts, f64),
            u_time_hi=t(u_time, f64),
        )

    return CGOperator(
        shifts=t(shifts),
        jacobi=t(jacobi),
        null_row=t(null_row),
        u_time=t(u_time),
        av_unit=t(av / av.sum()),
        s=t(1.0 / np.sqrt(av)),
        defl_q=t(q),
        defl_winv=t(winv),
        rtol=t(rtol),
        ell_idx=t(ell_idx, torch.int64),
        ell_w=t(ell_w),
        window=window,
        swindow=swindow,
        real_mask=t(real),
        **hi,
    )


def ell_matvec(op: CGOperator, x, weights=None):
    """L_space @ x for (..., V) x, via the padded-ELL gather form.

    weights : override for `op.ell_w` (the refinement passes the f64 copy).
    """
    w = op.ell_w if weights is None else weights
    xt = x.movedim(-1, 0)  # (V, ...)
    g = xt[op.ell_idx]  # (V, D, ...)
    w = w.reshape(w.shape + (1,) * (x.ndim - 1))
    return (g * w).sum(1).movedim(0, -1)


#: Inner CG iterations per block on one device. The host reads the latched
#: flag once per block; on the card a block is one CUDA graph replay. A
#: block that outruns the convergence runs up to CG_BLOCK - 1 iterations as
#: exact no-ops: their matvecs and deflation GEMMs still run, and their
#: updates too on the torch route, masked (K4's launches return at once). 8 is the
#: smallest block that keeps plane n200's host reads per iteration under a
#: quarter of a per-iteration flag's on an H100 (`profile_slice
#: --cg_blocks`: 4, 8, 12, 16 gave 11.0, 7.7, 6.6, 5.9 reads against 34.2;
#: each 4 more iterations cost ~1 ms of device time per outer iteration).
CG_BLOCK = 8

#: Passes of the mixed-precision refinement at most.
MAX_REFINE = 6


def cg_solve(
    ops: SurfaceOps,
    op: CGOperator,
    rhs,
    x0=None,
    max_iters: int = 200,
    rtol=None,
    return_iters=False,
    halo=None,
    mesh=None,
    ops_hi=None,
):
    """Batched spectrally-preconditioned CG over the T+1 shifted SPD systems.

    Solves -(L_space + shift_a diag(av)) x_a = -b_a for all time modes at
    once, with the reference's semantics (`laplacian.py:709-1048`): Jacobi +
    low-rank Ritz preconditioner, per-shift stopping thresholds capped at the
    mean row norm, frozen converged rows, real-vertex deflation of the
    singular row every iteration, and the breakdown guard (den <= 0 freezes
    the row). `rtol=None` reads `op.rtol`.

    The inner loop carries the reference's `lax.while_loop` predicate on
    the device as a latched flag, live = any(rr > thresh) & (it <
    max_iters): every update of an iteration is gated by it, so an
    iteration after convergence is an exact no-op, and the iterations are
    counted on the device. The body runs in blocks of `CG_BLOCK`
    iterations, and the host reads the flag once per block; on the card
    each block, and the set-up and finish around it, is a CUDA graph replay
    (`ops.graphs`). The same inputs give the same x and count for every
    block length, and the same as the host loop below. The refinement keeps
    one host read per pass, the f64 check after it (1-2 passes after a warm
    start); the first pass's check rides with its first block's flags
    (`_BlockedCG`). On a mesh (`mesh` given; on one shard of a
    space-sharded problem with `halo`, the arrays the shard's) the flags
    come from all-reduced sums (rr, the thresholds' row sums, the f64
    check's), so every rank reads the same flags without a collective of
    their own and runs the same blocks; over nccl the segments, their
    collectives inside, are CUDA graph replays, over gloo they run op by op.

    On one card, with the window SpMV, each inner iteration after its matvec
    is kernel K4 (`ops.cg_step`, five launches and the two deflation GEMMs;
    K4-f64 after B1-f64 in a float64 solve) in both loops, graphed and
    eager; elsewhere, and inside `cg_step.torch_route()`, it is
    `_CGSystem.gated_step`'s torch ops.

    Inside `graphs.eager()` the loops read one flag on the host per
    iteration (`_cg_solve_hosted`), on a mesh the same on every rank
    (`space_any`): the reference the blocked loops are held to. On a shard
    the matvec is kernel B2 on the shard's window (`op.swindow`) in the f32
    work dtype, else the halo incidence form; every row sum, dot product
    and deflation product is summed over the shards. The refinement's f64
    true residual then goes through `laplacian_apply(ops_hi, ..., halo)`,
    in native FP64.

    Mixed-precision refinement, when the operator carries float64 leaves:
    the true residual r = b - A x is evaluated in f64 with the f64 ELL matvec
    (the card has native FP64), and each correction is solved by the f32
    inner CG, which runs on the window SpMV when the operator has one. The
    returned x is f64. With return_iters=True, also returns the inner
    iteration count (every refinement pass summed).
    """
    if rtol is None:
        rtol = op.rtol
    rtol = torch.as_tensor(rtol, dtype=rhs.dtype, device=rhs.device)
    refined = op.ell_w_hi is not None and (halo is None or ops_hi is not None)
    work = "float32" if refined else str(rhs.dtype).removeprefix("torch.")
    with trace.span("cg_solve", work=work):
        if graphs.enabled():
            block = CG_BLOCK
            keep = graphs.leaves(ops, op._replace(rtol=None), halo, ops_hi)
            key = ("cg", rhs.shape, rhs.dtype, rhs.device, None if x0 is None else x0.dtype,
                   int(max_iters), block, fused.enabled(), graphs.mesh_key(mesh))
            solver = graphs.cached(key, lambda: _BlockedCG(
                ops, op, rhs, x0 is not None, int(max_iters), block, halo, mesh, ops_hi), keep)
            x, iters = solver.solve(rhs, x0, rtol)
            x = x.clone()  # the workspace's buffer, which the next solve overwrites
        else:
            x, iters = _cg_solve_hosted(ops, op, rhs, x0, max_iters, rtol, halo, mesh, ops_hi)
    return (x, iters) if return_iters else x


class _CGSystem:
    """The pieces of `cg_solve` for one operator, right-hand-side dtype and
    layout: matvecs, preconditioner, deflations, the inner PCG step."""

    def __init__(self, ops, op, rhs_dtype, halo=None, mesh=None, ops_hi=None):
        self.op, self.ops, self.halo, self.mesh, self.ops_hi = op, ops, halo, mesh, ops_hi
        self.has_deflation = op.defl_q.shape[-1] > 0
        self.sharded = halo is not None
        self.use_refine = op.ell_w_hi is not None and (not self.sharded or ops_hi is not None)
        work = self.work = torch.float32 if self.use_refine else rhs_dtype

        # The window SpMV runs the CG loop in permuted vertex order (permuting
        # once at entry and exit); its preconditioner arrays come pre-permuted.
        # On a shard, the per-shard window order of `op.swindow`.
        wop = self.wop = op.window
        self.use_window = wop is not None and not self.sharded and work == wop.vals.dtype
        swop = self.swop = op.swindow
        self.use_swindow = swop is not None and self.sharded and work == torch.float32
        if self.use_window:
            jacobi, defl_q, s_vec, av_vec = wop.jacobi_p, wop.defl_q_p, wop.s_p, wop.av_p
        elif self.use_swindow:
            jacobi, defl_q, s_vec, av_vec = swop.jacobi_p, swop.defl_q_p, swop.s_p, swop.av_p
        else:
            jacobi, defl_q, s_vec, av_vec = (
                op.jacobi.to(work),
                op.defl_q.to(work),
                op.s.to(work),
                ops.av.to(work),
            )
        self.jacobi, self.defl_q, self.s_vec, self.av_vec = jacobi, defl_q, s_vec, av_vec
        # (k, V), row-major: `coef @ defl_q.T` with the transposed view would
        # come back column-major, and every CG vector after it (z, p, ap) would
        # inherit that layout. The window kernels read the state modes-major,
        # contiguous, in place; this copy, made once, keeps it so.
        self.defl_qt = defl_q.t().contiguous()
        self.shifts_w = op.shifts.to(work)
        self.defl_winv_w = op.defl_winv.to(work)
        self.ell_w_work = op.ell_w.to(work)

        self.real = op.real_mask if op.real_mask is not None else torch.ones_like(op.s)
        # Exact real-vertex count (the reference sums in the work dtype, which
        # agrees below 2^24 vertices).
        self.n_real = space_sum(self.real.sum(dtype=torch.float64), mesh)
        self.null_w = op.null_row.to(work)
        if self.use_window:
            self.real_w = self.real[wop.perm].to(work)
        elif self.use_swindow:
            self.real_w = swop.real_p.to(work)
        else:
            self.real_w = self.real.to(work)
        self.n_real_w = self.n_real.to(work)
        self.leaves = fused.CGStepLeaves(
            shifts=self.shifts_w, av=self.av_vec, jacobi=self.jacobi, s=self.s_vec,
            real=self.real_w, null=self.null_w, n_real=self.n_real_w, defl_q=self.defl_q,
            defl_qt=self.defl_qt, defl_winv=self.defl_winv_w)
        self.fused = _fused_route(self, op.s.device)
        if self.fused:
            fused.prepare(op.s.device)

    def row_sums(self, v):
        """(T+1, V) -> (T+1, 1) sums over every vertex of every shard."""
        return space_sum(v.sum(dim=1, keepdim=True), self.mesh)

    def deflate(self, v):
        # Singular rows: project the real-vertex constant out and zero the
        # padding slots.
        rm = self.real.to(v.dtype)
        nr = self.op.null_row.to(v.dtype)[:, None]
        mean = self.row_sums(v * rm[None, :]) / self.n_real.to(v.dtype)
        v = v - nr * mean
        return torch.where(nr > 0, v * rm[None, :], v)

    def lap(self, x):
        """L_space @ x in the work dtype and the CG's vertex order."""
        if self.use_window:
            CG_COUNTERS.window_matvecs += 1
            return window_matvec(self.wop, x)
        if self.use_swindow:
            CG_COUNTERS.window_matvecs += 1
            return sharded_window_matvec(self.swop, self.mesh, x)
        if self.sharded:
            return laplacian_apply(self.ops, x, self.halo, self.mesh)
        return ell_matvec(self.op, x, weights=self.ell_w_work)

    def matvec(self, x):
        return -(self.lap(x) + self.shifts_w[:, None] * self.av_vec[None, :] * x)

    def matvec_hi(self, x):
        op = self.op
        if self.sharded:
            # f64 halo incidence form: the ELL rows reach across shards.
            lap = laplacian_apply(self.ops_hi, x, self.halo, self.mesh)
        else:
            lap = ell_matvec(op, x, weights=op.ell_w_hi)
        return -(lap + op.shifts_hi[:, None] * op.av_hi[None, :] * x)

    def precond(self, r):
        z = self.jacobi * r
        if self.has_deflation:
            coef = space_sum((self.s_vec[None, :] * r) @ self.defl_q, self.mesh)  # (T+1, k)
            z = z + self.s_vec[None, :] * ((coef * self.defl_winv_w) @ self.defl_qt)
        return z

    def row_thresh(self, b, tol):
        # Per-shift threshold, capped at the mean row norm.
        b_norm_row = self.row_sums(b * b)  # (T+1, 1)
        return tol * tol * torch.maximum(b_norm_row, b_norm_row.mean())

    def dfl(self, v):
        mean = self.row_sums(v * self.real_w[None, :]) / self.n_real_w
        v = v - self.null_w[:, None] * mean
        return torch.where(self.null_w[:, None] > 0, v * self.real_w[None, :], v)

    def rr_rz(self, r, z):
        # ||r||^2 and r.z per row; on a shard, in one all-reduce.
        rr, rz = (r * r).sum(dim=1, keepdim=True), (r * z).sum(dim=1, keepdim=True)
        if self.mesh is None:
            return rr, rz
        both = space_sum(torch.cat([rr, rz], dim=1), self.mesh)
        return both[:, :1], both[:, 1:]

    def permute(self, v):
        """Eigenbasis, original vertex order -> the inner CG's order."""
        if self.use_window:
            return v[:, self.wop.perm]
        if self.use_swindow:
            return window_permute(self.swop, v)
        return v

    def unpermute(self, v):
        if self.use_window:
            return v[:, self.wop.iperm]
        if self.use_swindow:
            return window_permute(self.swop, v, inverse=True)
        return v

    def pcg_start(self, b, x):
        """The inner PCG's state (x, r, p, rz, rr) in the work dtype, for b
        and x in eigenbasis, original order."""
        b, x = self.permute(b), self.permute(x)
        r = self.dfl(b - self.matvec(x))
        z = self.precond(r)
        rr, rz = self.rr_rz(r, z)
        return x, r, z, rz, rr

    def pcg_step(self, x, r, p, rz, rr, active):
        """One inner PCG iteration on the rows of `active`; the others are
        frozen (alpha = beta = 0, p and rz kept)."""
        ap = self.matvec(p)
        den = self.row_sums(p * ap)
        # den <= 0 on an active row is rounding-level breakdown on the
        # singular shift: freeze the row (alpha = beta = 0).
        step = active & (den > 0)
        alpha = torch.where(step, rz / torch.clamp(den, min=1e-30), 0.0)
        x = x + alpha * p
        r = self.dfl(r - alpha * ap)
        z = self.precond(r)
        rr, rz_new = self.rr_rz(r, z)
        beta = torch.where(step, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        p = torch.where(step, z + beta * p, p)
        rz = torch.where(step, rz_new, rz)
        return x, r, p, rz, rr

    def gated_step(self, x, r, p, rz, rr, it, live, thresh, max_iters):
        """One latched iteration on the torch route: `pcg_step` on the
        active rows while `live` holds, an exact no-op after; then
        it += live and live &= (it < max_iters) & any(rr > thresh). Returns
        the new (x, r, p, rz, rr, it, live)."""
        xn, rn, p, rz, rrn = self.pcg_step(x, r, p, rz, rr, (rr > thresh) & live)
        x = torch.where(live, xn, x)
        r = torch.where(live, rn, r)
        rr = torch.where(live, rrn, rr)
        it = it + live
        live = live & (it < max_iters) & (rr > thresh).any()
        return x, r, p, rz, rr, it, live

    def fused_step(self, x, r, p, rz, rr, it, live, thresh, max_iters):
        """`gated_step` through kernel K4, in place: B1, then `ops.cg_step`
        (on CPU tensors its plain version). Returns the same tensors."""
        CG_COUNTERS.fused_steps += 1
        return fused.cg_step(self.lap(p), x, r, p, rz, rr, it, live, thresh, max_iters,
                             self.leaves)


def _fused_route(cg, device) -> bool:
    """Whether `cg`'s inner iterations go through kernel K4: on one card,
    no mesh, with the window SpMV (float32: K4, float64: K4-f64), outside
    `torch_route()`."""
    return (device.type == "cuda" and cg.mesh is None and not cg.sharded and cg.use_window
            and fused.enabled())


def _count_iterations(cg, it):
    """Add a pass's live inner iterations to `CG_COUNTERS`."""
    CG_COUNTERS.iterations += it
    if cg.fused and cg.work == torch.float64:
        CG_COUNTERS.f64_fused_steps += it


def _cg_solve_hosted(ops, op, rhs, x0, max_iters, rtol, halo, mesh, ops_hi):
    """`cg_solve` with its loops on the host: one flag read per inner
    iteration and per refinement pass (on a mesh the same on every rank,
    `space_any`). Returns (x, iters)."""
    cg = _CGSystem(ops, op, rhs.dtype, halo, mesh, ops_hi)

    def pcg_core(b, x, thresh):
        CG_COUNTERS.passes += 1
        with trace.span("cg_pass"):
            x, r, p, rz, rr = cg.pcg_start(b, x)
            if cg.fused:  # the kernel's latch: live whenever the host steps
                it_d = torch.zeros((), dtype=torch.int64, device=b.device)
                live = torch.ones((), dtype=torch.bool, device=b.device)
            it = 0
            while it < max_iters:
                active = rr > thresh
                CG_COUNTERS.flag_reads += 1
                with trace.span("read"):
                    go = space_any(active, mesh)
                if not go:
                    break
                if cg.fused:
                    cg.fused_step(x, r, p, rz, rr, it_d, live, thresh, max_iters)
                else:
                    x, r, p, rz, rr = cg.pcg_step(x, r, p, rz, rr, active)
                it += 1
        _count_iterations(cg, it)
        return cg.unpermute(x), it

    CG_COUNTERS.solves += 1
    if not cg.use_refine:
        b = cg.deflate(-(op.u_time.T @ rhs))
        x = torch.zeros_like(b) if x0 is None else op.u_time.T @ x0
        x, iters = pcg_core(b, x, cg.row_thresh(b, rtol))
        return op.u_time @ cg.deflate(x), iters

    # ---- mixed-precision iterative refinement ------------------------------
    CG_COUNTERS.refined_solves += 1
    f64 = torch.float64
    ut = op.u_time_hi
    b64 = cg.deflate(-(ut.T @ rhs.to(f64)))
    x64 = torch.zeros_like(b64) if x0 is None else cg.deflate(ut.T @ x0.to(f64))
    thresh64 = cg.row_thresh(b64, rtol.to(f64))
    thresh_w = thresh64.to(cg.work)
    # Per-pass relative target (squared): each correction only has to shrink
    # the true residual ~2 decades; the next pass re-checks in f64.
    eta2 = torch.tensor(1e-4, dtype=cg.work, device=rhs.device)
    total = 0
    for _ in range(MAX_REFINE):
        r64 = cg.deflate(b64 - cg.matvec_hi(x64))
        CG_COUNTERS.flag_reads += 1
        with trace.span("read"):
            unmet = space_any(cg.row_sums(r64 * r64) > thresh64, mesh)
        if not unmet:
            break
        r_w = r64.to(cg.work)
        thresh_pass = torch.maximum(thresh_w, eta2 * cg.row_sums(r_w * r_w))
        d, it = pcg_core(r_w, torch.zeros_like(r_w), thresh_pass)
        x64 = x64 + d.to(f64)
        total += it
    return ut @ cg.deflate(x64), total


class _BlockedCG:
    """`cg_solve` for one operator, shape and layout (one device, or this
    rank's shard of a mesh): the latched inner loop in blocks of `block`
    iterations, over the static buffers of a `graphs.Workspace` (one CUDA
    graph per segment on the card, over nccl on a mesh).

    Segments and the host's reads between them (refinement):
      start  -- the eigenbasis right-hand side, x64, the thresholds, the
                first pass's f64 residual check -> `unmet`, and that pass's
                inner PCG state, its `live` gated by `unmet`
      per pass:
        block  -- `block` latched iterations; `flags` = [live, it, gate]
                  read after each; in the first pass `gate` is `unmet`,
                  which ends the solve there when it is false (the block
                  then ran as no-ops)
        finish -- x64 += the correction, and the next pass's check
        (one read of `unmet`; while it holds)
        init   -- the next correction's inner PCG state, `live`
      result -- x = U deflate(x64) -> `out`
    Without refinement: start (with the PCG state), the blocks, result.
    The first pass is nearly always needed (the warm start is rarely within
    tolerance), so reading its `unmet` with the first block's flags saves
    a host read per solve at the risk of one block of no-ops.
    """

    def __init__(self, ops, op, rhs, has_x0, max_iters, block, halo=None, mesh=None,
                 ops_hi=None):
        self.cg = _CGSystem(ops, op, rhs.dtype, halo, mesh, ops_hi)
        self.op, self.has_x0 = op, has_x0
        self.max_iters, self.block = max_iters, block
        # K4 updates the state's buffers in place (the capture's warm-up runs on copies).
        # Its collectives cross the space group only: time-ranks solve apart.
        self.ws = graphs.Workspace(rhs.device, in_place={"block"} if self.cg.fused else (),
                                   mesh=mesh, group=None if mesh is None else mesh.group)

    def solve(self, rhs, x0, rtol):
        """(x, inner iterations); x is the workspace's `out` buffer."""
        ws, cg = self.ws, self.cg
        ws.load("rhs", rhs)
        ws.load("rtol", rtol)
        if self.has_x0:
            ws.load("x0", x0)
        CG_COUNTERS.solves += 1
        if not cg.use_refine:
            ws.run("start", self._start)
            total = self._blocks()[0]
        else:
            CG_COUNTERS.refined_solves += 1
            ws.run("start", self._start_refined)
            total, gate = self._blocks()
            if gate:  # the first pass was needed
                ws.run("finish", self._finish)
                for _ in range(MAX_REFINE - 1):
                    CG_COUNTERS.flag_reads += 1
                    with trace.span("read"):
                        unmet = bool(ws.bufs["unmet"])
                    if not unmet:
                        break
                    ws.run("init", self._init)
                    total += self._blocks()[0]
                    ws.run("finish", self._finish)
        ws.run("result", self._result)
        return ws.bufs["out"], total

    def _blocks(self):
        """One pass: blocks until the flag falls; (the pass's inner
        iterations, its gate). The first pass of a refined solve starts
        before its check is read, so it counts even where its gate is
        false and its blocks ran as no-ops."""
        ws = self.ws
        CG_COUNTERS.passes += 1
        with trace.span("cg_pass"):
            while True:
                with trace.span("cg_block"):
                    ws.run("block", self._block)
                    CG_COUNTERS.flag_reads += 1
                    with trace.span("read"):
                        live, it, gate = ws.bufs["flags"].tolist()
                if not live:
                    break
        _count_iterations(self.cg, it)
        return it, gate

    def _pcg_state(self, b, x, thresh, gate=None):
        x, r, p, rz, rr = self.cg.pcg_start(b, x)
        it = torch.zeros((), dtype=torch.int64, device=b.device)
        if gate is None:
            gate = torch.ones((), dtype=torch.bool, device=b.device)
        live = gate & (it < self.max_iters) & (rr > thresh).any()
        return dict(x=x, r=r, p=p, rz=rz, rr=rr, it=it, live=live, thresh=thresh, gate=gate,
                    flags=torch.stack([live.long(), it, gate.long()]))

    def _start(self, bufs):
        cg, op = self.cg, self.op
        b = cg.deflate(-(op.u_time.T @ bufs["rhs"]))
        x = op.u_time.T @ bufs["x0"] if self.has_x0 else torch.zeros_like(b)
        return self._pcg_state(b, x, cg.row_thresh(b, bufs["rtol"]))

    def _start_refined(self, bufs):
        cg, f64 = self.cg, torch.float64
        ut = self.op.u_time_hi
        b64 = cg.deflate(-(ut.T @ bufs["rhs"].to(f64)))
        if self.has_x0:
            x64 = cg.deflate(ut.T @ bufs["x0"].to(f64))
        else:
            x64 = torch.zeros_like(b64)
        thresh64 = cg.row_thresh(b64, bufs["rtol"].to(f64))
        thresh_w = thresh64.to(cg.work)
        checked = self._check(b64, x64, thresh64)
        return dict(b64=b64, thresh64=thresh64, thresh_w=thresh_w, **checked,
                    **self._pass_state(checked["r64"], thresh_w, checked["unmet"]))

    def _check(self, b64, x64, thresh64):
        cg = self.cg
        r64 = cg.deflate(b64 - cg.matvec_hi(x64))
        return dict(x64=x64, r64=r64, unmet=(cg.row_sums(r64 * r64) > thresh64).any())

    def _init(self, bufs):
        return self._pass_state(bufs["r64"], bufs["thresh_w"])

    def _pass_state(self, r64, thresh_w, gate=None):
        """The inner PCG state of a refinement pass on the residual r64."""
        cg = self.cg
        r_w = r64.to(cg.work)
        # Per-pass relative target (squared): each correction only has to
        # shrink the true residual ~2 decades; the next pass re-checks in f64.
        eta2 = torch.full((), 1e-4, dtype=cg.work, device=r_w.device)
        thresh = torch.maximum(thresh_w, eta2 * cg.row_sums(r_w * r_w))
        return self._pcg_state(r_w, torch.zeros_like(r_w), thresh, gate)

    def _block(self, bufs):
        names = ("x", "r", "p", "rz", "rr", "it", "live")
        cg = self.cg
        state, step = tuple(bufs[k] for k in names), cg.fused_step if cg.fused else cg.gated_step
        for _ in range(self.block):
            state = step(*state, bufs["thresh"], self.max_iters)
        out = dict(zip(names, state))  # K4's are the buffers themselves
        out["flags"] = torch.stack([out["live"].long(), out["it"], bufs["gate"].long()])
        return out

    def _finish(self, bufs):
        cg = self.cg
        x64 = bufs["x64"] + cg.unpermute(bufs["x"]).to(torch.float64)
        return self._check(bufs["b64"], x64, bufs["thresh64"])

    def _result(self, bufs):
        cg = self.cg
        if cg.use_refine:
            return dict(out=self.op.u_time_hi @ cg.deflate(bufs["x64"]))
        return dict(out=self.op.u_time @ cg.deflate(cg.unpermute(bufs["x"])))
