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
  windowed SpMV of `ops.window_spmv` (a CUDA kernel on the card) when the
  work dtype is float32; the padded-ELL gather otherwise.

The host-side builders are numpy/scipy copies of the reference's.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from dots_socp_torch.ops.mesh_ops import SurfaceOps
from dots_socp_torch.ops.window_spmv import (
    WindowOperator,
    build_window_tiles,
    window_matvec,
    window_operator,
)

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
    lap_time = build_time_laplacian(n_time, stepsize_time)
    lam_t, u_time = np.linalg.eigh(lap_time)  # lam_t <= 0 ascending

    av = np.asarray(av, dtype=np.float64)
    s = 1.0 / np.sqrt(av)
    dense = lap_space.toarray() if hasattr(lap_space, "toarray") else np.asarray(lap_space)
    c = -(s[:, None] * dense * s[None, :])
    c = 0.5 * (c + c.T)  # enforce symmetry
    w, q = _spectral_eigh_cached(lap_space, av, c, dtype)

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


def spectral_solve(factor: SpectralFactor, rhs):
    """Apply the space-time Laplacian pseudo-inverse to rhs (T+1, V): two
    small time-transform GEMMs and two (T+1,V)x(V,V) GEMMs."""
    y = factor.u_time.T @ rhs  # time transform
    y = y * factor.s[None, :]
    coef = y @ factor.q
    coef = coef * factor.invfac
    z = coef @ factor.q.T
    z = z * factor.s[None, :]
    return factor.u_time @ z


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
    window_matvecs: int = 0  # matvecs that went through `window_matvec`

    def reset(self):
        self.solves = self.refined_solves = self.iterations = self.window_matvecs = 0


CG_COUNTERS = CGCounters()


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
) -> CGOperator:
    """Set up the matrix-free CG solver for meshes too large to densify.

    The windowed SpMV operator is built when the inner CG work dtype is
    float32 (dtype float32, or any dtype under `refine`), the T+1 modes fit
    the kernel (<= 128) and the builder finds tiles; on every device (on
    the CPU its plain version runs). Otherwise the CG uses the ELL matvec.

    spmv_tile_rows : rows per window tile (None: the builder picks 256/512).
    refine : attach the float64 leaves of mixed-precision iterative
        refinement (`cg_solve`).
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
        q, w = _ritz_pairs_cached(lap_space, av, deflation_k)
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

    window = None
    work_f32 = dtype == torch.float32 or refine
    if work_f32 and n_time + 1 <= 128 and hasattr(lap_space, "diagonal"):
        tiles = build_window_tiles(lap_space, tile_rows=spmv_tile_rows, coords=coords)
        if tiles is None:
            log.info("window SpMV: no tile candidate fits shared memory; CG uses the ELL matvec")
        else:
            log.info(
                "window SpMV: ordering=%(ordering)s TV=%(tile_rows)d W=%(width)d "
                "G=%(group)d Ws=%(super_width)d D=%(nnz_width)d",
                tiles.meta,
            )
            window = window_operator(
                tiles, av, jacobi, 1.0 / np.sqrt(av), q, device=device
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


def cg_solve(
    ops: SurfaceOps,
    op: CGOperator,
    rhs,
    x0=None,
    max_iters: int = 200,
    rtol=None,
    return_iters=False,
):
    """Batched spectrally-preconditioned CG over the T+1 shifted SPD systems.

    Solves -(L_space + shift_a diag(av)) x_a = -b_a for all time modes at
    once, with the reference's semantics (`laplacian.py:709-1048`): Jacobi +
    low-rank Ritz preconditioner, per-shift stopping thresholds capped at the
    mean row norm, frozen converged rows, real-vertex deflation of the
    singular row every iteration, and the breakdown guard (den <= 0 freezes
    the row). `rtol=None` reads `op.rtol`.

    The loops are data-dependent; each iteration reads one flag on the host
    (where the reference's `lax.while_loop` tested it on device).

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
    has_deflation = op.defl_q.shape[-1] > 0

    use_refine = op.ell_w_hi is not None
    work = torch.float32 if use_refine else rhs.dtype

    # The window SpMV runs the CG loop in permuted vertex order (permuting
    # once at entry and exit); its preconditioner arrays come pre-permuted.
    wop = op.window
    use_window = wop is not None and work == torch.float32
    if use_window:
        jacobi, defl_q, s_vec, av_vec = wop.jacobi_p, wop.defl_q_p, wop.s_p, wop.av_p
    else:
        jacobi, defl_q, s_vec, av_vec = (
            op.jacobi.to(work),
            op.defl_q.to(work),
            op.s.to(work),
            ops.av.to(work),
        )
    shifts_w = op.shifts.to(work)
    defl_winv_w = op.defl_winv.to(work)
    ell_w_work = op.ell_w.to(work)

    real = op.real_mask if op.real_mask is not None else torch.ones_like(op.s)
    # Exact real-vertex count (the reference sums in the work dtype, which
    # agrees below 2^24 vertices).
    n_real = real.sum(dtype=torch.float64)

    def deflate(v):
        # Singular rows: project the real-vertex constant out and zero the
        # padding slots.
        rm = real.to(v.dtype)
        nr = op.null_row.to(v.dtype)[:, None]
        mean = (v * rm[None, :]).sum(dim=1, keepdim=True) / n_real.to(v.dtype)
        v = v - nr * mean
        return torch.where(nr > 0, v * rm[None, :], v)

    def matvec(x):
        if use_window:
            lap = window_matvec(wop, x)
            CG_COUNTERS.window_matvecs += 1
        else:
            lap = ell_matvec(op, x, weights=ell_w_work)
        return -(lap + shifts_w[:, None] * av_vec[None, :] * x)

    def precond(r):
        z = jacobi * r
        if has_deflation:
            coef = (s_vec[None, :] * r) @ defl_q  # (T+1, k)
            z = z + s_vec[None, :] * ((coef * defl_winv_w) @ defl_q.T)
        return z

    def row_thresh(b, tol):
        # Per-shift threshold, capped at the mean row norm.
        b_norm_row = (b * b).sum(dim=1, keepdim=True)  # (T+1, 1)
        return tol * tol * torch.maximum(b_norm_row, b_norm_row.mean())

    null_w = op.null_row.to(work)
    real_w = (real[wop.perm] if use_window else real).to(work)
    n_real_w = n_real.to(work)

    def pcg_core(b, x, thresh):
        """Inner PCG in the work dtype; b and x in eigenbasis, original
        order. Returns (x, iterations)."""
        if use_window:
            b = b[:, wop.perm]
            x = x[:, wop.perm]

        def dfl(v):
            mean = (v * real_w[None, :]).sum(dim=1, keepdim=True) / n_real_w
            v = v - null_w[:, None] * mean
            return torch.where(null_w[:, None] > 0, v * real_w[None, :], v)

        r = dfl(b - matvec(x))
        z = precond(r)
        p = z
        rz = (r * z).sum(dim=1, keepdim=True)
        it = 0
        while it < max_iters:
            active = (r * r).sum(dim=1, keepdim=True) > thresh
            if not bool(active.any()):
                break
            ap = matvec(p)
            den = (p * ap).sum(dim=1, keepdim=True)
            # den <= 0 on an active row is rounding-level breakdown on the
            # singular shift: freeze the row (alpha = beta = 0).
            step = active & (den > 0)
            alpha = torch.where(step, rz / torch.clamp(den, min=1e-30), 0.0)
            x = x + alpha * p
            r = dfl(r - alpha * ap)
            z = precond(r)
            rz_new = (r * z).sum(dim=1, keepdim=True)
            beta = torch.where(step, rz_new / torch.clamp(rz, min=1e-30), 0.0)
            p = torch.where(step, z + beta * p, p)
            rz = torch.where(step, rz_new, rz)
            it += 1
        if use_window:
            x = x[:, wop.iperm]
        CG_COUNTERS.iterations += it
        return x, it

    CG_COUNTERS.solves += 1
    if not use_refine:
        b = deflate(-(op.u_time.T @ rhs))
        x = torch.zeros_like(b) if x0 is None else op.u_time.T @ x0
        x, iters = pcg_core(b, x, row_thresh(b, rtol))
        x = op.u_time @ deflate(x)
        return (x, iters) if return_iters else x

    # ---- mixed-precision iterative refinement ------------------------------
    CG_COUNTERS.refined_solves += 1
    f64 = torch.float64
    ut = op.u_time_hi
    b64 = deflate(-(ut.T @ rhs.to(f64)))
    x64 = torch.zeros_like(b64) if x0 is None else deflate(ut.T @ x0.to(f64))
    thresh64 = row_thresh(b64, rtol.to(f64))
    thresh_w = thresh64.to(work)

    def matvec_hi(x):
        lap = ell_matvec(op, x, weights=op.ell_w_hi)
        return -(lap + op.shifts_hi[:, None] * op.av_hi[None, :] * x)

    max_refine = 6
    # Per-pass relative target (squared): each correction only has to shrink
    # the true residual ~2 decades; the next pass re-checks in f64.
    eta2 = torch.tensor(1e-4, dtype=work, device=rhs.device)
    total = 0
    for _ in range(max_refine):
        r64 = deflate(b64 - matvec_hi(x64))
        if not bool(((r64 * r64).sum(dim=1, keepdim=True) > thresh64).any()):
            break
        r_w = r64.to(work)
        thresh_pass = torch.maximum(
            thresh_w, eta2 * (r_w * r_w).sum(dim=1, keepdim=True)
        )
        d, it = pcg_core(r_w, torch.zeros_like(r_w), thresh_pass)
        x64 = x64 + d.to(f64)
        total += it
    x = ut @ deflate(x64)
    return (x, total) if return_iters else x
