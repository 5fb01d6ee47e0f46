"""One inner iteration of the single-device CG phi-solve, fused (kernel K4).

The JAX package's inner CG iteration is the body of a `lax.while_loop`
(`dots_socp_tpu/ops/laplacian.py:928-955`): XLA fuses its elementwise chain
and row reductions around the Pallas SpMV. The port's torch route of the
same iteration, `ops/laplacian.py::_CGSystem.gated_step`, launches some
forty-five kernels; `cg_step` takes the whole iteration after the SpMV as
six launches of two CUDA kernel bodies (`csrc/cg_step.cu`, which explains
its design) and the two deflation GEMMs between them. Its row sums are
PyTorch's, in PyTorch's order, so it gives the torch route's bits.

`cg_step(lap, x, r, p, rz, rr, it, live, thresh, max_iters, leaves)` updates
the CG state in place, given lap = L p (kernel B1) and the operator's
`CGStepLeaves`; `cg_step_plain` does the same with PyTorch ops, the torch
route's arithmetic in the torch route's order. With `live` false every
output keeps its bits. On a CPU tensor `cg_step` runs the plain version; on
a CUDA tensor it launches the kernel, which takes contiguous float32 only,
or raises. `KERNEL_LAUNCHES` counts the kernel's launches (STAGES per
call); inside `torch_route()` the solver takes the torch route on the card
too (for comparisons).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from dots_socp_torch.ops import graphs

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; the plain version does not count).
KERNEL_LAUNCHES = 0


def _set_launches(n):
    global KERNEL_LAUNCHES
    KERNEL_LAUNCHES = n


# A launch recorded in a CUDA graph counts at every replay (`ops.graphs`).
graphs.register_counter(lambda: KERNEL_LAUNCHES, _set_launches)

#: Launches of the kernel per call, one per stage (`csrc/cg_step.cu`).
STAGES = 6
#: Row scalars the kernel keeps between launches: den, alpha, step, mean, beta.
SCALARS = ("den", "alpha", "step", "mean", "beta")
#: Threads of one block of PyTorch's reduce kernel for float, at most.
REDUCE_THREADS = 512

_FUSED = True
_COUNTER: dict = {}  # device -> the kernel's handshake counters (uint32, 0 between launches)


class CGStepLeaves(NamedTuple):
    """The operator leaves one iteration reads, in the CG's work dtype and
    vertex order (rows = time modes, n = vertices).

    shifts (rows,), av (n,), jacobi (rows, n), s (n,) = av^{-1/2},
    real (n,) 1.0 on real vertices, null (rows,) 1.0 on the singular rows,
    n_real () the real-vertex count, defl_q (n, k), defl_qt (k, n) its
    row-major transpose, defl_winv (rows, k); k = 0 disables deflation.
    """

    shifts: torch.Tensor
    av: torch.Tensor
    jacobi: torch.Tensor
    s: torch.Tensor
    real: torch.Tensor
    null: torch.Tensor
    n_real: torch.Tensor
    defl_q: torch.Tensor
    defl_qt: torch.Tensor
    defl_winv: torch.Tensor


def enabled() -> bool:
    """False inside `torch_route()`."""
    return _FUSED


@contextlib.contextmanager
def torch_route():
    """Solve on the torch route on the card too, for its extent (CG systems
    built inside it; the card tests and `chip_smoke.py` hold the kernel to
    it)."""
    global _FUSED
    before = _FUSED
    _FUSED = False
    try:
        yield
    finally:
        _FUSED = before


def prepare(device):
    """Make the kernel's counters on `device` (outside any graph capture):
    one for the last block of a launch and one per row of a row sum split
    over blocks, 0 between launches."""
    device = torch.device(device)
    if device.type == "cuda" and device not in _COUNTER:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("cg_step: prepare the counters before a graph capture")
        _COUNTER[device] = torch.zeros(1 + 65535, dtype=torch.int32, device=device)


def _last_pow2(n):
    return 1 << (max(int(n), 1).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def row_sum_config(rows, n, sms=132, threads_per_sm=2048):
    """The launch geometry PyTorch's reduce kernel takes for a float32 sum
    over the last axis of a contiguous (rows, n) tensor (`setReduceConfig`
    in ATen/native/cuda/Reduce.cuh, vt0 = input_vec_size = 4, on a card of
    `sms` SMs of `threads_per_sm` threads), which fixes the order of its
    additions. Returns (bw, bh, vec, im0, im1, im2, om1, step_in, step_out,
    ctas) as `csrc/cg_step.cu::Red` reads them."""
    step_in = step_out = ctas = 1
    im = [0, 0, 0]
    om1 = 0
    dim0, dim1 = n, rows
    vec = dim0 >= 128  # reduction on the contiguous axis, 4-byte elements
    if vec:
        dim0 //= 4
    cap = REDUCE_THREADS
    d0 = _last_pow2(dim0) if dim0 < cap else cap
    d1 = _last_pow2(dim1) if dim1 < cap else cap
    bw = min(d0, 32)
    bh = min(d1, cap // bw)
    bw = min(d0, cap // bh)
    im[0], step_in = step_in, step_in * bw
    per_thread = -(-n // step_in)
    if per_thread >= min(bh * 16, 256):
        im[1], step_in = step_in, step_in * bh
    else:
        om1, step_out = step_out, step_out * bh
    grid = -(-rows // step_out)
    target = sms * (threads_per_sm // (bw * bh))
    per_thread = -(-n // step_in)
    if im[1] != 0 and per_thread >= 256 and grid <= target:
        ctas = max(min(-(-target // grid), -(-per_thread // 16)), -(-per_thread // 256))
        if ctas > 1:
            im[2], step_in = step_in, step_in * ctas
    return (bw, bh, int(vec), im[0], im[1], im[2], om1, step_in, step_out, ctas)


@functools.lru_cache(maxsize=None)
def _card(device):
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.max_threads_per_multi_processor


def cg_step_plain(lap, x, r, p, rz, rr, it, live, thresh, max_iters, leaves, trace=None):
    """Plain PyTorch version of the kernel: one latched inner iteration of
    `_CGSystem.gated_step`, in place. `trace`, a dict, receives each
    stage's values (`cg_step`'s names)."""
    lv = leaves
    active = (rr > thresh) & live
    ap = -(lap + lv.shifts[:, None] * lv.av[None, :] * p)
    den = (p * ap).sum(dim=1, keepdim=True)
    # den <= 0 on an active row is rounding-level breakdown on the singular
    # shift: freeze the row (alpha = beta = 0).
    step = active & (den > 0)
    alpha = torch.where(step, rz / torch.clamp(den, min=1e-30), 0.0)
    xn = x + alpha * p
    r1 = r - alpha * ap
    mean = (r1 * lv.real[None, :]).sum(dim=1, keepdim=True) / lv.n_real
    r2 = r1 - lv.null[:, None] * mean
    r2 = torch.where(lv.null[:, None] > 0, r2 * lv.real[None, :], r2)
    z = lv.jacobi * r2
    sr = coef = g = None
    if lv.defl_q.shape[-1] > 0:
        sr = lv.s[None, :] * r2
        coef = sr @ lv.defl_q
        g = (coef * lv.defl_winv) @ lv.defl_qt
        z = z + lv.s[None, :] * g
    rr_new, rz_new = (r2 * r2).sum(dim=1, keepdim=True), (r2 * z).sum(dim=1, keepdim=True)
    beta = torch.where(step, rz_new / torch.clamp(rz, min=1e-30), 0.0)
    if trace is not None:
        trace.update(den=den.clone(), alpha=alpha.clone(), step=step.clone(), x=xn.clone(),
                     r1=r1.clone(), mean=mean.clone(), r=r2.clone(), sr=sr, coef=coef, g=g,
                     z=z.clone(), rr=rr_new.clone(), rz=torch.where(step, rz_new, rz),
                     beta=beta.clone())
    p.copy_(torch.where(step, z + beta * p, p))
    rz.copy_(torch.where(step, rz_new, rz))
    x.copy_(torch.where(live, xn, x))
    r.copy_(torch.where(live, r2, r))
    rr.copy_(torch.where(live, rr_new, rr))
    it.copy_(it + live)
    live.copy_(live & (it < max_iters) & (rr > thresh).any())
    if trace is not None:
        trace.update(p=p.clone(), it=it.clone(), live=live.clone())
    return x, r, p, rz, rr, it, live


def cg_step(lap, x, r, p, rz, rr, it, live, thresh, max_iters, leaves, trace=None):
    """One latched inner iteration in place (see `cg_step_plain`).

    On CPU tensors: the plain version. On CUDA tensors: STAGES launches of
    the kernel and the deflation GEMMs; a refused launch raises. `trace`
    (debugging) receives each stage's outputs, copied after its launch.
    """
    if x.device.type == "cpu":
        return cg_step_plain(lap, x, r, p, rz, rr, it, live, thresh, max_iters, leaves, trace)
    if x.device.type != "cuda":
        raise ValueError(f"cg_step: unsupported device {x.device}")
    return _cg_step_cuda(lap, x, r, p, rz, rr, it, live, thresh, max_iters, leaves, trace)


def _check(lap, x, r, p, rz, rr, it, live, thresh, leaves):
    """The kernel's input contract; returns (rows, n, k)."""
    if x.dim() != 2:
        raise ValueError(f"cg_step takes a (rows, n) state, got {tuple(x.shape)}")
    rows, n = x.shape
    k = leaves.defl_q.shape[-1]
    device = x.device
    expect = {
        "lap": (lap, (rows, n)), "x": (x, (rows, n)), "r": (r, (rows, n)), "p": (p, (rows, n)),
        "rz": (rz, (rows,)), "rr": (rr, (rows,)), "thresh": (thresh, (rows,)),
        "shifts": (leaves.shifts, (rows,)), "null": (leaves.null, (rows,)),
        "av": (leaves.av, (n,)), "s": (leaves.s, (n,)), "real": (leaves.real, (n,)),
        "jacobi": (leaves.jacobi, (rows, n)), "n_real": (leaves.n_real, ()),
        "defl_q": (leaves.defl_q, (n, k)), "defl_qt": (leaves.defl_qt, (k, n)),
        "defl_winv": (leaves.defl_winv, (rows, k)),
    }
    for name, (t, shape) in expect.items():
        if t.dtype != torch.float32:
            raise TypeError(f"cg_step takes float32, got {t.dtype} for {name}")
        flat = (t.numel(),) if len(shape) == 1 else tuple(t.shape)
        if t.device != device or flat != shape or not t.is_contiguous():
            raise ValueError(f"cg_step: {name} must be contiguous {shape} on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    for name in ("lap", "x", "r", "p", "jacobi"):
        if expect[name][0].data_ptr() % 16:
            raise ValueError(f"cg_step reads {name} 16 bytes at a time: it must be 16-byte aligned")
    for name, t, dtype in (("it", it, torch.int64), ("live", live, torch.bool)):
        if t.dtype != dtype or t.numel() != 1 or t.device != device:
            raise ValueError(f"cg_step: {name} must be one {dtype} on {device}")
    if not 1 <= rows <= 65535:
        raise ValueError(f"cg_step: {rows} rows")
    return rows, n, k


def _cg_step_cuda(lap, x, r, p, rz, rr, it, live, thresh, max_iters, leaves, trace):
    from dots_socp_torch.ops import _build

    if not torch.cuda.is_available():
        raise RuntimeError("cg_step: CUDA is not available")
    rows, n, k = _check(lap, x, r, p, rz, rr, it, live, thresh, leaves)
    device = x.device
    prepare(device)
    red = row_sum_config(rows, n, *_card(device))
    red_c = (ctypes.c_int * len(red))(*red)
    staging = torch.empty(2 * -(-rows // red[8]) * red[9], dtype=torch.float32, device=device)
    scal = torch.empty(len(SCALARS) * rows, dtype=torch.float32, device=device)
    sr, z = torch.empty_like(x), torch.empty_like(x)
    lv = leaves
    lib = _build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    max_iters = min(int(max_iters), 2**31 - 1)

    def launch(stage, g=None):
        global KERNEL_LAUNCHES
        err = lib.dots_cg_step_f32(
            stage, lap.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), rz.data_ptr(),
            rr.data_ptr(), it.data_ptr(), live.data_ptr(), thresh.data_ptr(),
            lv.shifts.data_ptr(), lv.av.data_ptr(), lv.jacobi.data_ptr(), lv.s.data_ptr(),
            lv.real.data_ptr(), lv.null.data_ptr(), lv.n_real.data_ptr(),
            None if g is None else g.data_ptr(), sr.data_ptr(), z.data_ptr(),
            staging.data_ptr(), scal.data_ptr(), _COUNTER[device].data_ptr(), red_c, rows, n,
            max_iters, stream)
        if err != 0:
            raise RuntimeError(f"cg_step kernel launch (stage {stage}) failed: CUDA error {err}")
        KERNEL_LAUNCHES += 1
        if trace is not None:
            _trace(stage, trace, x, r, p, rz, rr, it, live, sr, z, scal, rows)

    g = None
    with torch.cuda.device(device):  # the C side launches on the current device
        for stage in (1, 2, 3, 4):
            launch(stage)
        if k > 0:
            coef = sr @ lv.defl_q
            g = (coef * lv.defl_winv) @ lv.defl_qt
            if trace is not None:
                trace.update(coef=coef.clone(), g=g.clone())
        launch(5, g)
        launch(6)
    return x, r, p, rz, rr, it, live


def _trace(stage, trace, x, r, p, rz, rr, it, live, sr, z, scal, rows):
    """Copies of what `stage` wrote, under `cg_step_plain`'s names."""
    s = {name: scal[i * rows:(i + 1) * rows, None].clone() for i, name in enumerate(SCALARS)}
    if stage == 1:
        trace.update(den=s["den"], alpha=s["alpha"], step=s["step"] > 0.5)
    elif stage == 2:
        trace.update(x=x.clone(), r1=r.clone())
    elif stage == 3:
        trace.update(mean=s["mean"])
    elif stage == 4:
        trace.update(r=r.clone(), sr=sr.clone())
    elif stage == 5:
        trace.update(z=z.clone(), rr=rr.clone(), rz=rz.clone(), beta=s["beta"])
    else:
        trace.update(p=p.clone(), it=it.clone(), live=live.clone())
