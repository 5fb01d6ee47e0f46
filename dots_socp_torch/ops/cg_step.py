"""One inner iteration of the single-device CG phi-solve, fused (kernel K4).

The JAX package's inner CG iteration is the body of a `lax.while_loop`
(`dots_socp_tpu/ops/laplacian.py:928-955`): XLA fuses its elementwise chain
and row reductions around the Pallas SpMV. The port's torch route of the
same iteration, `ops/laplacian.py::_CGSystem.gated_step`, launches some
forty-five kernels; `cg_step` takes the whole iteration after the SpMV as
five launches of three CUDA kernel bodies (`csrc/cg_step.cu`, which explains
its design) and the two deflation GEMMs between them. Its row sums are
PyTorch's, in PyTorch's order, so it gives the torch route's bits; the
walks that sum them are spread over the card by `split_plan`.

`cg_step(lap, x, r, p, rz, rr, it, live, thresh, max_iters, leaves)` updates
the CG state in place, given lap = L p (kernel B1) and the operator's
`CGStepLeaves`; `cg_step_plain` does the same with PyTorch ops, the torch
route's arithmetic in the torch route's order. With `live` false every
output keeps its bits. On a CPU tensor `cg_step` runs the plain version; on
a CUDA tensor it launches the kernel, which takes contiguous float32 (K4)
or float64 (K4-f64, the same bodies in double, for the float64 CG), every
array of one dtype, or raises. `KERNEL_LAUNCHES` counts K4's launches
(STAGES per call), `KERNEL_LAUNCHES_F64` K4-f64's; inside `torch_route()`
the solver takes the torch route on the card too (for comparisons); inside
`walk_plan(lanes, depth, cluster)` the walks take that split (for sweeps).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from dots_socp_torch.ops import graphs

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; the plain version does not count): K4, and K4-f64 apart.
KERNEL_LAUNCHES = 0
KERNEL_LAUNCHES_F64 = 0


def _set_launches(n):
    global KERNEL_LAUNCHES
    KERNEL_LAUNCHES = n


def _set_launches_f64(n):
    global KERNEL_LAUNCHES_F64
    KERNEL_LAUNCHES_F64 = n


# A launch recorded in a CUDA graph counts at every replay (`ops.graphs`).
graphs.register_counter(lambda: KERNEL_LAUNCHES, _set_launches, "cg_step.launches")
graphs.register_counter(lambda: KERNEL_LAUNCHES_F64, _set_launches_f64, "cg_step.launches_f64")

#: The kernel's stages in launch order (`csrc/cg_step.cu`; stage 3 is the
#: null rows' mean and deflation, stage 4 before), and their launches per call.
STAGE_IDS = (1, 2, 3, 5, 6)
STAGE_NAMES = ("den", "update", "null_rows", "precond", "direction")
STAGES = len(STAGE_IDS)
#: Row scalars the kernel keeps between launches: den, alpha, step, mean, beta.
SCALARS = ("den", "alpha", "step", "mean", "beta")
#: Threads of one block of PyTorch's reduce kernel for float, at most.
REDUCE_THREADS = 512
#: Threads of a walk block at most, by the depth of its loads (vectors of
#: each input in flight per thread): the register file at 8 deep. K4-f64's
#: doubles take twice the registers: half the threads.
WALK_THREADS = {4: 512, 8: 256}
WALK_THREADS_F64 = {4: 256, 8: 128}
#: Blocks of a thread block cluster at most (above 8 non-portable: Hopper's 16).
CLUSTER_BLOCKS = 16
#: Lane rows of a null row's virtual blocks (ctas x bh) stage 3 can hold.
NULL_ITEMS = 2048
#: Counters `prepare` makes; a plan that needs more grows them outside a capture.
COUNTERS = 1 + 2 * 65536

_FUSED = True
_PLAN: dict = {}  # the walks' split inside `walk_plan`
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


@contextlib.contextmanager
def walk_plan(lanes=None, depth=None, cluster=None):
    """For its extent, split the walks with `lanes` lane rows per block,
    load `depth` vectors deep and hand the lane rows over in a cluster or
    not (`split_plan`'s overrides; None keeps its choice): the split sweep
    (`scripts/k4_sweep.py`) and the card tests."""
    before = dict(_PLAN)
    _PLAN.update(lanes=lanes, depth=depth, cluster=cluster)
    try:
        yield
    finally:
        _PLAN.clear()
        _PLAN.update(before)


def prepare(device, counters=COUNTERS):
    """Make the kernel's handshake counters on `device` (outside any graph
    capture), at least `counters` of them, 0 between launches (see
    `split_plan`)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    have = _COUNTER.get(device)
    if have is None or have.numel() < counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("cg_step: prepare the counters before a graph capture")
        _COUNTER[device] = torch.zeros(max(counters, COUNTERS), dtype=torch.int32, device=device)


def _last_pow2(n):
    return 1 << (max(int(n), 1).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def row_sum_config(rows, n, sms=132, threads_per_sm=2048):
    """The launch geometry PyTorch's reduce kernel takes for a float32 sum
    over the last axis of a contiguous (rows, n) tensor (`setReduceConfig`
    in ATen/native/cuda/Reduce.cuh, vt0 = input_vec_size = 4, on a card of
    `sms` SMs of `threads_per_sm` threads), which fixes the order of its
    additions. Returns (bw, bh, vec, im0, im1, im2, om1, step_in, step_out,
    ctas) as `csrc/cg_step.cu::Red` reads them.

    A float64 sum over the same rows takes the same geometry: PyTorch's
    sum_functor launches double with the same vt0 = input_vec_size = 4 and
    512 threads a block (`mnt_wrapper`: 256 for complex double alone), and
    nothing in `setReduceConfig` reads the element size; its vectors are
    then 32 bytes, aligned so that a row's head is the same row_off % 4
    elements. K4-f64 reads it from here too (held bit for bit to the
    float64 torch route on the card)."""
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


class SplitPlan(NamedTuple):
    """How the walks (stages 1 and 5) lay PyTorch's reduce geometry on the
    card: each of `blocks` blocks of `threads` threads holds `lanes` lane
    rows (of bw threads: a warp row when bw = 32) of one virtual block
    (output group, cta), `parts` = bh / lanes blocks per virtual block,
    adjacent (one thread block cluster when `cluster`); each thread loads
    `depth` vectors of every input before it adds any. `virtual` = groups
    x ctas virtual blocks; the kernel needs `counters` handshake counters
    and `staging` floats of scratch."""

    lanes: int
    parts: int
    depth: int
    cluster: bool
    groups: int
    ctas: int
    virtual: int
    blocks: int
    threads: int
    counters: int
    staging: int


#: The default split, by whether the virtual blocks alone number at least
#: half the SMs: (blocks per virtual block, load depth, cluster hand-over).
#: Measured on an H100 (`scripts/k4_sweep.py`, PERF.md): where they do not
#: (32 rows at plane n200 and n290: 32 virtual blocks) a cluster of 8
#: blocks, 8 deep; where they do (128 rows; n410's rows split in 17: 544), 4
#: blocks through device memory, 4 deep.
SPLIT_SPREAD = (8, 8, True)
SPLIT_FILLED = (4, 4, False)


def split_plan(red, rows, sms=132, lanes=None, depth=None, cluster=None, elem_bytes=4):
    """The physical grid of the walks for `row_sum_config`'s geometry `red`
    of a (rows, n) state on a card of `sms` SMs (see `SplitPlan`). The
    lanes of a virtual block split into blocks of whole lane rows, so each
    lane row's thread sums and block_x_reduce run as in PyTorch's block;
    the virtual block's block 0 (with `cluster`, through distributed shared
    memory; else the last block to arrive, through `staging`) sums the bh
    lane rows' values in block_y_reduce's order
    (`csrc/cg_step.cu::row_sums`), so the split changes no bit. By default
    SPLIT_SPREAD or SPLIT_FILLED (4 deep where a lane row is too wide for
    more, and always for K4-f64's 8-byte elements, `elem_bytes` 8: 4 vectors
    of doubles are as many bytes in flight as 8 of floats). Layout, as the
    kernel computes it (`plan_layout`): virtual block v = group * ctas +
    cta, its block `part` is v * parts + part and holds
    lane rows part * lanes ...; lane row y's value of sum j goes to
    staging[2 V + (j V + v) bh + y], virtual block v's value to
    staging[j V + v]; counter 0 is stage 6's, 1 + group a split row's
    global pass, 1 + groups + v virtual block v's lane rows."""
    bw, bh, _, _, im1, *_, step_out, ctas = red
    if im1 and ctas * bh > NULL_ITEMS:
        raise ValueError(f"cg_step: rows of {ctas} x {bh} lane rows; stage 3 holds {NULL_ITEMS}")
    groups = -(-rows // step_out)
    virtual = groups * ctas
    whole_warps = max(1, min(bh, 32 // bw))  # a block holds whole warps
    parts, default_depth, default_cluster = SPLIT_FILLED if 2 * virtual >= sms else SPLIT_SPREAD
    cap = WALK_THREADS_F64 if elem_bytes == 8 else WALK_THREADS
    if elem_bytes == 8:
        default_depth = 4
    if depth is None:
        depth = default_depth if bw * whole_warps <= cap[default_depth] else 4
    if depth not in cap:
        raise ValueError(f"split_plan: depth {depth}, not one of {sorted(cap)}")
    if lanes is None:
        lanes = _last_pow2(min(max(whole_warps, bh // parts), max(cap[depth] // bw, 1)))
    if (lanes < whole_warps or lanes > bh or bh % lanes or lanes & (lanes - 1)
            or lanes * bw > cap[depth]):
        raise ValueError(f"split_plan: {lanes} lane rows of {bw} lanes per block do not split "
                         f"{bh} lane rows into whole warps of at most {cap[depth]} "
                         f"threads")
    parts = bh // lanes
    if cluster is None:
        cluster = default_cluster
    cluster = bool(cluster and im1 and parts > 1)  # lane rows to combine across blocks
    if cluster and parts > CLUSTER_BLOCKS:
        raise ValueError(f"split_plan: a cluster holds {CLUSTER_BLOCKS} blocks, not {parts}")
    return SplitPlan(lanes=lanes, parts=parts, depth=depth, cluster=cluster, groups=groups,
                     ctas=ctas, virtual=virtual, blocks=virtual * parts, threads=lanes * bw,
                     counters=1 + groups + virtual, staging=2 * virtual * (1 + bh))


def plan_layout(red, plan):
    """{(group, cta, lane row): (block, staging slot of sum 0, counter)} as
    the kernel lays them out (`split_plan`)."""
    bh, ctas = red[1], red[9]
    out = {}
    for group in range(plan.groups):
        for cta in range(ctas):
            v = group * ctas + cta
            for y in range(bh):
                out[group, cta, y] = (v * plan.parts + y // plan.lanes,
                                      2 * plan.virtual + v * bh + y, 1 + plan.groups + v)
    return out


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
    """The kernel's input contract; returns (rows, n, k). Every array is
    float32 (K4) or every one float64 (K4-f64)."""
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
    dtype = x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cg_step takes float32 or float64, got {dtype}")
    for name, (t, shape) in expect.items():
        if t.dtype != dtype:
            raise TypeError(f"cg_step takes one dtype, {dtype} for x, got {t.dtype} for {name}")
        flat = (t.numel(),) if len(shape) == 1 else tuple(t.shape)
        if t.device != device or flat != shape or not t.is_contiguous():
            raise ValueError(f"cg_step: {name} must be contiguous {shape} on {device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    align = 4 * x.element_size()  # PyTorch's vectors of 4 elements
    for name in ("lap", "x", "r", "p", "jacobi"):
        if expect[name][0].data_ptr() % align:
            raise ValueError(f"cg_step reads {name} {align} bytes at a time: it must be "
                             f"{align}-byte aligned")
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
    rows, n, _ = _check(lap, x, r, p, rz, rr, it, live, thresh, leaves)
    device = x.device
    sms, threads_per_sm = _card(device)
    red = row_sum_config(rows, n, sms, threads_per_sm)
    plan = split_plan(red, rows, sms, elem_bytes=x.element_size(), **_PLAN)
    prepare(device, plan.counters)
    with torch.cuda.device(device):  # the C side launches on the current device
        return run_stages(_build.load(), torch.cuda.current_stream(device).cuda_stream,
                          _COUNTER[device], red, plan, lap, x, r, p, rz, rr, it, live, thresh,
                          max_iters, leaves, trace)


def run_stages(lib, stream, counter, red, plan, lap, x, r, p, rz, rr, it, live, thresh,
               max_iters, leaves, trace=None):
    """One call's STAGES launches through `lib.dots_cg_step_f32` (float64:
    `lib.dots_cg_step_f64`) on `stream`, with the two deflation GEMMs
    between stages 3 and 5: geometry `red`, split `plan`, handshake
    `counter`s (0 between launches); scratch from the state's allocator. A
    launch that returns an error raises."""
    rows, n = x.shape
    k = leaves.defl_q.shape[-1]
    f64 = x.dtype == torch.float64
    kernel = lib.dots_cg_step_f64 if f64 else lib.dots_cg_step_f32
    red_c = (ctypes.c_int * (len(red) + 3))(*red, plan.lanes, plan.depth, int(plan.cluster))
    staging = torch.empty(plan.staging, dtype=x.dtype, device=x.device)
    scal = torch.empty(len(SCALARS) * rows, dtype=x.dtype, device=x.device)
    sr, z = torch.empty_like(x), torch.empty_like(x)
    lv = leaves
    max_iters = min(int(max_iters), 2**31 - 1)

    def launch(stage, g=None):
        global KERNEL_LAUNCHES, KERNEL_LAUNCHES_F64
        err = kernel(
            stage, lap.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), rz.data_ptr(),
            rr.data_ptr(), it.data_ptr(), live.data_ptr(), thresh.data_ptr(),
            lv.shifts.data_ptr(), lv.av.data_ptr(), lv.jacobi.data_ptr(), lv.s.data_ptr(),
            lv.real.data_ptr(), lv.null.data_ptr(), lv.n_real.data_ptr(),
            None if g is None else g.data_ptr(), sr.data_ptr(), z.data_ptr(),
            staging.data_ptr(), scal.data_ptr(), counter.data_ptr(), red_c, rows, n,
            max_iters, stream)
        if err != 0:
            raise RuntimeError(f"cg_step kernel launch (stage {stage}) failed: CUDA error {err}")
        if f64:
            KERNEL_LAUNCHES_F64 += 1
        else:
            KERNEL_LAUNCHES += 1
        if trace is not None:
            _trace(stage, trace, x, r, p, rz, rr, it, live, sr, z, scal, rows)

    g = None
    for stage in STAGE_IDS[:3]:
        launch(stage)
    if k > 0:
        coef = sr @ lv.defl_q
        g = (coef * lv.defl_winv) @ lv.defl_qt
        if trace is not None:
            trace.update(coef=coef.clone(), g=g.clone())
    for stage in STAGE_IDS[3:]:
        launch(stage, g)
    return x, r, p, rz, rr, it, live


def _trace(stage, trace, x, r, p, rz, rr, it, live, sr, z, scal, rows):
    """Copies of what `stage` wrote, under `cg_step_plain`'s names."""
    s = {name: scal[i * rows:(i + 1) * rows, None].clone() for i, name in enumerate(SCALARS)}
    if stage == 1:
        trace.update(den=s["den"], alpha=s["alpha"], step=s["step"] > 0.5)
    elif stage == 2:
        trace.update(x=x.clone(), r1=r.clone())
    elif stage == 3:
        trace.update(mean=s["mean"], r=r.clone(), sr=sr.clone())
    elif stage == 5:
        trace.update(z=z.clone(), rr=rr.clone(), rz=rz.clone(), beta=s["beta"])
    else:
        trace.update(p=p.clone(), it=it.clone(), live=live.clone())
