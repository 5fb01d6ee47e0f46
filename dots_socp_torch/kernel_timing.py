"""Timing helpers for the port's hand-written kernels on one NVIDIA GPU:
what `bench_kernels.py`, `scripts/k4_sweep.py`, `chip_smoke.py` and the card
tests share.

  device_ms       -- device time per call, from torch.profiler's kernel durations
  median_call_ms  -- latency of one call, host launch overhead included
  launch_times_us -- device time of each launch of a kernel within one call
  window_bound    -- the least time the card could take for one window matvec
  cg_step_bound   -- the same for one fused CG iteration (K4, B1's matvec aside or in)
  library_ms      -- device time of torch.sparse.mm on the same operator and x
  operator_csr, ell_laplacian, shard_inputs -- the inputs of those
  reset_counts, f64_launches -- B1's and K4's launch counters, both dtypes
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

N_TIME = 31
REPS = 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS = 67e12  # H100 SXM FP32 rate outside the tensor cores
FP64_FLOPS = 34e12  # H100 SXM FP64 rate outside the tensor cores


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def reset_counts():
    """B1's and K4's launch counters (float32 and float64) and the CG's
    counters to 0: what follows is one path's."""
    from dots_socp_torch.ops import cg_step, window_spmv
    from dots_socp_torch.ops.laplacian import CG_COUNTERS

    window_spmv.KERNEL_LAUNCHES = cg_step.KERNEL_LAUNCHES = 0
    window_spmv.KERNEL_LAUNCHES_F64 = cg_step.KERNEL_LAUNCHES_F64 = 0
    CG_COUNTERS.reset()


def f64_launches():
    """(B1-f64's, K4-f64's, B1's, K4's) launches since `reset_counts`."""
    from dots_socp_torch.ops import cg_step, window_spmv

    return (window_spmv.KERNEL_LAUNCHES_F64, cg_step.KERNEL_LAUNCHES_F64,
            window_spmv.KERNEL_LAUNCHES, cg_step.KERNEL_LAUNCHES)


def median_call_ms(fn, reps=REPS):
    """Median time of one call of `fn`, from the start of its first kernel
    to the end of its last (CUDA events around each call, synchronised
    between calls, so the host's launch overhead is inside)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps=REPS, tries=3):
    """Device time per call of `fn`: the mean duration of each GPU kernel it
    launches over at least `reps` warm calls (torch.profiler) times that
    kernel's launches per call, summed. Returns (total ms, {kernel name:
    ms}, events); `events` says how good the measurement is: {"calls": calls
    made in a session, "sessions": profiler sessions it took, "seen":
    {kernel name: events recorded}, "launches_per_call": kernel launches in
    one call, "timed_by": "torch.profiler" or "cuda events"}. The profiler
    now and then loses events of a session (a fifth of them, seen on an
    H100 late in a long process), so a session makes
    reps + reps // 2 calls and a kernel needs the events of `reps` of them;
    a session with fewer, or with a kernel seen off any multiple of the
    calls, is measured again. After `tries` such sessions the same calls are
    timed between two CUDA events (idle gaps between kernels included) and
    that time is split over the kernels by their share of what the profiler
    did record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = reps + reps // 2
    fn()
    torch.cuda.synchronize()
    for session in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us, seen = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                total_us[e.name] = total_us.get(e.name, 0.0) + e.time_range.elapsed_us()
                seen[e.name] = seen.get(e.name, 0) + 1
        per_call = {name: max(round(n / calls), 1) for name, n in seen.items()}
        events = {"calls": calls, "sessions": session, "seen": {k[:80]: n for k, n in seen.items()},
                  "launches_per_call": sum(per_call.values()), "timed_by": "torch.profiler"}
        if seen and all(k * reps <= seen[name] <= k * calls + 2 for name, k in per_call.items()):
            by_name = {name: total_us[name] / seen[name] * per_call[name] / 1e3 for name in seen}
            return sum(by_name.values()), by_name, events
    if not seen:
        raise RuntimeError(f"torch.profiler recorded no device event over {calls} calls")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / calls
    recorded = sum(total_us.values())
    events["timed_by"] = "cuda events"
    return ms, {name: ms * t / recorded for name, t in total_us.items()}, events


def launch_times_us(fn, kernel_name, launches, reps=REPS, tries=3):
    """Device µs of each of the `launches` launches of `kernel_name` that
    one call of `fn` makes, in launch order (e.g. a kernel's stages), the
    mean over `reps` profiled calls; None (not measured) when none of
    `tries` profiler sessions recorded every launch (the profiler loses
    events now and then late in a long process, and a lost one would
    shift every later launch to another stage)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA and kernel_name in e.name),
                        key=lambda e: e.time_range.start)
        if len(events) == reps * launches:
            return [sum(e.time_range.elapsed_us() for e in events[i::launches]) / reps
                    for i in range(launches)]
    return None


def operator_csr(op, n_rows, n_cols):
    """The (n_rows, n_cols) CSR matrix (in the operator's value dtype) a
    window operator (B1's, B1-f64's, or one shard's of B2) applies, on the
    operator's device: every nonzero (row, tile_start[row // TV] + lcol,
    vals), padding slots dropped."""
    lcol, vals = op.lcol[:n_rows], op.vals[:n_rows]
    start = op.tile_start.long().repeat_interleave(op.tile_rows)[:n_rows]
    keep = vals != 0
    counts = keep.sum(dim=1)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=vals.device)
    crow[1:] = counts.cumsum(0)
    cols = (start[:, None] + lcol.long())[keep]
    return torch.sparse_csr_tensor(crow, cols, vals[keep], size=(n_rows, n_cols))


def window_bound(op, n_rows, lanes, in_floats, once_bytes=0):
    """The least time the card could take for one matvec of a window
    operator, each input and output moved once: `in_floats` input floats and
    n_rows output floats per mode, 8 bytes (column, value) per nonzero of the
    operator's rows, its tile starts, and `once_bytes` of other arrays that
    do not grow with the modes (B2's int32 window codes); against 2 flops per
    nonzero and mode. Padding slots are not charged. An operator of float64
    values (B1-f64) moves 8-byte elements and 12 bytes a nonzero, against
    the FP64 rate. Returns {"bytes", "flops", "ms", "by"}."""
    nnz = int((op.vals[:n_rows] != 0).sum())
    n_tiles = -(-n_rows // op.tile_rows)
    size = op.vals.element_size()
    n_bytes = (in_floats + n_rows) * lanes * size + nnz * (4 + size) + n_tiles * 4 + once_bytes
    flops = 2 * nnz * lanes
    t_bytes, t_flops = n_bytes / HBM_BYTES_PER_S, flops / (FP64_FLOPS if size == 8 else FP32_FLOPS)
    return {"bytes": int(n_bytes), "flops": int(flops), "ms": max(t_bytes, t_flops) * 1e3,
            "by": "bytes" if t_bytes >= t_flops else "operations"}


def cg_step_bound(rows, n, k, window=None, value_bytes=4):
    """The least time the card could take for one `ops.cg_step` call, each
    input and output moved once: it reads lap, x, r, p and the Jacobi rows
    (rows x n floats each), the Ritz vectors once (n x k; `defl_qt` is a
    copy) and three vertex vectors, and writes x, r and p; against the two
    deflation products' 4 rows n k flops and ~20 per state element. With
    `window` (B1's operator), the whole inner iteration: B1's bytes and
    flops are added, and lap (which B1 writes and K4 reads) and K4's second
    read of p drop out. `value_bytes` 8: K4-f64's doubles, against the FP64
    rate. Returns {"bytes", "flops", "ms", "by"}."""
    n_bytes = (8 * rows * n + n * k + 3 * n + 8 * rows) * value_bytes
    flops = 4 * rows * n * k + 20 * rows * n
    if window is not None:
        b1 = window_bound(window, n, rows, n)
        n_bytes += b1["bytes"] - 3 * rows * n * value_bytes
        flops += b1["flops"]
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flops = flops / (FP64_FLOPS if value_bytes == 8 else FP32_FLOPS)
    return {"bytes": int(n_bytes), "flops": int(flops), "ms": max(t_bytes, t_flops) * 1e3,
            "by": "bytes" if t_bytes >= t_flops else "operations"}


def ialm_step_bound(T, V, F, D, value_bytes=4, phi_bytes=4):
    """The least time the card could take for one `ops.ialm_step` call
    (kernel K6), each input and output moved once: it reads beta_mid (T x 2
    x F x 3 x 3 values), B and E ((T+1) x F x 3 each), A, mu, beta_fst and
    beta_end (T x V each), phi ((T+1) x V of `phi_bytes`) and the operator's
    tri, inc_table (int64), grad_basis, inc_mask and diag_soc; it writes
    z_mid and beta_mid, B, E and dx_phi, and A, lambda_c, z_fst, z_end, mu,
    beta_fst, beta_end and dt_phi. Against ~30 flops per cone-block element
    at the FP32 (FP64 for `value_bytes` 8) rate. Returns {"bytes", "flops",
    "ms", "by"}; the kernel reads beta_mid twice (`reads_twice_bytes`)."""
    mid = 18 * T * F
    face = 3 * (T + 1) * F
    values = 3 * mid + 5 * face + 12 * T * V + 9 * F + 3 * F + V * D
    n_bytes = values * value_bytes + (T + 1) * V * phi_bytes + 8 * (3 * F + V * D)
    flops = 30 * mid + 20 * face + 40 * T * V
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_flops = flops / (FP64_FLOPS if value_bytes == 8 else FP32_FLOPS)
    return {"bytes": int(n_bytes), "flops": int(flops), "ms": max(t_bytes, t_flops) * 1e3,
            "by": "bytes" if t_bytes >= t_flops else "operations",
            "reads_twice_bytes": int(n_bytes + mid * value_bytes)}


def shard_bound(sw, lanes, n_buf):
    """`window_bound` of one shard's B2 call: its inputs are the shard's own
    state and the (lanes, n_buf) export buffer, per mode, and the window
    codes, once."""
    v_chunk = sw.state_in.shape[-1]
    return window_bound(sw, v_chunk, lanes, v_chunk + n_buf, sw.win_codes.shape[-1] * 4)


def library_ms(op, x, n_rows):
    """(device ms, events) of the one PyTorch call that computes the same
    function: torch.sparse.mm(CSR of the operator, x vertex-major (n_cols,
    lanes)); `events` as `device_ms` gives them."""
    csr = operator_csr(op, n_rows, x.shape[-1])
    x_vm = x.reshape(-1, x.shape[-1]).t().contiguous()
    ms, _, events = device_ms(lambda: torch.sparse.mm(csr, x_vm))
    return ms, events


def ell_laplacian(cg_op):
    """The (V, V) float64 cotan Laplacian, on the host, from the CG
    operator's padded-ELL arrays (padding slots hold 0.0)."""
    import scipy.sparse as sp

    idx = cg_op.ell_idx.cpu().numpy()
    w = (cg_op.ell_w_hi if cg_op.ell_w_hi is not None else cg_op.ell_w).cpu().numpy()
    v = idx.shape[0]
    rows = np.repeat(np.arange(v), idx.shape[1])
    return sp.csr_matrix((w.ravel().astype(np.float64), (rows, idx.ravel())), shape=(v, v))


def shard_inputs(sw_all, n_shards, lanes=N_TIME + 1):
    """Every shard's operator on the card, its state in window order and the
    export buffer as the all-gather would concatenate it."""
    from dots_socp_torch.ops import sharded_window

    v_chunk = sw_all.state_in.shape[-1]
    x = np.random.default_rng(2).standard_normal((lanes, n_shards * v_chunk)).astype(np.float32)
    shards = [sharded_window.shard_of(sw_all, s, "cuda") for s in range(n_shards)]
    xs = [sharded_window.window_permute(sw, torch.from_numpy(x[:, s * v_chunk:(s + 1) * v_chunk]).cuda())
          for s, sw in enumerate(shards)]
    buf = torch.cat([xl[..., sw.exp_codes] for sw, xl in zip(shards, xs)], dim=-1).contiguous()
    return x, shards, xs, buf
