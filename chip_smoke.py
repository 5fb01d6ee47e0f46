"""Smoke run of the PyTorch port (dots_socp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one JSON line, and a failing phase raises
(exit code != 0, no result line):

1. device   -- CUDA must be present; the card's name and power limit.
2. build    -- nvcc builds the window SpMV kernel from the sources.
3. kernel   -- at plane n200 (V=46,431, T+1=32 modes, float32), with the
               tiles the main path's `build_cg_operator` makes: the kernel
               against its plain PyTorch version on the card and against
               scipy's float64 L @ x on the host (L from the problem's
               float64 ELL arrays, not the window format), each within
               1e-5 * max|y|. Times: device time per call over 50 calls
               (torch.profiler kernel durations; the wrapper's includes its
               transpose of x), and the median latency of one call (CUDA
               events, host launch overhead included).
4. slice    -- the main path: the port's CLI (`dots_socp_torch.cli.main`,
               which runs the reference's `interface.run_dot_surface` with
               the port's solver) on plane n200, ntime 31, tol 1e-4, 100
               iterations, float32, on the card. Checks: the CG phi-solve
               with f64 refinement ran, every inner matvec launched the
               kernel, the KKT values are finite, the stop-set error at the
               last validation is at most half the first, the mass
               conservation error (RMS over time layers of total mass
               minus 1) is finite.
5. spectral -- the flagship problem (plane n64, V=4,810, ntime 31, float32,
               200 iterations) on the dense spectral path: finite KKT, and
               no TF32 on its GEMMs (the pins are set, and an f32 spectral
               solve on the card agrees with its f64 counterpart to 1e-4;
               TF32 would be ~1e-3 off).

Then the kernel summary line, the `nvidia-smi` name and power-limit line,
and the result line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Only the port (`dots_socp_torch`) is imported here, and nothing imports
jax; the port itself reuses the jax-free host modules of dots_socp_tpu
(geometry, data loading, interface).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import dots_socp_torch.ops.window_spmv as window_spmv
from dots_socp_torch import cli
from dots_socp_torch.ops import _build
from dots_socp_torch.ops.laplacian import CG_COUNTERS, SpectralFactor, spectral_solve
from dots_socp_torch.solver.problem import build_problem

N_TIME = 31
KERNEL_TOL = 1e-5  # max |diff| / max |y|: float32 sums in another order
TF32_TOL = 1e-4  # f32 vs f64 spectral solve; TF32 GEMMs give ~6e-4
STOP_SET = [0, 2, 4, 5]
REPS = 50


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ell_laplacian(cg_op):
    """The (V, V) float64 cotan Laplacian, on the host, from the CG
    operator's padded-ELL arrays (padding slots hold 0.0)."""
    idx = cg_op.ell_idx.cpu().numpy()
    w = cg_op.ell_w_hi.cpu().numpy()
    v = idx.shape[0]
    rows = np.repeat(np.arange(v), idx.shape[1])
    return sp.csr_matrix((w.ravel(), (rows, idx.ravel())), shape=(v, v))


def mass_conservation_error(mu):
    """RMS over time layers of each layer's total mass minus 1."""
    mass = np.asarray(mu, dtype=np.float64).sum(axis=1)
    return float(np.sqrt(np.mean((mass - 1.0) ** 2)))


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


def device_ms(fn, reps=REPS):
    """Device time per call of `fn`: the durations of the GPU kernels it
    launches over `reps` warm calls (torch.profiler), summed and divided by
    `reps`; returns (total ms, {kernel name: ms})."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device kernels")
    return sum(by_name.values()), by_name


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    card = nvidia_smi_line()
    emit("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return card


def phase_build():
    path, seconds = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln or "smem" in ln]
    emit("build", library=str(path.name), compile_seconds=round(seconds, 3), ptxas=ptxas)


def phase_kernel(card):
    geometry = cli.load_geometry("plane", 200)
    config, data, _ = build_problem(N_TIME, geometry, dtype="float32", device="cuda")
    wop = data.cg_op.window if data.cg_op is not None else None
    if config.laplacian_mode != "cg" or wop is None or data.cg_op.ell_w_hi is None:
        raise RuntimeError(f"n200 did not build the refined window CG ({config.laplacian_mode})")
    lap = ell_laplacian(data.cg_op)
    v = lap.shape[0]
    x = np.random.default_rng(0).standard_normal((N_TIME + 1, v)).astype(np.float32)
    perm = wop.perm.cpu().numpy()
    iperm = wop.iperm.cpu().numpy()
    xp = torch.from_numpy(np.ascontiguousarray(x[:, perm])).cuda()

    y_kernel = window_spmv.window_matvec(wop, xp)
    y_plain = window_spmv.window_matvec_plain(wop, xp)
    torch.cuda.synchronize()
    y_ref = (lap @ x.astype(np.float64).T).T  # host scipy, float64
    yk = y_kernel.cpu().numpy().astype(np.float64)[:, iperm]
    yp = y_plain.cpu().numpy().astype(np.float64)[:, iperm]
    err_kp = float(np.abs(yk - yp).max())
    err_kr = float(np.abs(yk - y_ref).max())
    err_pr = float(np.abs(yp - y_ref).max())
    scale = float(np.abs(y_ref).max())
    kernel = lambda: window_spmv.window_matvec(wop, xp)
    plain = lambda: window_spmv.window_matvec_plain(wop, xp)
    ms_kernel, kernels = device_ms(kernel)
    ms_plain, _ = device_ms(plain)
    emit("kernel", shape=[N_TIME + 1, v], meta={"tile_rows": wop.tile_rows, "width": wop.width,
         "nnz_width": int(wop.lcol.shape[1]), "tiles": -(-v // wop.tile_rows)},
         max_abs_err_vs_plain=err_kp, max_abs_err_kernel_vs_f64=err_kr,
         max_abs_err_plain_vs_f64=err_pr, max_abs_y=scale,
         device_us={"wrapper": ms_kernel * 1e3, "plain": ms_plain * 1e3,
                    "by_kernel": {k[:60]: t * 1e3 for k, t in kernels.items()}},
         call_us={"wrapper": median_call_ms(kernel) * 1e3, "plain": median_call_ms(plain) * 1e3},
         card=card)
    bound = KERNEL_TOL * scale
    if not (err_kp <= bound and err_kr <= bound and err_pr <= bound):
        raise AssertionError(f"window kernel disagrees: {err_kp}, {err_kr}, {err_pr} > {bound}")
    return {"max_abs_err": err_kp, "ms": ms_kernel, "plain_ms": ms_plain}


def run_cli(n_space, nit):
    argv = ["--example", "plane", "--n_space", str(n_space), "--ntime", str(N_TIME),
            "--tol", "1e-4", "--nit", str(nit), "--precision", "float32", "--device", "cuda"]
    t0 = time.perf_counter()
    solution, geometry, history = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kkt = history.kkt_errors
    if kkt.size == 0 or not np.isfinite(kkt).all():
        raise AssertionError(f"non-finite KKT values at n{n_space}")
    iterations = int(history.kkt_iteration[-1]) + 1
    return solution, history, {
        "vertices": int(geometry["vertices"].shape[0]),
        "iterations": iterations,
        "it_per_s": iterations / history.running_time,
        "solve_seconds": history.running_time,
        "wall_seconds": wall,
        "last_kkt": [float(e) for e in kkt[-1]],
    }


def phase_slice(card):
    window_spmv.KERNEL_LAUNCHES = 0  # count the main path's launches only
    CG_COUNTERS.reset()
    solution, history, stats = run_cli(200, 100)
    launches = window_spmv.KERNEL_LAUNCHES
    counters = dict(vars(CG_COUNTERS))
    stop = np.nanmax(history.kkt_errors[:, STOP_SET], axis=1)
    mass_err = mass_conservation_error(solution["mu"])
    emit("slice", **stats, launches=launches, cg=counters,
         inner_cg_per_outer=CG_COUNTERS.iterations / max(CG_COUNTERS.solves, 1),
         stop_error_first=float(stop[0]), stop_error_last=float(stop[-1]),
         mass_conservation_error=mass_err, card=card)
    if not (CG_COUNTERS.solves > 0 and CG_COUNTERS.refined_solves == CG_COUNTERS.solves):
        raise AssertionError("the n200 solve did not run the refined CG phi-solve")
    if not (launches > 0 and launches == CG_COUNTERS.window_matvecs):
        raise AssertionError(
            f"kernel launches {launches} != window matvecs {CG_COUNTERS.window_matvecs}"
        )
    if not stop[-1] <= 0.5 * stop[0]:
        raise AssertionError(f"stop-set error {stop[0]} -> {stop[-1]}: not halved")
    if not np.isfinite(mass_err):
        raise AssertionError("mass conservation error is not finite")
    return launches


def phase_spectral(card):
    pins = {
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
    CG_COUNTERS.reset()
    _, _, stats = run_cli(64, 200)
    if CG_COUNTERS.solves:
        raise AssertionError("the n64 flagship solve took the CG path")
    # The same GEMM chain in f32 and in f64 on the card.
    _, data, _ = build_problem(N_TIME, cli.load_geometry("plane", 64), dtype="float32", device="cuda")
    f32 = data.spectral
    f64 = SpectralFactor(*(t.double() for t in f32))
    rhs = torch.from_numpy(
        np.random.default_rng(1).standard_normal((N_TIME + 1, f32.s.shape[0])).astype(np.float32)
    ).cuda()
    z32 = spectral_solve(f32, rhs).double()
    z64 = spectral_solve(f64, rhs.double())
    rel = float((z32 - z64).abs().max() / z64.abs().max())
    emit("spectral", **stats, tf32_pins=pins, f32_vs_f64_solve=rel, card=card)
    if pins["matmul_allow_tf32"] or pins["cudnn_allow_tf32"] or pins["float32_matmul_precision"] != "highest":
        raise AssertionError(f"TF32 is not pinned off: {pins}")
    if not rel <= TF32_TOL:
        raise AssertionError(f"f32 spectral solve off by {rel} (> {TF32_TOL}): TF32 on the GEMMs?")


def main():
    card = phase_device()
    phase_build()
    kernel = phase_kernel(card)
    launches = phase_slice(card)
    phase_spectral(card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "window_spmv",
        "route": "cuda",
        "source": "dots_socp_torch/ops/csrc/window_spmv.cu",
        "replaces": "dots_socp_tpu/ops/pallas_spmv.py:221",
        "launches": launches,
        **kernel,
    }]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
