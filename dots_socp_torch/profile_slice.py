"""Where the time of the port's iALM loop goes, per iteration, on one GPU.

    python -m dots_socp_torch.profile_slice [--n_space 200 64] [--eager] \
        [--cg_blocks 4 8 16] [--out FILE]

For each plane resolution, the port's `solver` (ntime 31, float32, on the
card) runs to BASE and to BASE + ITERS iterations (tol 1e-12, never
reached), each WALL_REPEATS times unprofiled (in turns) and once under
`torch.profiler`. Every per-iteration number is the difference of the two
lengths divided by ITERS, so the setup (host factorizations, host-to-device
copies) and a solve's one-time costs (CUDA graph captures) cancel out:

  wall_ms       -- the loop's wall time (history.running_time), unprofiled,
                   from the fastest run of each length (`running_time_s`
                   lists them all: a solve's captures vary by more than 40
                   spectral iterations take)
  device_ms     -- summed durations of the GPU's kernels and copies
  busy_share    -- device_ms / wall_ms
  launches      -- GPU kernels run (a CUDA graph replays its kernels: it
                   does not make fewer of them)
  host_launch_calls -- the host's calls that launch device work:
                   cudaLaunchKernel / cudaLaunchKernelExC / cuLaunchKernel
                   (one per eager kernel) and cudaGraphLaunch (one per
                   replay, whatever the graph holds)
  host_syncs    -- cudaStreamSynchronize / cudaDeviceSynchronize /
                   cudaEventSynchronize calls (each blocks the host)
  dtoh_copies   -- device-to-host copies
  host_reads    -- the adaptive segment's reads of the device (`graphs.read`:
                   one per validation, one of the records per segment)
  peak_memory_mb -- torch.cuda.max_memory_allocated over the cell's solves
  groups        -- device ms and launches per kernel group (the window SpMV
                   kernel B1, GEMM, reductions, gathers, elementwise, ...)

The inner CG tolerance is fixed (CG_RTOL), so every iteration of the n200
problem does similar work.

`near_tolerance`, a second window of each cell, is read the same way at the
end of a solve to NEAR_TOL: a solve that converges after N iterations against
one cut at N - NEAR_ITERS. There the KKT cadence's interval is 1 or near it
(`validations_per_iteration` says how near), so the validations' host cost
per iteration shows directly; the first window sees them only at the
sigma cadence of the early iterations (every 3 or 7).

--eager runs the solves inside `graphs.eager()`: every op launched from the
host and the CG's flag read every inner iteration, as before CUDA graphs.
--cg_blocks profiles each cell once per block length of the latched CG
(`ops.laplacian.CG_BLOCK`, the inner iterations between two host reads),
the way its default was chosen. One JSON object per resolution (and block
length) is printed (and written to --out as a list, if given), then the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dots_socp_torch import cli
from dots_socp_torch.ops import graphs, laplacian, window_spmv
from dots_socp_torch.ops.laplacian import CG_COUNTERS

#: Kernel groups by name; the first group whose pattern a name contains wins.
GROUPS = (
    ("window_spmv_B2", ("sharded_window_spmv",)),
    ("window_spmv_B1", ("window_spmv",)),
    ("gemm", ("gemm", "gemv", "xmma", "cutlass", "splitKreduce")),
    ("reduction", ("reduce_kernel",)),
    ("gather_index", ("index", "gather", "scatter")),
    ("cat", ("CatArray",)),
    ("memcpy_dtoh", ("Memcpy DtoH",)),
    ("memcpy_memset", ("Memcpy", "Memset")),
    ("elementwise", ("elementwise",)),
)
N_TIME, BASE, ITERS = 31, 10, 40
NEAR_TOL, NEAR_ITERS, NEAR_NIT = 1e-4, 20, 4000
WALL_REPEATS = 3
CG_RTOL = 5e-4
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaGraphLaunch")


def group_of(name):
    for group, patterns in GROUPS:
        if any(p in name for p in patterns):
            return group
    return "other"


def solve(geometry, nit, tol=1e-12):
    from dots_socp_torch.solver import solver

    _, history = solver(
        N_TIME, geometry, nit=nit, tol=tol, precision="float32",
        cg_rtol=CG_RTOL, device="cuda",
    )
    torch.cuda.synchronize()
    return history


def profiled_counts(geometry, nit, tol=1e-12):
    """Device ms, launches, launch calls, syncs and copies of one solve, by
    kernel group, and its validations (KKT tables recorded)."""
    reads = graphs.HOST_READS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        history = solve(geometry, nit, tol)
    counts, groups = tally(prof.events())
    counts["validations"] = len(history.kkt_iteration)
    counts["host_reads"] = graphs.HOST_READS - reads
    return counts, groups


def tally(events):
    """(counts, groups) of profiler events: device events by kernel group,
    the host's launch and sync calls by name."""
    counts = {"device_ms": 0.0, "launches": 0, "host_launch_calls": 0, "host_syncs": 0,
              "dtoh_copies": 0}
    groups = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            group = group_of(e.name)
            g = groups.setdefault(group, {"ms": 0.0, "launches": 0})
            g["ms"] += ms
            g["launches"] += 1
            counts["device_ms"] += ms
            if not group.startswith("memcpy"):
                counts["launches"] += 1
            if group == "memcpy_dtoh":
                counts["dtoh_copies"] += 1
        elif e.name in SYNC_CALLS:
            counts["host_syncs"] += 1
        elif e.name in LAUNCH_CALLS:
            counts["host_launch_calls"] += 1
    return counts, groups


def profile_cell(n_space, eager=False):
    with graphs.eager() if eager else contextlib.nullcontext():
        torch.cuda.reset_peak_memory_stats()
        cell = _profile_cell(n_space)
    cell["cg_block"] = None if eager else laplacian.CG_BLOCK
    cell["peak_memory_mb"] = torch.cuda.max_memory_allocated() / 2**20
    return cell


def _profile_cell(n_space):
    geometry = cli.load_geometry("plane", n_space)
    solve(geometry, 3)  # warm-up: kernel build, caches, allocator
    window_spmv.KERNEL_LAUNCHES = 0
    CG_COUNTERS.reset()
    cell = {
        "n_space": n_space,
        "vertices": int(geometry["vertices"].shape[0]),
        "n_time": N_TIME,
        "graphs": graphs.enabled(),
        "cg_rtol": CG_RTOL,
        **_window(geometry, BASE, BASE + ITERS, 1e-12),
    }
    cell["inner_cg_per_outer"] = CG_COUNTERS.iterations / max(CG_COUNTERS.solves, 1)
    cell["b1_launches_in_profiled_runs"] = window_spmv.KERNEL_LAUNCHES
    converged = int(solve(geometry, NEAR_NIT, NEAR_TOL).kkt_iteration[-1]) + 1
    cell["near_tolerance"] = {"tol": NEAR_TOL, "converged_at": converged,
                              **_window(geometry, converged - NEAR_ITERS, converged, NEAR_TOL)}
    return cell


def _window(geometry, short, long, tol):
    """Per-iteration numbers of the iterations between a `short` and a
    `long` solve at `tol`."""
    iters = long - short
    times = {short: [], long: []}
    for _ in range(WALL_REPEATS):
        for n, runs in times.items():
            runs.append(solve(geometry, n, tol).running_time)
    wall_ms = (min(times[long]) - min(times[short])) * 1e3 / iters

    (c0, g0), (c1, g1) = (profiled_counts(geometry, n, tol) for n in (short, long))
    per_it = {k: (c1[k] - c0[k]) / iters for k in c0}
    groups = {
        name: {
            "ms": (g1[name]["ms"] - g0.get(name, {}).get("ms", 0.0)) / iters,
            "launches": (g1[name]["launches"] - g0.get(name, {}).get("launches", 0)) / iters,
        }
        for name in g1
    }
    per_it["validations_per_iteration"] = per_it.pop("validations")
    return {
        "iterations": [short, long],
        "wall_ms": wall_ms,
        "running_time_s": {str(n): runs for n, runs in times.items()},
        **per_it,
        "busy_share": per_it["device_ms"] / wall_ms,
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"])),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_space", type=int, nargs="+", default=[200, 64])
    parser.add_argument("--eager", action="store_true",
                        help="no CUDA graphs: every op launched from the host")
    parser.add_argument("--cg_blocks", type=int, nargs="+", default=None,
                        help="block lengths of the latched CG to profile (default: CG_BLOCK)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_slice needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cells = []
    for n in args.n_space:
        for block in args.cg_blocks or [laplacian.CG_BLOCK]:
            laplacian.CG_BLOCK = block
            cell = profile_cell(n, args.eager)
            cell["card"] = card
            print(json.dumps(cell), flush=True)
            cells.append(cell)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
