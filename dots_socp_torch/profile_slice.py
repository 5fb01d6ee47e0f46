"""Where the time of the port's iALM loop goes, per iteration, on one GPU.

    python -m dots_socp_torch.profile_slice [--n_space 200 64] [--out FILE]

For each plane resolution, the port's `solver` (ntime 31, float32, on the
card) runs to BASE and to BASE + ITERS iterations (tol 1e-12, never
reached), each once unprofiled and once under `torch.profiler`. Every
per-iteration number is the difference of the two runs divided by ITERS, so
the setup (host factorizations, host-to-device copies) cancels out:

  wall_ms       -- the loop's wall time (history.running_time), unprofiled
  device_ms     -- summed durations of the GPU's kernels and copies
  busy_share    -- device_ms / wall_ms
  launches      -- GPU kernels launched
  host_syncs    -- cudaStreamSynchronize / cudaDeviceSynchronize /
                   cudaEventSynchronize calls (each blocks the host)
  dtoh_copies   -- device-to-host copies
  groups        -- device ms and launches per kernel group (the window SpMV
                   kernel B1, GEMM, reductions, gathers, elementwise, ...)

The inner CG tolerance is fixed (CG_RTOL), so every iteration of the n200
problem does similar work. One JSON object per resolution is printed
(and written to --out as a list, if given), then the card's name and power
limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dots_socp_torch import cli
from dots_socp_torch.ops import window_spmv
from dots_socp_torch.ops.laplacian import CG_COUNTERS

#: Kernel groups by name; the first group whose pattern a name contains wins.
GROUPS = (
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
CG_RTOL = 5e-4
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def group_of(name):
    for group, patterns in GROUPS:
        if any(p in name for p in patterns):
            return group
    return "other"


def solve(geometry, nit):
    from dots_socp_torch.solver import solver

    _, history = solver(
        N_TIME, geometry, nit=nit, tol=1e-12, precision="float32",
        cg_rtol=CG_RTOL, device="cuda",
    )
    torch.cuda.synchronize()
    return history


def profiled_counts(geometry, nit):
    """Device ms, launches, syncs and copies of one solve, by kernel group."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(geometry, nit)
    counts = {"device_ms": 0.0, "launches": 0, "host_syncs": 0, "dtoh_copies": 0}
    groups = {}
    for e in prof.events():
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
    return counts, groups


def profile_cell(n_space):
    geometry = cli.load_geometry("plane", n_space)
    solve(geometry, 3)  # warm-up: kernel build, caches, allocator
    hist = {n: solve(geometry, n) for n in (BASE, BASE + ITERS)}
    wall_ms = (hist[BASE + ITERS].running_time - hist[BASE].running_time) * 1e3 / ITERS

    window_spmv.KERNEL_LAUNCHES = 0
    CG_COUNTERS.reset()
    (c0, g0), (c1, g1) = (profiled_counts(geometry, n) for n in (BASE, BASE + ITERS))
    per_it = {k: (c1[k] - c0[k]) / ITERS for k in c0}
    groups = {
        name: {
            "ms": (g1[name]["ms"] - g0.get(name, {}).get("ms", 0.0)) / ITERS,
            "launches": (g1[name]["launches"] - g0.get(name, {}).get("launches", 0)) / ITERS,
        }
        for name in g1
    }
    return {
        "n_space": n_space,
        "vertices": int(geometry["vertices"].shape[0]),
        "n_time": N_TIME,
        "iterations": [BASE, BASE + ITERS],
        "cg_rtol": CG_RTOL,
        "wall_ms": wall_ms,
        **per_it,
        "busy_share": per_it["device_ms"] / wall_ms,
        "inner_cg_per_outer": CG_COUNTERS.iterations / max(CG_COUNTERS.solves, 1),
        "b1_launches_in_profiled_runs": window_spmv.KERNEL_LAUNCHES,
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"])),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_space", type=int, nargs="+", default=[200, 64])
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
        cell = profile_cell(n)
        cell["card"] = card
        print(json.dumps(cell), flush=True)
        cells.append(cell)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
