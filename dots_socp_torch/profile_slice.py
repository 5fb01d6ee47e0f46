"""Where the time of the port's iALM loop goes, per iteration, on one GPU.

    python -m dots_socp_torch.profile_slice [--n_space 200 64] [--eager] \
        [--cg_blocks 4 8 16] [--inner] [--skip_near] [--out FILE]

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
  flag_reads    -- the CG loops' reads of their flags (one per block of
                   inner iterations and per refinement check; eager: one per
                   inner iteration)
  peak_memory_mb -- torch.cuda.max_memory_allocated over the cell's solves
  groups        -- device ms and launches per kernel group (the window SpMV
                   kernel B1, the fused CG iteration K4, GEMM, reductions,
                   gathers, elementwise, ...)
  graph_stats   -- per solve (`running_time_s`'s order): the CUDA graph
                   captures, their host seconds and the graph cache's
                   misses (`ops.graphs.STATS`); a reading with a capture
                   or a miss inside the loop is named by them

The inner CG tolerance is fixed (CG_RTOL), so every iteration of the n200
problem does similar work.

`near_tolerance` (left out with --skip_near), a second window of each
cell, is read the same way at the
end of a solve to NEAR_TOL: a solve that converges after N iterations against
one cut at N - NEAR_ITERS. There the KKT cadence's interval is 1 or near it
(`validations_per_iteration` says how near), so the validations' host cost
per iteration shows directly; the first window sees them only at the
sigma cadence of the early iterations (every 3 or 7).

--inner adds `inner_iteration` to each CG cell: the kernels of one inner CG
iteration (the mean over CG_BLOCK of them) on a settled state
(`scripts.common.settled_cg_state`), on the torch route
(`_CGSystem.gated_step`) and on kernel K4's (`_CGSystem.fused_step`), each
kernel with the line of `ops/laplacian.py` or `ops/cg_step.py` whose torch
call launched it ("ctypes" for B1 and K4), its device µs and launches.

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
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile, record_function

from dots_socp_torch import cli
from dots_socp_torch.ops import graphs, laplacian, window_spmv
from dots_socp_torch.ops.laplacian import CG_COUNTERS

#: Kernel groups by name; the first group whose pattern a name contains wins.
GROUPS = (
    ("window_spmv_B2", ("sharded_window_spmv",)),
    ("window_spmv_B1", ("window_spmv",)),
    ("cg_step", ("cg_step",)),
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
#: Files whose lines `inner_iteration` names as launch sites.
SITES = ("ops/laplacian.py", "ops/cg_step.py")
_LABELS = tuple(f"{Path(site).name}:" for site in SITES)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cudaGraphLaunch")


def group_of(name):
    for group, patterns in GROUPS:
        if any(p in name for p in patterns):
            return group
    return "other"


def solve(geometry, nit, tol=1e-12, device="cuda", n_time=N_TIME, mesh=None):
    """The solve of one reading (on `mesh`, this rank's shard); its graph
    work (`graphs.STATS`) rides on the history as `graph_stats`."""
    from dots_socp_torch.solver import solver

    before = graphs.STATS.snapshot()
    _, history = solver(
        n_time, geometry, nit=nit, tol=tol, precision="float32",
        cg_rtol=CG_RTOL, device=device, mesh=mesh,
    )
    if torch.device(device if mesh is None else mesh.device).type == "cuda":
        torch.cuda.synchronize()
    history.graph_stats = graphs.STATS.since(before)
    return history


def profiled_counts(geometry, nit, tol=1e-12):
    """Device ms, launches, launch calls, syncs and copies of one solve, by
    kernel group, its validations (KKT tables recorded) and its host reads:
    the adaptive segment's (`host_reads`) and the CG loops' flags
    (`flag_reads`)."""
    reads, flags = graphs.HOST_READS, CG_COUNTERS.flag_reads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        history = solve(geometry, nit, tol)
    counts, groups = tally(prof.events())
    counts["validations"] = len(history.kkt_iteration)
    counts["host_reads"] = graphs.HOST_READS - reads
    counts["flag_reads"] = CG_COUNTERS.flag_reads - flags
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


def profile_cell(n_space, eager=False, near=True):
    with graphs.eager() if eager else contextlib.nullcontext():
        torch.cuda.reset_peak_memory_stats()
        cell = _profile_cell(n_space, near)
    cell["cg_block"] = None if eager else laplacian.CG_BLOCK
    cell["peak_memory_mb"] = torch.cuda.max_memory_allocated() / 2**20
    return cell


def _profile_cell(n_space, near=True):
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
    # latched iterations through K4, live and no-op (the no-ops: this less the above)
    cell["fused_steps_per_outer"] = CG_COUNTERS.fused_steps / max(CG_COUNTERS.solves, 1)
    cell["b1_launches_in_profiled_runs"] = window_spmv.KERNEL_LAUNCHES
    if not near:
        return cell
    converged = int(solve(geometry, NEAR_NIT, NEAR_TOL).kkt_iteration[-1]) + 1
    cell["near_tolerance"] = {"tol": NEAR_TOL, "converged_at": converged,
                              **_window(geometry, converged - NEAR_ITERS, converged, NEAR_TOL)}
    return cell


def _window(geometry, short, long, tol):
    """Per-iteration numbers of the iterations between a `short` and a
    `long` solve at `tol`."""
    iters = long - short
    times, stats = {short: [], long: []}, {short: [], long: []}
    for _ in range(WALL_REPEATS):
        for n, runs in times.items():
            history = solve(geometry, n, tol)
            runs.append(history.running_time)
            stats[n].append(history.graph_stats)
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
        "graph_stats": {str(n): runs for n, runs in stats.items()},
        **per_it,
        "busy_share": per_it["device_ms"] / wall_ms,
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"])),
    }


class _LaunchSites(TorchFunctionMode):
    """Wraps every torch call made from a line of SITES in a profiler range
    named by that file and line, so that a kernel's chain of parent events
    names the line that launched it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        frame = sys._getframe(1)
        while frame is not None and not frame.f_code.co_filename.endswith(SITES):
            frame = frame.f_back
        if frame is None:
            return func(*args, **(kwargs or {}))
        with record_function(f"{Path(frame.f_code.co_filename).name}:{frame.f_lineno}"):
            return func(*args, **(kwargs or {}))


def launch_sites(events, calls):
    """Per (launch site, kernel): device µs and launches per call over
    `calls` calls; a kernel with no torch call among its parents (a ctypes
    launch) has the site "ctypes". Sorted by site."""
    rows, linked = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.kernels:
            parent = e
            while parent is not None and not parent.name.startswith(_LABELS):
                parent = parent.cpu_parent
            site = parent.name if parent is not None else "other"
            for k in e.kernels:
                row = rows.setdefault((site, k.name), {"us": 0.0, "launches": 0})
                row["us"] += k.duration
                row["launches"] += 1
                linked[k.name] = linked.get(k.name, 0) + 1
    for e in events:  # device events no torch call launched (not the ranges' own)
        if e.device_type == DeviceType.CUDA and not e.name.startswith(_LABELS):
            if linked.get(e.name, 0) > 0:
                linked[e.name] -= 1
                continue
            row = rows.setdefault(("ctypes", e.name), {"us": 0.0, "launches": 0})
            row["us"] += e.time_range.elapsed_us()
            row["launches"] += 1
    return [{"site": site, "kernel": name[:80], "us": row["us"] / calls,
             "launches": row["launches"] / calls}
            for (site, name), row in sorted(rows.items(), key=lambda kv: _site_key(kv[0][0]))]


def _site_key(site):
    name, _, line = site.rpartition(":")
    return (name, int(line)) if line.isdigit() else (site, 0)


def inner_iteration(n_space, device="cuda"):
    """One inner CG iteration of plane `n_space` on each route, kernel by
    kernel with its launch site (`launch_sites`), over CG_BLOCK iterations
    of a settled state that stays live."""
    from dots_socp_torch.scripts.common import settled_cg_state

    cg, st = settled_cg_state(n_space, N_TIME, device)
    names = ("x", "r", "p", "rz", "rr", "it", "live")
    iters = laplacian.CG_BLOCK
    out = {"iterations": iters}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    for route, step in (("torch", cg.gated_step), ("cg_step", cg.fused_step)):
        state = step(*(st[k].clone() for k in names), st["thresh"], 2**31 - 1)  # warm-up
        if device == "cuda":
            torch.cuda.synchronize()
        with profile(activities=activities) as prof, _LaunchSites():
            for _ in range(iters):
                state = step(*state, st["thresh"], 2**31 - 1)
            if device == "cuda":
                torch.cuda.synchronize()
        kernels = launch_sites(prof.events(), iters)
        out[route] = {"device_us": sum(k["us"] for k in kernels),
                      "launches": sum(k["launches"] for k in kernels
                                      if not k["kernel"].startswith("Memcpy")),
                      "kernels": kernels}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_space", type=int, nargs="+", default=[200, 64])
    parser.add_argument("--eager", action="store_true",
                        help="no CUDA graphs: every op launched from the host")
    parser.add_argument("--cg_blocks", type=int, nargs="+", default=None,
                        help="block lengths of the latched CG to profile (default: CG_BLOCK)")
    parser.add_argument("--skip_near", action="store_true",
                        help="leave out the near-tolerance window (a solve to tol 1e-4)")
    parser.add_argument("--inner", action="store_true",
                        help="also the kernels of one inner CG iteration, by launch site")
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
            cell = profile_cell(n, args.eager, near=not args.skip_near)
            if args.inner and cell["inner_cg_per_outer"] > 0:
                cell["inner_iteration"] = inner_iteration(n)
            cell["card"] = card
            print(json.dumps(cell), flush=True)
            cells.append(cell)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
