"""Measure the space-sharded large-mesh CG path on a mesh of processes
(counterpart of `scripts/bench_sharded_cg.py`).

    python -m dots_socp_torch.scripts.bench_sharded_cg --n_space 200 \
        --n_devices 2 [--device cuda|cpu]

One full CG phi-solve (the refined f32 solve of the first iteration's
right-hand side) on a `1xS` mesh of S spawned gloo ranks, which share the
card or run on the CPU, in two layouts of the same blocked problem:

  halo_blocked    -- the halo-exchange incidence matvec
  swindow_blocked -- the per-shard window kernel B2 (its plain version on
                     the CPU)

For each: seconds per solve and per inner matvec on rank 0's clock, inner
iterations, and the collective calls and bytes of one solve, counted where
the port makes them (`ops.collectives.COUNTS`; the port has no compiled
program to read them from). The JAX script's third layout, `gspmd_raw`
(raw vertex order, collectives inserted by GSPMD), has no counterpart: the
port has no GSPMD, and its only sharded layout is the blocked one; the
output says so under that key.

Then the window-traffic accounting: the bytes one matvec must move through
B1's tiles on one device against each shard's B2 tiles
(`kernel_timing.window_bound` / `shard_bound`: state, export buffer,
nonzeros and tile starts, each once).

Ranks sharing one card measure the path, not the speed of several cards.
One JSON line last.

    python -m dots_socp_torch.scripts.bench_sharded_cg --loops --n_space 200 \
        --mesh_shape 1x2 [--dist_backend nccl|gloo] [--device cuda|cpu]

--loops measures the solver's loops on the mesh instead (`--mesh_shape 1x1`:
one process on one device, no mesh, for the single card's numbers beside
them): every rank runs
the public solve (plane n_space, float32, inner rtol fixed at
`profile_slice.CG_RTOL`, tol 1e-12) in turns eager, graphed, graphed, eager
(`graphs.eager()`: the host loops; graphed: the workspace's segments, CUDA
graph replays over nccl, op by op over gloo). Each turn reads a SHORT- and a
LONG-iteration solve, unprofiled for the wall time and once more under
`torch.profiler`, and reports per outer iteration the difference of the two
over LONG - SHORT (setup cancels; the captures' host seconds are taken out of
each solve's wall time): wall ms and it/s, device ms,
kernels, host launch calls and syncs (`profile_slice.tally`), host reads
(the adaptive segment's `graphs.HOST_READS` and the CG loops' flag reads),
collective calls and bytes (`COUNTS`), kernel B2's launches (counted through
replays) beside the window matvecs, B2's device µs per shard-call, and the
inner CG iterations; each turn also names whether it was captured and its
captures (`graphs.STATS`). The default backend is nccl with a card per rank,
else gloo. One JSON line per rank, then one with every rank.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

LAYOUTS = ("halo_blocked", "swindow_blocked")
GSPMD_RAW = ("no counterpart: the port has no GSPMD; the blocked layout with explicit "
             "collectives is its only sharded layout")


def _rank(n_space, ntime, n_devices, cg_rtol, repeats, device):
    """One rank of the benchmark (its process group is up)."""
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.ops.collectives import COUNTS
    from dots_socp_torch.ops.laplacian import CG_COUNTERS, cg_solve
    from dots_socp_torch.parallel.distributed import make_solver_mesh
    from dots_socp_torch.parallel.mesh import shard_problem, shard_state
    from dots_socp_torch.solver.problem import build_problem, initial_state
    from dots_socp_torch.solver.step import laplacian_rhs

    mesh = make_solver_mesh((1, n_devices), device=device)
    config, whole, extras = build_problem(
        ntime, load_geometry("plane", n_space), dtype="float32", laplacian_mode="cg",
        cg_rtol=cg_rtol, space_partitions=n_devices, mesh_axes=(1, n_devices),
        device="cpu", mesh=mesh,
    )
    state = shard_state(mesh, initial_state(config, whole, extras))
    sharded = shard_problem(mesh, whole)
    if sharded.cg_op.swindow is None:
        raise RuntimeError("the blocked problem did not build the sharded window")

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()

    results = {}
    for label in LAYOUTS:
        data = sharded
        if label == "halo_blocked":
            data = data._replace(cg_op=data.cg_op._replace(swindow=None))
        spmd = config.spmd_kwargs(data)

        def solve():
            rhs = laplacian_rhs(config, data, state)
            return cg_solve(data.ops, data.cg_op, rhs, x0=state.phi,
                            max_iters=config.cg_max_iters, rtol=None, return_iters=True,
                            ops_hi=data.ops_hi, **spmd)

        solve()  # warm: the kernel's build and load, the allocator
        COUNTS.reset()
        CG_COUNTERS.reset()
        _, inner = solve()
        counts = COUNTS.snapshot()
        window_matvecs = CG_COUNTERS.window_matvecs
        sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            solve()
        sync()
        per_solve = (time.perf_counter() - t0) / repeats
        results[label] = {
            "collective_calls_per_cg_solve": counts["calls"],
            "collective_bytes_per_cg_solve_by_kind": counts["bytes"],
            "collective_bytes_per_cg_solve": sum(counts["bytes"].values()),
            "all_gather_bytes_per_cg_solve": counts["bytes"].get("space_all_gather", 0),
            "all_gather_calls_per_cg_solve": counts["calls"].get("space_all_gather", 0),
            "wall_sec_per_cg_solve": per_solve,
            "inner_iterations": int(inner),
            "window_matvecs": int(window_matvecs),
            "wall_ms_per_matvec": per_solve / max(inner, 1) * 1e3,
            "v_padded": config.n_vertices,
            "operand_bytes": (ntime + 1) * config.n_vertices * 4,
        }
    return results


LOOP_TURNS = ("eager", "graphed", "graphed", "eager")


def _loop_reading(geometry, nit, kw, on_card):
    """Counts of the `nit`-iteration solve: its wall seconds (unprofiled,
    its captures' seconds taken out), then from a second, profiled run the
    device and host counts and this process's counters."""
    from torch.profiler import ProfilerActivity, profile

    from dots_socp_torch import profile_slice
    from dots_socp_torch.ops import graphs, sharded_window
    from dots_socp_torch.ops.collectives import COUNTS
    from dots_socp_torch.ops.laplacian import CG_COUNTERS

    history = profile_slice.solve(geometry, nit, **kw)
    # The loop's seconds without its captures, which vary from solve to solve
    # by more than a short window's iterations take.
    wall = history.running_time - history.graph_stats["capture_seconds"]
    COUNTS.reset()
    CG_COUNTERS.reset()
    before = (graphs.HOST_READS, sharded_window.KERNEL_LAUNCHES, graphs.STATS.snapshot())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        history = profile_slice.solve(geometry, nit, **kw)
    counts, groups = profile_slice.tally(prof.events())
    b2 = groups.get("window_spmv_B2", {"ms": 0.0, "launches": 0})
    collectives = COUNTS.snapshot()
    return {
        "wall_ms": wall * 1e3, **counts,
        "host_reads": graphs.HOST_READS - before[0],
        "flag_reads": CG_COUNTERS.flag_reads,
        "collective_calls": sum(collectives["calls"].values()),
        "collective_bytes": sum(collectives["bytes"].values()),
        "b2_launches": sharded_window.KERNEL_LAUNCHES - before[1],
        "window_matvecs": CG_COUNTERS.window_matvecs,
        "b2_device_ms": b2["ms"], "b2_kernels": b2["launches"],
        "inner_cg": CG_COUNTERS.iterations,
        "validations": len(history.kkt_iteration),
        "graph_stats": graphs.STATS.since(before[2]),
    }


def loop_turn(geometry, kw, short, long, on_card):
    """One turn of --loops in the caller's mode (`graphs.eager()` or not):
    a SHORT- and a LONG-iteration reading (`profile_slice.solve`'s keywords
    `kw`), and per outer iteration their difference over LONG - SHORT, with
    it/s and B2's device µs per shard-call; the readings' graph work."""
    readings = [_loop_reading(geometry, n, kw, on_card) for n in (short, long)]
    per_it = {k: (readings[1][k] - readings[0][k]) / (long - short)
              for k in readings[0] if k != "graph_stats"}
    per_it["it_per_s"] = 1e3 / per_it["wall_ms"]
    per_it["b2_us_per_call"] = (1e3 * per_it["b2_device_ms"] / per_it["b2_kernels"]
                                if per_it["b2_kernels"] else None)
    return {"per_iteration": per_it, "graph_stats": [r["graph_stats"] for r in readings]}


def _loops_rank(n_space, ntime, mesh_shape, short, long, device):
    """One rank of --loops (its process group is up): LOOP_TURNS, each a
    SHORT- and a LONG-iteration reading."""
    import contextlib

    from dots_socp_torch import profile_slice
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.ops import graphs, resolve_device
    from dots_socp_torch.parallel.distributed import make_solver_mesh

    one = mesh_shape == "1x1"  # one device, no mesh: the single card's loops
    mesh = None if one else make_solver_mesh(mesh_shape, device=device)
    dev = resolve_device(device) if one else mesh.device
    on_card = dev.type == "cuda"
    geometry = load_geometry("plane", n_space)
    kw = dict(n_time=ntime, mesh=mesh, device=str(dev))
    profile_slice.solve(geometry, 3, **kw)  # warm-up: kernels, factor cache, allocator
    turns = []
    for mode in LOOP_TURNS:
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            turns.append({"mode": mode, "captured": graphs.will_capture(dev, mesh),
                          **loop_turn(geometry, kw, short, long, on_card)})
    return {"mesh": mesh_shape, "backend": None if one else mesh.backend,
            "world_rank": 0 if one else mesh.world_rank, "device": str(dev),
            "iterations": [short, long], "turns": turns}


def window_traffic(n_space, ntime, n_devices):
    """Bytes one matvec must move: B1's tiles on one device against every
    shard's B2 tiles of the blocked problem (host arrays only)."""
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.kernel_timing import shard_bound, window_bound
    from dots_socp_torch.ops.sharded_window import shard_of
    from dots_socp_torch.solver.problem import build_problem

    geometry = load_geometry("plane", n_space)
    lanes = ntime + 1
    kw = dict(dtype="float32", laplacian_mode="cg", cg_deflation_k=0, device="cpu")
    traffic = {}
    _, single, _ = build_problem(ntime, geometry, **kw)
    wop = single.cg_op.window
    if wop is not None:
        v = single.ops.av.shape[0]
        traffic["single_device"] = dict(
            window_bound(wop, v, lanes, v), tile_rows=wop.tile_rows, width=wop.width
        )
    _, blocked, _ = build_problem(
        ntime, geometry, space_partitions=n_devices, mesh_axes=(1, n_devices), **kw
    )
    sw = blocked.cg_op.swindow
    if sw is not None:
        n_buf = n_devices * sw.exp_codes.shape[-1]
        per_shard = [shard_bound(shard_of(sw, s, "cpu"), lanes, n_buf) for s in range(n_devices)]
        total = sum(b["bytes"] for b in per_shard)
        worst = max(b["bytes"] for b in per_shard)
        traffic["sharded"] = {"bytes_per_shard": [b["bytes"] for b in per_shard],
                              "bytes": total, "tile_rows": sw.tile_rows, "width": sw.width,
                              "export_buffer_floats_per_mode": n_buf}
        if wop is not None:
            t1 = traffic["single_device"]["bytes"]
            traffic["kernel_speedup_vs_single"] = t1 / worst
            traffic["total_traffic_ratio_sharded_vs_single"] = total / t1
    return traffic


def main(argv=None):
    from dots_socp_torch.kernel_timing import nvidia_smi_line
    from dots_socp_torch.ops import resolve_device
    from dots_socp_torch.parallel.spawn import run_on_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_space", type=int, default=200)
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--n_devices", type=int, default=2, help="space shards = ranks (default 2)")
    ap.add_argument("--cg_rtol", type=float, default=1e-4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default cuda: the ranks share the card "
                    "through gloo; cpu runs the kernels' plain versions)")
    ap.add_argument("--loops", action="store_true",
                    help="measure the solver's loops on the mesh, graphed against eager")
    ap.add_argument("--mesh_shape", default=None, help="--loops: TxS (default 1x<n_devices>)")
    ap.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                    help="--loops: default nccl with a card per rank, else gloo")
    ap.add_argument("--short", type=int, default=10, help="--loops: the short solve's iterations")
    ap.add_argument("--long", type=int, default=50, help="--loops: the long solve's iterations")
    args = ap.parse_args(argv)
    on_card = resolve_device(args.device).type == "cuda"
    if args.loops:
        return loops_main(args, on_card)

    ranks = run_on_ranks(_rank, args.n_devices, (args.n_space, args.ntime, args.n_devices,
                                                 args.cg_rtol, args.repeats, args.device))
    layouts = ranks[0]
    for label in LAYOUTS:
        print(json.dumps({label: layouts[label]}), flush=True)
    layouts["gspmd_raw"] = GSPMD_RAW
    halo, swin = layouts["halo_blocked"], layouts["swindow_blocked"]
    out = {
        "metric": (f"sharded CG phi-solve (plane n{args.n_space}, T={args.ntime}, f32, "
                   f"1x{args.n_devices} mesh of gloo ranks on {args.device})"),
        "card": nvidia_smi_line() if on_card else None,
        "layouts": layouts,
        "swindow_vs_halo_all_gather_bytes": (
            swin["all_gather_bytes_per_cg_solve"] / max(halo["all_gather_bytes_per_cg_solve"], 1)
        ),
        "window_traffic": window_traffic(args.n_space, args.ntime, args.n_devices),
    }
    print(json.dumps(out), flush=True)
    return out


def loops_main(args, on_card):
    """--loops: `_loops_rank` on every rank of the mesh; one line per rank."""
    from dots_socp_torch.kernel_timing import nvidia_smi_line
    from dots_socp_torch.parallel.distributed import parse_mesh_shape
    from dots_socp_torch.parallel.spawn import run_on_ranks

    shape = args.mesh_shape or f"1x{args.n_devices}"
    time_axis, space_axis = parse_mesh_shape(shape)
    world = time_axis * space_axis
    backend = args.dist_backend or (
        "nccl" if on_card and torch.cuda.device_count() >= world else "gloo")
    ranks = run_on_ranks(_loops_rank, world, (args.n_space, args.ntime, shape, args.short,
                                             args.long, args.device), backend=backend)
    for rank in ranks:
        print(json.dumps(rank), flush=True)
    out = {
        "metric": (f"the solver's loops on a {shape} mesh over {backend} (plane n{args.n_space}, "
                   f"T={args.ntime}, f32, inner rtol fixed), per outer iteration, eager and "
                   f"graphed in turns {list(LOOP_TURNS)}"),
        "card": nvidia_smi_line() if on_card else None,
        "cards": torch.cuda.device_count() if on_card else 0,
        "ranks": ranks,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
