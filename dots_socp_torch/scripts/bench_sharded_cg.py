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
    args = ap.parse_args(argv)
    on_card = resolve_device(args.device).type == "cuda"

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


if __name__ == "__main__":
    main()
