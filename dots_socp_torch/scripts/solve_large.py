"""Large-mesh solve TO CONVERGENCE on the card (not an it/s proxy).

Counterpart of the repository's `scripts/solve_large.py`. Runs the full
production solver (auto -> matrix-free CG path with adaptive inexact-ALM
inner rtol and the window SpMV kernel) on a large plane mesh to tol,
reporting wall clock, iteration count, and the KKT trajectory through the
standard history blocks; then measures the CG inner-iteration count at a
grid of inner tolerances on the same problem (the "CG histogram"). The last
line of its output is one JSON object (the keys of the JAX package's script;
on the card also `peak_device_bytes`, torch.cuda.max_memory_allocated).

With --snapshot the state is written every --snapshot_every seconds and on
exit, and a later call with the same path resumes the run: a solve longer
than one call allows runs in legs.

Usage: python -m dots_socp_torch.scripts.solve_large --n_space 200 \
           --ntime 31 --tol 1e-4 [--snapshot state.npz] [--device cpu]
"""

import argparse
import json
import sys
import time
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

CG_HISTOGRAM_RTOLS = (1e-3, 3e-4, 1e-4, 3e-5, 1e-5, 2e-6)


def cg_histogram(n_time, geometry, device):
    """CG inner-iteration count vs inner rtol on this problem: the first
    outer iteration's RHS, cold-started (upper bound; warm starts in the
    loop re-use the previous phi)."""
    from dots_socp_torch.ops.laplacian import cg_solve
    from dots_socp_torch.solver.problem import build_problem, initial_state
    from dots_socp_torch.solver.step import laplacian_rhs

    config, data, extras = build_problem(
        n_time, geometry, dtype="float32", laplacian_mode="cg", device=device
    )
    state = initial_state(config, data, extras)
    rhs = laplacian_rhs(config, data, state)
    hist = {}
    for rtol in CG_HISTOGRAM_RTOLS:
        _, iters = cg_solve(
            data.ops, data.cg_op, rhs, rtol=rtol, max_iters=400, return_iters=True
        )
        hist[f"{rtol:g}"] = int(iters)
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_space", type=int, default=200)
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--nit", type=int, default=20000)
    ap.add_argument("--time_limit", type=float, default=3000)
    ap.add_argument("--log_file", default=None)
    ap.add_argument("--skip_histogram", action="store_true")
    ap.add_argument("--snapshot", default=None,
                    help="crash-safe state snapshot path (resumes if present)")
    ap.add_argument("--snapshot_every", type=float, default=120.0,
                    help="seconds between snapshots; each moves the whole "
                    "state to the host (about 2 GB at V=195k)")
    ap.add_argument("--precision", default="float32",
                    choices=["float32", "float64"],
                    help="solver dtype; at V>=46k the f32 roundoff floor "
                    "(~eps * 1/h^2) sits above tol=1e-4, so converged "
                    "large-mesh solves need float64 or --phi_refine")
    ap.add_argument("--phi_refine", default="auto",
                    choices=["auto", "on", "off"],
                    help="mixed-precision phi (f64 state.phi + f64 iterative "
                    "refinement around the f32 inner CG)")
    ap.add_argument("--cg_rtol", type=float, default=None,
                    help="fixed CG inner rtol (default: adaptive inexact-ALM "
                    "schedule tied to the current KKT error)")
    ap.add_argument("--sigma_freeze_error", type=float, default=None,
                    help="sticky sigma freeze threshold (see solver_socp)")
    ap.add_argument("--max_chunk", type=int, default=128,
                    help="iterations per solver segment: the time limit is "
                    "checked, and a snapshot may be written, between segments")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from dots_socp_torch.data.loader import load_example
    from dots_socp_torch.geometry.normalize import normalize_geometry
    from dots_socp_torch.interface import set_logging_level
    from dots_socp_torch.solver import solver_socp

    set_logging_level(log_level="kkt", log_file=args.log_file)

    _, geometry, _ = load_example(
        example_name="plane", kwargs_generating_mesh={"n": args.n_space}
    )
    geometry, _ = normalize_geometry(geometry)

    t0 = time.perf_counter()
    solution, history = solver_socp(
        args.ntime,
        geometry,
        nit=args.nit,
        tol=args.tol,
        time_limit=args.time_limit,
        precision=args.precision,
        phi_refine=args.phi_refine,
        cg_rtol=args.cg_rtol,
        sigma_freeze_error=args.sigma_freeze_error,
        max_chunk=args.max_chunk,
        snapshot_path=args.snapshot,
        snapshot_every=args.snapshot_every,
        device=args.device,
    )
    wall = time.perf_counter() - t0
    history.print_end_history()
    history.print_steps_time()

    kkt = history.get_current_kkt_errors()
    recorded = np.asarray(history.kkt_iteration)
    recorded = recorded[np.isfinite(recorded)]
    iterations = int(recorded[-1]) if recorded.size else 0
    result = {
        "metric": (
            f"large-mesh solve to tol={args.tol:g} "
            f"(plane n{args.n_space}, T={args.ntime}, "
            f"{'f64' if args.precision == 'float64' else 'f32/refine=' + args.phi_refine}, CG path)"
        ),
        "wall_sec": round(wall, 1),
        "iterations": iterations,
        "iters_per_sec": round(iterations / wall, 2),
        "kkt_stop_error": float(np.nanmax(np.asarray(kkt)[[0, 2, 4, 5]])),
        "converged": bool(np.all(np.asarray(kkt) < args.tol)),
    }

    import torch

    if torch.device(args.device).type == "cuda":
        # Largest device allocation of the solve (set-up included).
        result["peak_device_bytes"] = int(torch.cuda.max_memory_allocated())

    if not args.skip_histogram:
        result["cg_iters_by_rtol_cold"] = cg_histogram(args.ntime, geometry, args.device)

    print(json.dumps(result), flush=True)
    return solution, history, result


if __name__ == "__main__":
    main()
