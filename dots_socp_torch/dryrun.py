"""Entry points that prove the port starts: one iteration on one device, and
a dry run of the whole sharded step on a ("time", "space") mesh of
processes (counterpart of `__graft_entry__.py`).

    python -m dots_socp_torch.dryrun [--n_devices 4] [--device cuda|cpu]

`dryrun_multichip(n)` starts `n` ranks (spawned processes, gloo, so that
they may share one card or run on the CPU), with a time axis of 2 when `n`
is even and at least 4, and runs what a real solve dispatches under that
sharding: the initial z-scaling, a chunk of iterations, the KKT table, a
sigma update, an adaptive segment with its validations, 50 more iterations
that must halve the stop-set error, and the refined CG path with f64 phi
on the space shards (kernel B2 on the card, its plain version on the CPU).
Every rank makes the same asserts; a rank that fails or hangs fails the
call, and no rank is left running.
"""

from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np
import torch

from dots_socp_torch.parallel.spawn import RANK_TIMEOUT, run_on_ranks
from dots_socp_torch.scripts.common import plane_problem

STOP_SET = [0, 2, 4, 5]


def entry(device="cuda"):
    """(fn, example_args): one fused iALM iteration on the flagship problem
    (plane n32, ntime 31, float32) on `device`; `fn(*example_args)` is the
    next state."""
    from dots_socp_torch.solver.step import iteration

    config, data, state = plane_problem(32, 31, "float32", device)
    return partial(iteration, config), (data, state)


def _dryrun_on_mesh(mesh, time_axis, space_axis, device):
    """The dry run's sequence on this rank's shard; its numbers."""
    from dots_socp_torch.ops import sharded_window, window_spmv
    from dots_socp_torch.solver.kkt import compute_kkt
    from dots_socp_torch.solver.scaling import apply_penalty_factor, apply_z_scale
    from dots_socp_torch.solver.step import (
        ADAPTIVE_HEADER,
        ADAPTIVE_REC_SIZE,
        run_chunk,
        run_chunk_adaptive,
        run_chunk_kkt,
    )

    # n_time chosen so the (T, ...) arrays divide over the time axis; the
    # (T+1, ...) arrays stay whole in time.
    n_time = 2 * time_axis
    config, data, state = plane_problem(8, n_time, "float32", device, mesh)

    # Initial z-scaling, a chunk of iterations, the KKT table and a sigma
    # update: everything the real solve dispatches, on the shards.
    state = apply_z_scale(state, 2.0, mesh)
    state = run_chunk(config, data, state, 3)
    table = compute_kkt(config, data, state).cpu().numpy()
    state = apply_penalty_factor(state, 1.25)
    state = run_chunk(config, data, state, 1)

    # The solver's main loop: an adaptive segment of iterations, KKT
    # validations and the sigma update.
    max_chunk = 8
    # [last_adjust_it, is_org_kkt, tol, next_checkpoint, sigma_freeze]
    aux = np.asarray([0.0, 0.0, 1e-4, -np.inf, -np.inf], dtype=config.np_dtype)
    state, packed = run_chunk_adaptive(config, data, state, 4, 6, 2, aux, max_chunk)
    assert table.shape == (7, 2)
    assert np.all(np.isfinite(table[:, 0])), f"non-finite KKT errors: {table}"
    assert packed.shape == (ADAPTIVE_HEADER + max_chunk * ADAPTIVE_REC_SIZE,)
    n_checks, it_total = int(packed[0]), int(packed[1])
    assert it_total == 6, f"adaptive segment ran {it_total}/6 iterations"
    assert n_checks >= 1, "adaptive segment performed no validation"
    recs = packed[ADAPTIVE_HEADER:].reshape(max_chunk, ADAPTIVE_REC_SIZE)
    first = recs[0, ADAPTIVE_REC_SIZE - 14 :].reshape(7, 2)
    assert np.all(np.isfinite(first[:, 0])), f"non-finite sharded KKT: {first}"
    assert np.isfinite(float(torch.vdot(state.phi.flatten(), state.phi.flatten())))

    # The sharded solver must converge, not merely stay finite: 50 more
    # iterations at least halve the stop-set KKT error of the first
    # validation above.
    err0 = float(np.nanmax(first[STOP_SET, 0]))
    state, table_late = run_chunk_kkt(config, data, state, 50)
    err1 = float(np.nanmax(table_late.cpu().numpy()[STOP_SET, 0]))
    assert np.isfinite(err1), f"non-finite late sharded KKT: {table_late}"
    assert err1 < err0 / 2, (
        f"sharded solve is not converging: stop-set error {err0:.3e} -> "
        f"{err1:.3e} after 50 more iterations"
    )
    out = {"n_time": n_time, "n_checks": n_checks, "err_first": err0, "err_late": err1}

    # Space-sharded mixed-precision refinement (the large-mesh
    # configuration): f64 phi on the mesh, the f32 inner CG on the
    # per-shard window (kernel B2), the f64 true residual through the halo
    # incidence form (`ProblemData.ops_hi`).
    if space_axis > 1:
        config_r, data_r, state_r = plane_problem(
            8, n_time, "float32", device, mesh,
            laplacian_mode="cg", cg_deflation_k=8, phi_refine=True,
        )
        assert config_r.phi_refine and data_r.ops_hi is not None
        launches = sharded_window.KERNEL_LAUNCHES
        state_r, table_r = run_chunk_kkt(config_r, data_r, state_r, 5)
        assert state_r.phi.dtype == torch.float64
        assert np.all(np.isfinite(table_r.cpu().numpy()[:, 0])), (
            f"non-finite KKT under sharded phi refinement: {table_r}"
        )
        out["b2_launches"] = sharded_window.KERNEL_LAUNCHES - launches
        out["b1_launches"] = window_spmv.KERNEL_LAUNCHES
    return out


def _dryrun_rank(time_axis, space_axis, device):
    """One rank of the dry run (a spawned process, its process group up);
    its numbers, with its graph work (`graphs.STATS`: over gloo no capture,
    every segment op by op)."""
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.parallel.distributed import make_solver_mesh

    mesh = make_solver_mesh((time_axis, space_axis), device=device)
    before = graphs.STATS.snapshot()
    out = _dryrun_on_mesh(mesh, time_axis, space_axis, device)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    stats = graphs.STATS.since(before)
    return {**out, "backend": mesh.backend, "captures": stats["captures"],
            "uncaptured_runs": stats["uncaptured_runs"]}


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = RANK_TIMEOUT) -> dict:
    """Run one full solver step over an `n_devices` ("time", "space") mesh
    of processes on `device`: sharded state, sharded operators, KKT
    reduction, sigma update, the adaptive segment and the refined CG path.
    Returns {"mesh": (T, S), "ranks": [each rank's numbers], "seconds"};
    raises if a rank fails its asserts or outlives `timeout`."""
    # Co-shard time when there are enough ranks (time = 2 x space = n / 2),
    # exercising both mesh axes; pure spatial sharding otherwise.
    time_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    space_axis = n_devices // time_axis
    t0 = time.perf_counter()
    ranks = run_on_ranks(_dryrun_rank, n_devices, (time_axis, space_axis, device), timeout=timeout)
    return {"mesh": (time_axis, space_axis), "ranks": ranks, "seconds": time.perf_counter() - t0}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n_devices", type=int, default=4, help="ranks of the mesh (default 4: 2x2)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every rank (default cuda: the ranks share the "
                        "cards through gloo; cpu runs the kernels' plain versions)")
    args = parser.parse_args(argv)
    out = dryrun_multichip(args.n_devices, device=args.device)
    t, s = out["mesh"]
    print(f"dryrun_multichip({args.n_devices}) on a {t}x{s} mesh: OK ({out['seconds']:.1f} s)")
    return out


if __name__ == "__main__":
    main()
