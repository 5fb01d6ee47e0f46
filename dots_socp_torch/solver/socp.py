"""solver_socp: the iALM orchestration loop (host side).

Counterpart of `dots_socp_tpu/solver/socp.py`:
``solver_socp(n_time, geometry, device="cuda", **kw) -> (SolutionSocpData,
RunningHistory)`` with the reference's defaults, schedules and stopping
semantics. Iterations run in segments (`step.run_chunk_adaptive`) whose
packed records this loop replays into the run history, the cadence and the
sigma schedule, exactly as the reference's loop does.

With `mesh` (a `parallel.distributed.SolverMesh` of shape (Tm, S)) every
rank runs this same loop on its (time, space) shard (JAX `socp.py:228-239,
357-361`): the problem and state are built whole, then cut to the rank's
shard: operators over space, the staggered (T, ...) state arrays over time
as well; the centered (T+1, ...) arrays, phi among them, are whole in time
on every time-rank, which therefore runs the phi-solve of its space group
redundantly. Every host decision reads values that are the same on every
rank (the KKT table is world rank 0's, the wall clock is world rank 0's),
so the ranks run the same iterations and collectives. The solution is
gathered back to the real vertex order on every rank; the run history and
the log come from world rank 0 only.

With `snapshot_path` the state and the host schedules are written to one
.npz file (`utils.snapshot`) every `snapshot_every` seconds and on loop
exit, and a run that finds the file resumes from it. On a mesh world rank
0 decides when (its clock) and writes the gathered state; on resume every
rank reads the file and keeps its shard, so a snapshot written on one mesh
shape resumes on another with the same space axis (its vertex order and
padding); the file names that axis, and another one raises.
"""

from __future__ import annotations

import contextlib
import functools
import io
import logging
import os
import time
from math import exp, sqrt

import numpy as np
import torch

from dots_socp_torch.ops import graphs
from dots_socp_torch.ops.collectives import from_rank0, rank0_decides
from dots_socp_torch.ops.mesh_ops import grad_space
from dots_socp_torch.parallel.distributed import check_time_axis
from dots_socp_torch.parallel.partition import LANE
from dots_socp_torch.parallel.mesh import gather_field, gather_state, shard_problem, shard_state
from dots_socp_torch.ops.time_stencils import grad_time
from dots_socp_torch.solver.kkt import _norms, compute_kkt, objective_functional
from dots_socp_torch.solver.problem import build_problem, initial_state
from dots_socp_torch.solver.scaling import (
    apply_penalty_factor,
    apply_prim_dual_scale,
    apply_z_scale,
    compute_var_norms,
)
from dots_socp_torch.solver.schedule import AdaptiveKKTCadence, SigmaSchedule
from dots_socp_torch.solver.step import (
    ADAPTIVE_HEADER,
    ADAPTIVE_REC_SIZE,
    run_chunk,
    run_chunk_adaptive,
    run_chunk_kkt,
)
from dots_socp_torch.config import LOG_LEVELS
from dots_socp_torch.utils.history import RunningHistory
from dots_socp_torch.utils import trace
from dots_socp_torch.utils.snapshot import load_snapshot, save_snapshot, state_from_arrays
from dots_socp_torch.utils.types import CheckpointDotData, GeometryData, SolutionSocpData

KKT_LABELS = [
    "SOC & Org : Primal Feasibility (q)",
    "SOC       : Primal Feasibility (z)",
    "SOC & Org : Dual Feasibility (alpha)",
    "SOC       : Dual Feasibility (beta)",
    "      Org : ||rho - Pi+(rho + Fq)||",
    "      Org : ||m - rho o B||",
    "      Org : ||cong. rho - lambda_c||",
]
KKT_SHORT_LABELS = [
    "Prim(phi, q)",
    "Prim(q, z)",
    "Dual(alpha)",
    "Dual(beta)",
    "Comp(rho, f(q))",
    "Comp(m, rho o B)",
    "Comp(rho, cong.)",
]

KKT_STOP_CONDITION = [0, 2, 4, 5]
KKT_PRIM_POS = [0, 1]
KKT_DUAL_POS = [2, 3]

STEP_TAG = "Fused iALM step (Lap + SOC + Q + Mult)"
KKT_TAG = "KKT validation"


def _nanmax(values) -> float:
    vals = np.asarray(values, dtype=float)
    finite = vals[~np.isnan(vals)]
    return float(finite.max()) if finite.size else float("nan")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _output_on_rank0(fn):
    """Run `fn` with its log and printed output silenced on every rank of
    a mesh but world rank 0 (the ranks record identical run histories)."""

    @functools.wraps(fn)
    def wrapper(*args, mesh=None, **kwargs):
        if mesh is None or mesh.world_rank == 0:
            return fn(*args, mesh=mesh, **kwargs)
        previous = logging.root.manager.disable
        logging.disable(logging.CRITICAL)
        try:
            sink = io.StringIO()
            with contextlib.redirect_stdout(sink), contextlib.redirect_stderr(sink):
                return fn(*args, mesh=mesh, **kwargs)
        finally:
            logging.disable(previous)

    return wrapper


@trace.problem
@_output_on_rank0
def solver_socp(
    n_time,
    geometry: GeometryData,
    congestion=0.0,
    nit=1000,
    eps=0.0,
    tol=1e-4,
    tau=1.90,
    is_palm=False,
    is_multi_threads=True,
    is_z_scaling=True,
    is_constant_scaling=False,
    check_kkt_step_by_step=False,
    init_solution=None,
    tol_checkpoints=None,
    time_limit=1000,
    precision=None,
    laplacian_mode="auto",
    max_dense_vertices=16384,
    cg_max_iters=200,
    cg_rtol=None,
    cg_deflation_k=None,
    max_chunk=512,
    pad_multiple=None,
    mesh=None,
    snapshot_path=None,
    snapshot_every=300.0,
    sigma_freeze_error=None,
    phi_refine="auto",
    device="cuda",
):
    """Solve the SOCP reformulation of DOT on a discrete surface.

    Parameters mirror `dots_socp_tpu.solver.socp.solver_socp`; the port's:

    device : torch device of the solve ("cuda" by default). Asking for CUDA
        where there is none raises; nothing falls back to the CPU.
    precision : "float32" | "float64" | None (None: float32).
    pad_multiple : pad vertex/triangle counts to this multiple (None: 1).
    phi_refine : "auto" | "on" | "off" | bool; auto = on exactly for the
        float32 CG path (f64 phi + f64 iterative refinement around the f32
        inner CG, whose matvec is the window SpMV kernel).
    mesh : `parallel.distributed.SolverMesh` (`make_solver_mesh("TxS")`):
        this rank solves its space shard of a blocked layout (replacing
        pad_multiple) on mesh.device, which replaces `device`. The inner
        matvec of its CG path is kernel B2 (B1 on one space shard); its
        spectral path sums the shards' partial eigen-coefficients in one
        all-reduce per solve. With T > 1 the rank also holds one block of
        n_time / T staggered time slices; n_time must be a multiple of T.
    snapshot_path : crash-safe periodic snapshot of the state and the host
        schedules to this .npz path (the JAX package's format); if the file
        exists, the run RESUMES from it (same n_time, padded vertex count
        and space axis required: the file names the space axis it was
        written on, and another one raises). Tolerance checkpoints
        recorded before the snapshot are not replayed on resume.
    snapshot_every : seconds between periodic snapshots (a final one is
        always written on loop exit when snapshot_path is set).
    `is_multi_threads` is accepted for API parity.
    """
    if mesh is not None:
        check_time_axis(n_time, mesh.time)  # on every rank, before any collective
    logging.basicConfig(level=LOG_LEVELS["info"], format="%(message)s")

    checkpoint_solutions = []
    if tol_checkpoints is not None:
        if not isinstance(tol_checkpoints, list) or not tol_checkpoints:
            raise ValueError("tol_checkpoints must be a non-empty list")
        for i, cp in enumerate(tol_checkpoints):
            if not (isinstance(cp, (int, float)) and 0 < cp < 1):
                raise ValueError(f"invalid checkpoint at index {i}: {cp}")
            if cp < tol:
                raise ValueError(f"checkpoint ({cp}) < tol ({tol})")
        tol_checkpoints = sorted(tol_checkpoints, reverse=True)

    if precision is None:
        precision = "float32"
    nit = int(nit)
    r = 1.0
    dt = 1.0 / n_time
    if pad_multiple is None:
        pad_multiple = 1
    space_size = mesh.space if mesh is not None else 1
    # The vertex layout of this run's space axis (blocked in per-shard chunks
    # of a multiple of `lane` when it is cut), written into its snapshots.
    space_layout = {"space_axis": space_size, "lane": LANE if space_size > 1 else None}
    sharded = mesh is not None and mesh.space * mesh.time > 1
    if mesh is not None:
        device = mesh.device

    # --- problem assembly (host numpy/scipy, then one move to the device) ---
    # The trace's phase `assembly` runs from the public call's entry to
    # run_history.start().
    cg_rtol_adaptive = cg_rtol is None
    cg_rtol_floor = 1e-12 if precision == "float64" else 2e-6
    sigma_freeze = float(sigma_freeze_error) if sigma_freeze_error is not None else -np.inf
    sigma_frozen = False
    with trace.timed("build_problem") as built:
        config, data, extras = build_problem(
            n_time,
            geometry,
            eps=eps,
            is_palm=is_palm,
            laplacian_mode=laplacian_mode,
            max_dense_vertices=max_dense_vertices,
            cg_max_iters=cg_max_iters,
            cg_rtol=cg_rtol if cg_rtol is not None else 1e-3,
            cg_deflation_k=cg_deflation_k,
            dtype=precision,
            pad_multiple=pad_multiple,
            space_partitions=space_size,
            mesh_axes=(mesh.time, space_size) if mesh is not None else None,
            phi_refine=phi_refine,
            # A sharded problem is built whole on the host, then cut into shards.
            device="cpu" if space_size > 1 else device,
            mesh=mesh,
        )
    if config.phi_refine:
        logging.log(
            LOG_LEVELS["kkt"],
            "Mixed-precision phi: f64 state.phi + f64 iterative refinement "
            "around the f32 inner CG",
        )
    logging.debug(
        "---- Laplace matrix ".ljust(42, "-")
        + f"\nFactorizing the Laplace matrix: {built.seconds:.2f}s."
    )
    # Compare the freeze threshold at the work precision, as the segment does.
    sigma_freeze = float(config.np_dtype(sigma_freeze))

    vertex_slot = extras["vertex_slot"]
    triangle_slot = extras["triangle_slot"]

    logging.log(
        LOG_LEVELS["kkt"],
        "---- Experiment info ".ljust(42, "-") + "\n"
        f"Congestion parameter: {congestion}"
        f"Number of discretization points in time: {n_time}\n"
        f"Number of discretization vertices: {config.n_vertices}\n"
        f"Number of discretization triangles: {config.n_triangles}\n"
        f"Stepsize: {tau}\n"
        f"Is multiple threads: {is_multi_threads}",
    )

    av = extras["av"]
    mu0 = np.asarray(geometry["mu0"], dtype=np.float64)
    mu1 = np.asarray(geometry["mu1"], dtype=np.float64)
    # norm_boundary = r*dt*sqrt(nsc(boundary/av)): only the two boundary
    # rows contribute.
    norm_boundary = r * dt * sqrt(
        (np.sum(mu0**2 / av) + np.sum(mu1**2 / av)) / (r * dt) ** 2 / (n_time + 1)
    )

    with trace.span("initial_state"):
        state = initial_state(
            config,
            data,
            extras,
            init_solution=_pad_init_solution(init_solution or {}, config, extras),
            congestion=congestion,
            tau=tau,
            eps=eps,
            r=r,
            norm_constant_d=extras["norm_constant_d"],
            norm_boundary=norm_boundary,
        )
    # --- resume from an on-disk snapshot (every rank reads the file) --------
    resumed = None
    if snapshot_path is not None and rank0_decides(os.path.exists(snapshot_path), mesh):
        arrays, resumed = load_snapshot(snapshot_path)
        if resumed["n_time"] != n_time or arrays["phi"].shape[1] != config.n_vertices:
            raise ValueError(
                f"snapshot at {snapshot_path} was written for n_time="
                f"{resumed['n_time']}, V={arrays['phi'].shape[1]}; this run has "
                f"n_time={n_time}, V={config.n_vertices}"
            )
        # The vertex order is the space axis's: a file of another space axis
        # with the same padded V would be read in the wrong order. Every rank
        # reads the same file, so every rank raises here, before any
        # collective. A file without the key (the JAX package's) is not checked.
        written = resumed.get("space_layout")
        if written is not None and written != space_layout:
            raise ValueError(
                f"snapshot at {snapshot_path} was written on space axis "
                f"{written['space_axis']} (lane {written['lane']}); this run has space axis "
                f"{space_layout['space_axis']} (lane {space_layout['lane']}): the vertex "
                "order differs"
            )
        state = state_from_arrays(
            arrays, config.torch_dtype, phi_dtype=config.phi_dtype, device=state.phi.device
        )
        logging.log(
            LOG_LEVELS["info"],
            f"Resuming from snapshot {snapshot_path} "
            f"(iteration {resumed['iteration']}, {resumed['elapsed']:.1f}s elapsed)",
        )

    if sharded:
        data = shard_problem(mesh, data)
        state = shard_state(mesh, state)
    device = data.ops.av.device
    if mesh is not None and graphs.enabled():
        how = ("captured as CUDA graphs, collectives inside" if graphs.will_capture(device, mesh)
               else "uncaptured, op by op" + ("" if mesh.capturable else
                                               f" ({mesh.backend} cannot be captured)"))
        logging.log(LOG_LEVELS["info"],
                    f"Mesh {mesh.time}x{mesh.space} over {mesh.backend}: segments run {how}")

    run_history = RunningHistory(
        max_record_numbers=nit + 2,
        kkt_labels=KKT_LABELS,
        kkt_short_labels=KKT_SHORT_LABELS,
        name="SOCP",
    )
    sched = SigmaSchedule()
    cadence = AdaptiveKKTCadence()
    prim_gap = 1.0 + 1.0 * exp(-100 * congestion)
    converged_mask = np.zeros(7, dtype=bool)

    # The phase `loop` runs from run_history.start() to the end of the last segment.
    trace.phase("loop")
    run_history.start()
    run_history.create_tol_progress(target_tol=tol)

    # Initial scalings (already baked into a resumed state).
    if resumed is None:
        with trace.span("scaling"):
            if is_z_scaling:
                logging.log(LOG_LEVELS["scaling"], "Initially scale z with z factor: 2.0")
                state = apply_z_scale(state, 2.0, data.mesh)
            if is_constant_scaling:
                state = _initial_constant_scaling(config, data, state, n_time)

    def fetch_kkt(state):
        with trace.timed("fetch_kkt") as fetched:
            table = _host(compute_kkt(config, data, state))
        run_history.add_step_time(KKT_TAG, fetched.seconds)
        return table[:, 0], table[:, 1]

    def snapshot_checkpoint(state, iteration, org):
        scale = float(state.r) * float(state.dual_scale)
        return CheckpointDotData(
            mu=scale * _host(gather_field(mesh, state.mu, "mu"))[:, vertex_slot],
            E=scale * _host(gather_field(mesh, state.E, "E"))[:, triangle_slot],
            iteration=iteration,
            time=run_history.get_running_time(),
            kkt=list(org),
        )

    it = 0
    it_done = -1
    error = None
    is_org_kkt = False
    start_time = time.perf_counter()
    passed = False

    def set_cg_rtol(value):
        # Replaced, never written in place: `data` is the assembly that
        # `build_problem` keeps for the next call on this mesh.
        nonlocal data
        data = data._replace(
            cg_op=data.cg_op._replace(
                rtol=torch.tensor(value, dtype=config.torch_dtype, device=device)
            )
        )

    if resumed is not None:
        it = int(resumed["iteration"]) + 1
        it_done = int(resumed["iteration"])
        sched.last_adjust_it = int(resumed["last_adjust_it"])
        sched.z_scale_count = int(resumed["z_scale_count"])
        cadence.current_interval = int(resumed["cadence_interval"])
        cadence.counter = int(resumed["cadence_counter"])
        converged_mask[:] = np.asarray(resumed["converged_mask"], dtype=bool)
        is_org_kkt = bool(resumed["is_org_kkt"])
        if resumed.get("tol_checkpoints") is not None:
            tol_checkpoints = list(resumed["tol_checkpoints"])
        sigma_frozen = bool(resumed.get("sigma_frozen", False))
        start_time -= float(resumed["elapsed"])  # time_limit spans the whole run
        # The adaptive inner tolerance the run had reached. The JAX package
        # does not write it (its resumed CG run starts again from 1e-3 until
        # the first validation); without the key this run does the same.
        if cg_rtol_adaptive and data.cg_op is not None and resumed.get("cg_rtol") is not None:
            set_cg_rtol(float(resumed["cg_rtol"]))

    def host_schedule_meta(iteration):
        return {
            "n_time": n_time,
            "iteration": int(iteration),
            "last_adjust_it": int(sched.last_adjust_it),
            "z_scale_count": int(sched.z_scale_count),
            "cadence_interval": int(cadence.current_interval),
            "cadence_counter": int(cadence.counter),
            "converged_mask": [bool(b) for b in converged_mask],
            "is_org_kkt": bool(is_org_kkt),
            "sigma_frozen": bool(sigma_frozen),
            "tol_checkpoints": tol_checkpoints,
            "elapsed": time.perf_counter() - start_time,
            # Port-only keys (the JAX loader ignores unknown keys).
            "cg_rtol": float(data.cg_op.rtol) if data.cg_op is not None else None,
            "space_layout": space_layout,
        }

    last_snapshot_time = time.perf_counter()

    def maybe_snapshot(iteration, force=False):
        """Write the snapshot when forced or due. On a mesh world rank 0's
        clock decides for every rank (the gather below is a collective),
        and world rank 0 writes the gathered state."""
        nonlocal last_snapshot_time
        if snapshot_path is None:
            return
        due = (time.perf_counter() - last_snapshot_time) >= snapshot_every
        if not (force or rank0_decides(due, mesh)):
            return
        whole = gather_state(mesh, state) if sharded else state
        if mesh is None or mesh.world_rank == 0:
            save_snapshot(snapshot_path, whole, host_schedule_meta(iteration))
        last_snapshot_time = time.perf_counter()

    while it < nit:
        # ---- pre-iteration events at iteration `it` ------------------------
        if is_constant_scaling and SigmaSchedule.is_to_scale(it):
            with trace.span("scaling"):
                prim, dual = (_host(t) for t in compute_var_norms(config, data, state))
                pr, dr = SigmaSchedule.compute_scale_factor(
                    prim, dual, msg=f"Var Norm at iteration {it}"
                )
                if max(pr, dr) / min(pr, dr) > 2.0:
                    logging.log(
                        LOG_LEVELS["scaling"],
                        f"Scale/Rescale with (prim, dual) factor: {1.0/pr}, {1.0/dr}",
                    )
                    state = apply_prim_dual_scale(state, pr, dr)

        if is_z_scaling and sched.is_to_scale_matrix(
            it, run_history.get_current_kkt_errors()
        ):
            kkt_now = run_history.get_current_kkt_errors()
            rescale_z = prim_gap * sqrt(kkt_now[1] / kkt_now[0])
            if rescale_z > 1.25:
                logging.log(
                    LOG_LEVELS["scaling"],
                    f"Rescale z at iteration {it} with z factor: {rescale_z}",
                )
                with trace.span("scaling"):
                    state = apply_z_scale(state, rescale_z, data.mesh)

        def process_validation(org, scaled, check_it, whether_adjust, sigma_on_device=False):
            """Record one validated KKT table and run every host schedule
            that keys off it (cadence interval, progress, checkpoints,
            is_org_kkt switch, sigma update). sigma_on_device: the segment
            already applied the sigma update."""
            nonlocal passed, error, is_org_kkt, state, sigma_frozen
            passed = bool(np.all(org < tol))
            if check_kkt_step_by_step:
                cost, lagrangian = map(float, objective_functional(config, data, state))
                run_history.record(
                    current_it=check_it,
                    kkt_errors=org,
                    history={"Transportation cost": cost, "Objective value": lagrangian},
                )
            else:
                run_history.record(current_it=check_it, kkt_errors=org)

            error = _nanmax(org[KKT_STOP_CONDITION])
            if not sigma_frozen and np.isfinite(error) and error < sigma_freeze:
                sigma_frozen = True
                logging.log(
                    LOG_LEVELS["scaling"],
                    f"Sigma frozen at iteration {check_it} "
                    f"(error {error:.2e} < {sigma_freeze:.2e})",
                )
            if np.isfinite(error):
                cadence.set_error_and_tolerance(error, tol)
                # Inexact-ALM inner-tolerance scheduling: the CG phi-solve
                # only needs to be as accurate as the current outer error.
                if cg_rtol_adaptive and config.laplacian_mode == "cg":
                    new_rtol = float(np.clip(0.05 * min(error, 1.0), cg_rtol_floor, 1e-3))
                    if new_rtol != float(data.cg_op.rtol):
                        logging.log(
                            LOG_LEVELS["kkt"],
                            f"CG inner rtol -> {new_rtol:.2e} at iteration {check_it}",
                        )
                        set_cg_rtol(new_rtol)

            if not whether_adjust or check_kkt_step_by_step:
                newly = [
                    i
                    for i in range(7)
                    if np.isfinite(org[i]) and org[i] <= tol and not converged_mask[i]
                ]
                converged_mask[newly] = True
                run_history.show_tol_progress(
                    check_it,
                    error,
                    active_idx=[i for i in range(7) if not converged_mask[i]],
                    converged_idx=newly or None,
                )

            # Checkpoints at the first crossing of each tolerance level,
            # compared at the work precision (as the segment's early exit).
            while (
                tol_checkpoints
                and np.isfinite(error)
                and error <= float(config.np_dtype(tol_checkpoints[0]))
            ):
                checkpoint_solutions.append(snapshot_checkpoint(state, check_it, org))
                tol_checkpoints.pop(0)

            if passed:
                return

            if _nanmax(scaled) < 5 * tol:
                is_org_kkt = True

            if whether_adjust and not sigma_on_device and not sigma_frozen:
                col = org if is_org_kkt else scaled
                prim_error = _nanmax(col[KKT_PRIM_POS])
                dual_error = _nanmax(col[KKT_DUAL_POS])
                if np.isfinite(prim_error) and np.isfinite(dual_error) and dual_error > 0:
                    gap = prim_error / dual_error
                    r_now = float(state.r)
                    factor = sched.updated_sigma(r_now, gap) / r_now
                    if factor != 1.0:
                        state = apply_penalty_factor(state, factor)

        # ---- plan the next segment -----------------------------------------
        if check_kkt_step_by_step:
            stop_after = it
        else:
            stop_after = min(nit - 1, it + max_chunk - 1)
            stop_after = min(
                stop_after, _next_pre_event(it, is_constant_scaling, is_z_scaling, sched) - 1
            )
            stop_after = max(stop_after, it)
        k = stop_after - it + 1

        if not check_kkt_step_by_step:
            # Iterations + validations + sigma updates in one segment.
            aux = np.asarray(
                [
                    float(sched.last_adjust_it),
                    float(is_org_kkt),
                    tol,
                    # -inf sentinel: err <= -inf never fires.
                    tol_checkpoints[0] if tol_checkpoints else -np.inf,
                    # -inf when disabled; +inf once sticky-frozen here.
                    np.inf if sigma_frozen else sigma_freeze,
                ],
                dtype=config.np_dtype,
            )
            with trace.timed("segment", it=it) as seg:
                state, packed = run_chunk_adaptive(
                    config, data, state, it, k, cadence.iterations_until_next(), aux, max_chunk
                )
            run_history.add_step_time(STEP_TAG, seg.seconds)

            n_checks = int(packed[0])
            it_total = int(packed[1])
            sched.last_adjust_it = int(packed[2])
            is_org_kkt = bool(packed[3] > 0.5)
            recs = packed[ADAPTIVE_HEADER:].reshape(max_chunk, ADAPTIVE_REC_SIZE)

            it_done = it + it_total - 1
            it = it_done + 1
            is_time_up = rank0_decides((time.perf_counter() - start_time) > time_limit, mesh)

            prev_offset = 0
            for ci in range(n_checks):
                offset = int(recs[ci, 0])
                adjusted = recs[ci, 1] > 0.5
                factor = float(recs[ci, 2])
                table = recs[ci, ADAPTIVE_REC_SIZE - 14 :].reshape(7, 2)
                check_it = it - it_total + offset - 1
                cadence.advance(offset - prev_offset - 1)
                prev_offset = offset
                cadence.tick(forced=adjusted)
                if adjusted and factor != 1.0:
                    logging.log(
                        LOG_LEVELS["scaling"],
                        f"Adjust sigma at iteration {check_it} with factor: {factor}",
                    )
                with trace.span("process_validation"):
                    process_validation(
                        table[:, 0], table[:, 1], check_it, adjusted, sigma_on_device=True
                    )
                if passed:
                    break

            maybe_snapshot(it_done)
            if passed or is_time_up:
                break
            continue

        # ---- step-by-step path: one iteration + validation per segment -----
        with trace.timed("segment", it=it) as seg:
            state, kkt_dev = run_chunk_kkt(config, data, state, k)
            table = _host(kkt_dev)
        run_history.add_step_time(STEP_TAG, seg.seconds)
        it_done = stop_after
        it = stop_after + 1

        is_time_up = rank0_decides((time.perf_counter() - start_time) > time_limit, mesh)
        whether_adjust = sched.is_to_adjust(it_done) or is_time_up
        cadence.advance(k - 1)
        cadence.tick(forced=True)
        with trace.span("process_validation"):
            process_validation(table[:, 0], table[:, 1], it_done, whether_adjust)
        maybe_snapshot(it_done)
        if passed or is_time_up:
            break

    # --- final validation + recovery ---------------------------------------
    # The phase `finish`: `final_kkt` to run_history.end(), then `recover`
    # to the public call's return (the decorators' translation included).
    trace.phase("finish", "final_kkt")
    counter_main = it_done if it_done >= 0 else -1
    maybe_snapshot(counter_main, force=True)
    graphs.release()  # this solve's static buffers and CUDA graphs

    org, scaled = fetch_kkt(state)
    cost, lagrangian = map(float, objective_functional(config, data, state))
    run_history.record(
        current_it=max(counter_main, 0),
        kkt_errors=org,
        history={"Transportation cost": cost, "Objective value": lagrangian},
    )
    trace.note(iterations=max(counter_main, 0) + 1)
    trace.phase("finish", "recover")
    run_history.end()

    if sharded:
        state = gather_state(mesh, state)  # every shard, on every rank
    with trace.span("recover_solution"):
        solution = _recover_solution(state, checkpoint_solutions, vertex_slot, triangle_slot)

    congestion_norm = float(
        np.linalg.norm(
            np.asarray(solution["lambda_c"])
            - float(state.congestion) * np.asarray(solution["mu"])
        )
    )
    logging.log(
        LOG_LEVELS["info"],
        "---- Overview of solution ".ljust(42, "-") + "\n"
        f"Congestion norm: {congestion_norm:.2f}\n"
        f"Number of iterations: {counter_main}\n"
        f"Iteration time: {run_history.running_time:.2f}",
    )
    return solution, run_history


def _next_pre_event(it, is_constant_scaling, is_z_scaling, sched) -> int:
    """Smallest iteration > it at which a pre-iteration event could fire."""
    candidates = [2**62]
    if is_constant_scaling:
        for target in (10, 50):
            if target > it:
                candidates.append(target)
        nxt = ((it - 50) // 100 + 1) * 100 + 50
        if nxt > it:
            candidates.append(nxt)
    if is_z_scaling and sched.z_scale_count < 1 and it < 100:
        # The z-rescale can fire at any iteration >= 100 once the recorded
        # KKT drops below 5e-3; crossing iteration 100 is the boundary.
        candidates.append(100)
    return int(min(candidates))


def _initial_constant_scaling(config, data, state, n_time):
    """is_constant_scaling startup rescale."""
    nst, nsc, nss, _ = _norms(config, data)
    bt = state.r * state.boundary / data.ops.av[None, :]
    grad_x = grad_space(data.ops, bt, **config.spmd_kwargs(data))
    norms = torch.stack(
        [torch.sqrt(nsc(bt)), torch.sqrt(nst(grad_time(config.stepsize_time, bt, data.mesh)) + nss(grad_x))]
    )
    norm_c, norm_ac = map(float, from_rank0(norms, data.mesh))  # one decision on every rank
    dual_init = sqrt(n_time) * norm_c**2 / norm_ac
    prim_init = float(state.norm_constant_d)
    if max(prim_init, dual_init) / min(prim_init, dual_init) > 2.0:
        logging.log(
            LOG_LEVELS["scaling"],
            f"Var Norm at initial scaling with (prim, dual) factor: "
            f"{1.0/prim_init}, {1.0/dual_init}",
        )
        state = apply_prim_dual_scale(state, prim_init, dual_init)
    return apply_penalty_factor(state, 1.0 / float(state.r))


def _pad_init_solution(init_solution: dict, config, extras) -> dict:
    """Place a real-sized warm-start solution into the padded layout;
    already-padded arrays pass through."""
    if not init_solution:
        return init_solution
    v_pad, f_pad = config.n_vertices, config.n_triangles

    def place(arr, axis, target, slot):
        arr = np.asarray(arr)
        if arr.shape[axis] == target:
            return arr
        if arr.shape[axis] != slot.shape[0]:
            raise ValueError(
                f"warm-start axis {axis} has size {arr.shape[axis]}; expected "
                f"{slot.shape[0]} (real) or {target} (padded)"
            )
        out = np.zeros(arr.shape[:axis] + (target,) + arr.shape[axis + 1 :], dtype=arr.dtype)
        idx = [slice(None)] * arr.ndim
        idx[axis] = slot
        out[tuple(idx)] = arr
        return out

    v_slot, f_slot = extras["vertex_slot"], extras["triangle_slot"]
    v_keys = ("phi", "A", "lambda_c", "z_fst", "z_end", "mu", "beta_fst", "beta_end")
    f_keys = {"B": 1, "E": 1, "z_mid": 2, "beta_mid": 2}
    out = dict(init_solution)
    for key in v_keys:
        if out.get(key) is not None:
            out[key] = place(out[key], 1, v_pad, v_slot)
    for key, axis in f_keys.items():
        if out.get(key) is not None:
            out[key] = place(out[key], axis, f_pad, f_slot)
    return out


def _recover_solution(state, checkpoint_solutions, vertex_slot, triangle_slot) -> SolutionSocpData:
    """Undo the prim/dual/z/r scalings and gather the padded arrays back to
    the real mesh ordering (host numpy)."""
    ps = float(state.prim_scale)
    ds = float(state.dual_scale)
    sz = float(state.scale_z)
    r = float(state.r)
    v, f = vertex_slot, triangle_slot
    return SolutionSocpData(
        phi=ps * _host(state.phi)[:, v],
        A=ps * _host(state.A)[:, v],
        B=ps * _host(state.B)[:, f],
        lambda_c=ps * _host(state.lambda_c)[:, v],
        z_fst=(ps / sz) * _host(state.z_fst)[:, v],
        z_mid=(ps / sz) * _host(state.z_mid)[:, :, f],
        z_end=(ps / sz) * _host(state.z_end)[:, v],
        mu=(r * ds) * _host(state.mu)[:, v],
        E=(r * ds) * _host(state.E)[:, f],
        beta_fst=(r * sz * ds) * _host(state.beta_fst)[:, v],
        beta_mid=(r * sz * ds) * _host(state.beta_mid)[:, :, f],
        beta_end=(r * sz * ds) * _host(state.beta_end)[:, v],
        checkpoints=checkpoint_solutions if checkpoint_solutions else None,
    )
