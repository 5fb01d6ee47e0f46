"""solver_socp: the iALM orchestration loop (host side).

Counterpart of `dots_socp_tpu/solver/socp.py` for one device:
``solver_socp(n_time, geometry, device="cuda", **kw) -> (SolutionSocpData,
RunningHistory)`` with the reference's defaults, schedules and stopping
semantics. Iterations run in segments (`step.run_chunk_adaptive`) whose
packed records this loop replays into the run history, the cadence and the
sigma schedule, exactly as the reference's loop does.

Not ported yet (see ROADMAP.md): device meshes (`mesh`), crash-safe
snapshots (`snapshot_path`) and profiler traces (`profile_dir`); each raises
NotImplementedError.
"""

from __future__ import annotations

import logging
import time
from math import exp, sqrt

import numpy as np
import torch

from dots_socp_torch.ops.mesh_ops import grad_space
from dots_socp_torch.ops.time_stencils import decouple_space_adjoint, grad_time
from dots_socp_torch.solver.kkt import _norms, compute_kkt, objective_functional
from dots_socp_torch.solver.problem import build_problem
from dots_socp_torch.solver.scaling import (
    apply_penalty_factor,
    apply_prim_dual_scale,
    apply_z_scale,
    compute_var_norms,
)
from dots_socp_torch.solver.schedule import AdaptiveKKTCadence, SigmaSchedule
from dots_socp_torch.solver.state import init_state
from dots_socp_torch.solver.step import (
    ADAPTIVE_HEADER,
    ADAPTIVE_REC_SIZE,
    run_chunk,
    run_chunk_adaptive,
    run_chunk_kkt,
)
from dots_socp_tpu.config import LOG_LEVELS
from dots_socp_tpu.utils.history import RunningHistory
from dots_socp_tpu.utils.types import CheckpointDotData, GeometryData, SolutionSocpData

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
    profile_dir=None,
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
    mesh, snapshot_path, profile_dir : not ported yet; raise.
    `is_multi_threads` and `snapshot_every` are accepted for API parity.
    """
    for name, value in (
        ("mesh", mesh), ("snapshot_path", snapshot_path), ("profile_dir", profile_dir)
    ):
        if value is not None:
            raise NotImplementedError(
                f"dots_socp_torch: {name} is not ported yet (see ROADMAP.md)"
            )
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

    # --- problem assembly (host numpy/scipy, then one move to the device) ---
    t_setup = time.perf_counter()
    cg_rtol_adaptive = cg_rtol is None
    cg_rtol_floor = 1e-12 if precision == "float64" else 2e-6
    sigma_freeze = float(sigma_freeze_error) if sigma_freeze_error is not None else -np.inf
    sigma_frozen = False
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
        phi_refine=phi_refine,
        device=device,
    )
    device = data.ops.av.device
    if config.phi_refine:
        logging.log(
            LOG_LEVELS["kkt"],
            "Mixed-precision phi: f64 state.phi + f64 iterative refinement "
            "around the f32 inner CG",
        )
    logging.debug(
        "---- Laplace matrix ".ljust(42, "-")
        + f"\nFactorizing the Laplace matrix: {time.perf_counter() - t_setup:.2f}s."
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

    ops = data.ops
    state = init_state(
        n_time,
        config.n_vertices,
        config.n_triangles,
        extras["mu0_padded"],
        extras["mu1_padded"],
        dt,
        grad_time_fn=lambda p: grad_time(dt, p),
        grad_space_fn=lambda p: grad_space(ops, p),
        decouple_adjoint_fn=decouple_space_adjoint,
        init_solution=_pad_init_solution(init_solution or {}, config, extras),
        congestion=congestion,
        tau=tau,
        eps=eps,
        r=r,
        norm_constant_d=extras["norm_constant_d"],
        norm_boundary=norm_boundary,
        dtype=config.torch_dtype,
        phi_dtype=config.phi_dtype,
        device=device,
    )

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

    run_history.start()
    run_history.create_tol_progress(target_tol=tol)

    if is_z_scaling:
        logging.log(LOG_LEVELS["scaling"], "Initially scale z with z factor: 2.0")
        state = apply_z_scale(state, 2.0)
    if is_constant_scaling:
        state = _initial_constant_scaling(config, data, state, n_time)

    def fetch_kkt(state):
        t0 = time.perf_counter()
        table = _host(compute_kkt(config, data, state))
        run_history.add_step_time(KKT_TAG, time.perf_counter() - t0)
        return table[:, 0], table[:, 1]

    def snapshot_checkpoint(state, iteration, org):
        scale = float(state.r) * float(state.dual_scale)
        return CheckpointDotData(
            mu=scale * _host(state.mu)[:, vertex_slot],
            E=scale * _host(state.E)[:, triangle_slot],
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

    while it < nit:
        # ---- pre-iteration events at iteration `it` ------------------------
        if is_constant_scaling and SigmaSchedule.is_to_scale(it):
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
                state = apply_z_scale(state, rescale_z)

        def process_validation(org, scaled, check_it, whether_adjust, sigma_on_device=False):
            """Record one validated KKT table and run every host schedule
            that keys off it (cadence interval, progress, checkpoints,
            is_org_kkt switch, sigma update). sigma_on_device: the segment
            already applied the sigma update."""
            nonlocal passed, error, is_org_kkt, state, data, sigma_frozen
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
                        data = data._replace(
                            cg_op=data.cg_op._replace(
                                rtol=torch.tensor(
                                    new_rtol, dtype=config.torch_dtype, device=device
                                )
                            )
                        )

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
            t0 = time.perf_counter()
            state, packed = run_chunk_adaptive(
                config, data, state, it, k, cadence.iterations_until_next(), aux, max_chunk
            )
            run_history.add_step_time(STEP_TAG, time.perf_counter() - t0)

            n_checks = int(packed[0])
            it_total = int(packed[1])
            sched.last_adjust_it = int(packed[2])
            is_org_kkt = bool(packed[3] > 0.5)
            recs = packed[ADAPTIVE_HEADER:].reshape(max_chunk, ADAPTIVE_REC_SIZE)

            it_done = it + it_total - 1
            it = it_done + 1
            is_time_up = (time.perf_counter() - start_time) > time_limit

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
                process_validation(
                    table[:, 0], table[:, 1], check_it, adjusted, sigma_on_device=True
                )
                if passed:
                    break

            if passed or is_time_up:
                break
            continue

        # ---- step-by-step path: one iteration + validation per segment -----
        t0 = time.perf_counter()
        state, kkt_dev = run_chunk_kkt(config, data, state, k)
        table = _host(kkt_dev)
        run_history.add_step_time(STEP_TAG, time.perf_counter() - t0)
        it_done = stop_after
        it = stop_after + 1

        is_time_up = (time.perf_counter() - start_time) > time_limit
        whether_adjust = sched.is_to_adjust(it_done) or is_time_up
        cadence.advance(k - 1)
        cadence.tick(forced=True)
        process_validation(table[:, 0], table[:, 1], it_done, whether_adjust)
        if passed or is_time_up:
            break

    counter_main = it_done if it_done >= 0 else -1

    # --- final validation + recovery ---------------------------------------
    org, scaled = fetch_kkt(state)
    cost, lagrangian = map(float, objective_functional(config, data, state))
    run_history.record(
        current_it=max(counter_main, 0),
        kkt_errors=org,
        history={"Transportation cost": cost, "Objective value": lagrangian},
    )
    run_history.end()

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
    norm_c = float(torch.sqrt(nsc(bt)))
    norm_ac = float(
        torch.sqrt(nst(grad_time(config.stepsize_time, bt)) + nss(grad_space(data.ops, bt)))
    )
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
