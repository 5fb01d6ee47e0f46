# The port's own copy of dots_socp_tpu/interface.py, without the branch that
# routes meshes and distributed start-up to JAX; the profiler trace is
# torch.profiler's, and the default solver is the port's.
"""Top-level interface: configure, solve, evaluate, visualize.

Parity with reference `interface.py:25-480`: the same pluggable-solver
contract (`solver(n_time, geometry, **kw) -> (solution_with_mu, history)`),
opts validation, cost de-scaling, invariant checks, history reports,
visualization orchestration, and the versus-exact flow.
"""

from __future__ import annotations

import contextlib
import logging
from argparse import Namespace as argparse_namespace
from pathlib import Path

import numpy as np

from dots_socp_torch.config import LOG_LEVELS
from dots_socp_torch.data.loader import load_example
from dots_socp_torch.geometry.normalize import normalize_geometry
from dots_socp_torch.utils.evaluate import (
    check_mass_conservation,
    check_negative_mass,
)


def print_example_info(opts, fields=None, additional_fields=None):
    """Log the experiment configuration block (parsed downstream by
    log2table: the block header and 'Example name:' style lines matter)."""
    assert isinstance(opts, argparse_namespace), "opts must be a Namespace"
    if fields is None:
        fields = [
            "example",
            "mesh_file",
            "setting_file",
            "congestion",
            "ntime",
            "tol",
            "tau",
            "eps",
            "nit",
            "power_perceptual",
        ]
        if getattr(opts, "save", False):
            fields.append("outdir")
    if additional_fields:
        fields = fields + list(additional_fields)

    lines = [
        f"{param}: {getattr(opts, param)}"
        for param in fields
        if getattr(opts, param, None) is not None
    ]
    logging.log(LOG_LEVELS["info"], "")
    logging.log(
        LOG_LEVELS["info"],
        "---- Info: Experiment Setting ".ljust(42, "-") + "\n" + "\n".join(lines),
    )


def set_logging_level(log_level, log_file=None):
    """Select the log level (debug/kkt/scaling/info) and optional tee file."""
    level = LOG_LEVELS.get(log_level, LOG_LEVELS["info"])
    handlers = [logging.StreamHandler()]
    if log_file is not None:
        handlers.append(logging.FileHandler(log_file))
        fmt = "%(asctime)s %(message)s"
    else:
        fmt = "%(message)s"
    logging.basicConfig(level=level, format=fmt, handlers=handlers, force=True)


#: Iterations of the solve that a --profile_dir trace covers. An iteration
#: of the large-mesh CG path is more than a thousand kernel launches, so a
#: whole solve would be millions of events; the trace stops after these.
PROFILE_ITERATIONS = 10


@contextlib.contextmanager
def profiler_trace(profile_dir, iterations=PROFILE_ITERATIONS):
    """Trace what runs inside with torch.profiler (CPU activities and, with a
    card, CUDA ones) from entry until `iterations` solver iterations have
    run, and write a Chrome trace (chrome://tracing, Perfetto) to
    `profile_dir`/solve_trace.json. The program's spans (`utils.trace`) are
    ranges of the trace for the same extent: its phases over its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dots_socp_torch.solver import step
    from dots_socp_torch.utils import trace

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    out = Path(profile_dir) / "solve_trace.json"
    prof = profile(activities=activities)
    left = iterations

    def finish():
        nonlocal left
        if left is None:
            return
        left = None
        step.AFTER_ITERATION = None
        trace.disable()
        prof.stop()
        prof.export_chrome_trace(str(out))
        logging.log(LOG_LEVELS["info"], f"Profiler trace: {out}")

    def after_iteration():
        nonlocal left
        left -= 1
        if left <= 0:
            finish()

    prof.start()
    trace.enable(annotate=True)
    step.AFTER_ITERATION = after_iteration
    try:
        yield out
    finally:
        finish()


def _validate_opts(opts):
    if not hasattr(opts, "ntime") or opts.ntime <= 0:
        raise ValueError("'ntime' must be a positive integer")
    if not hasattr(opts, "example") and not (
        hasattr(opts, "mesh_file") and hasattr(opts, "setting_file")
    ):
        raise ValueError(
            "either 'example' or both 'mesh_file' and 'setting_file' required"
        )
    checks = [
        ("tau", lambda v: 0 < v <= 2, "'tau' must be in (0, 2]"),
        ("tol", lambda v: v > 0, "'tol' must be positive"),
        ("congestion", lambda v: v >= 0, "'congestion' must be non-negative"),
        ("nit", lambda v: v > 0, "'nit' must be positive"),
        ("time_limit", lambda v: v > 0, "'time_limit' must be positive"),
        ("power_perceptual", lambda v: v > 0, "'power_perceptual' must be positive"),
        ("eps", lambda v: v >= 0, "'eps' must be non-negative"),
    ]
    for name, ok, msg in checks:
        val = getattr(opts, name, None)
        if val is not None and not ok(val):
            raise ValueError(msg)
    cps = getattr(opts, "checkpoints", None)
    if cps is not None and (
        not isinstance(cps, list) or not all(0 < c <= 1 for c in cps)
    ):
        raise ValueError("'checkpoints' must be a list of floats in (0, 1]")
    outdir = getattr(opts, "outdir", None)
    if outdir is not None and not isinstance(outdir, str):
        raise ValueError("'outdir' must be a string")


# opts attribute -> solver kwarg (reference `interface.py:275-284`).
_KEY_MAPPING = {
    "eps": "eps",
    "tau": "tau",
    "nit": "nit",
    "tol": "tol",
    "congestion": "congestion",
    "checkpoints": "tol_checkpoints",
    "time_limit": "time_limit",
    "detail_runhist": "check_kkt_step_by_step",
    "precision": "precision",
    "laplacian_mode": "laplacian_mode",
    "snapshot_path": "snapshot_path",
    "snapshot_every": "snapshot_every",
    # Shape controls of the problem assembly.
    "pad_multiple": "pad_multiple",
    "max_dense_vertices": "max_dense_vertices",
    "sigma_freeze_error": "sigma_freeze_error",
    "phi_refine": "phi_refine",
}


def run_dot_surface(opts, solver=None, solver_name=None):
    """Load an example, solve DOT on it, evaluate and visualize.

    Returns (solution, geometry, run_history)."""
    if solver is None:
        from dots_socp_torch.solver import solver as default_solver

        solver = default_solver
    if not callable(solver):
        raise TypeError("solver must be a callable")
    _validate_opts(opts)

    n_time = opts.ntime
    is_show = getattr(opts, "show", False)
    is_save = getattr(opts, "save", False)
    algo_name = solver_name if solver_name else solver.__name__

    example_name, geometry, camera_config = load_example(
        example_name=getattr(opts, "example", None),
        path_to_mesh_file=getattr(opts, "mesh_file", None),
        path_to_setting_file=getattr(opts, "setting_file", None),
        kwargs_generating_mesh={"n": getattr(opts, "n_space", None)},
    )

    outdir = Path(getattr(opts, "outdir", "output") or "output")

    logging.log(
        LOG_LEVELS["info"],
        "---- Discretization ".ljust(42, "-") + "\n"
        f"Example name: {example_name}\n"
        f"Number of points in time: {n_time}\n"
        f"Number of vertices: {geometry['vertices'].shape[0]}\n"
        f"Number of triangles: {geometry['triangles'].shape[0]}\n"
        f"Area of the vertices: {np.sum(geometry['area_vertices'] / 3.0)}\n"
        f"Area of the triangles: {np.sum(geometry['area_triangles'])}",
    )

    if is_save:
        anim_dir = outdir / "animation" / example_name
        anim_dir.mkdir(parents=True, exist_ok=True)
        animation_filename = str(anim_dir / f"{example_name}_{algo_name}.mp4")
        animation_picture_filename = str(
            anim_dir / (example_name + "_" + algo_name + "_{time_frame_number}.png")
        )
        example_picture_filename = str(
            anim_dir / (example_name + "_{description}.png")
        )
    else:
        animation_filename = animation_picture_filename = None
        example_picture_filename = None

    kkt_filenames = {}
    for which in ("kkt_it", "kkt_time"):
        if getattr(opts, f"save_{which}", False):
            kkt_dir = outdir / "running_history"
            kkt_dir.mkdir(parents=True, exist_ok=True)
            kkt_filenames[which] = str(
                kkt_dir / f"{example_name}_{algo_name}_{which}.png"
            )
        else:
            kkt_filenames[which] = None

    # ---- solve --------------------------------------------------------------
    optional_args = {}
    for opts_key, solver_key in _KEY_MAPPING.items():
        value = getattr(opts, opts_key, None)
        if value is not None:
            optional_args[solver_key] = value

    # A device mesh (--mesh_shape, torch.distributed) and the device are the
    # caller's: `dots_socp_torch.cli.main` binds them into `solver` before
    # this call.
    for key in ("mesh_shape", "coordinator_address", "num_processes", "process_id"):
        if getattr(opts, key, None) is not None:
            raise ValueError(
                f"run_dot_surface does not take opts.{key}: bind the mesh into "
                "the solver (see dots_socp_torch.cli.main)"
            )

    normalized_geometry, scale_factor = normalize_geometry(geometry)
    profile_dir = getattr(opts, "profile_dir", None)
    # Device trace of the solve's first iterations (set-up, launches, kernels).
    with profiler_trace(profile_dir) if profile_dir else contextlib.nullcontext():
        solution, run_history = solver(n_time, normalized_geometry, **optional_args)

    if not isinstance(solution, dict) or "mu" not in solution:
        raise ValueError("solver must return a dict containing 'mu'")

    # De-scale cost values to the original geometry units.
    area_descale = 1.0 / scale_factor**2
    for key in ("Transportation cost", "Objective value"):
        if key in run_history.history:
            run_history.history[key] = area_descale * run_history.history[key]

    # ---- evaluate -----------------------------------------------------------
    check_mass_conservation(solution["mu"], verbose=True)
    check_negative_mass(solution["mu"], verbose=True)

    # ---- history reports ----------------------------------------------------
    from dots_socp_torch.utils.history import RunningHistory

    if isinstance(run_history, RunningHistory):
        run_history.print_end_history()
        run_history.print_steps_time()
        fig_title = f"{algo_name} solves example '{example_name}'"
        for which, x_axis in (("kkt_it", "iteration"), ("kkt_time", "time")):
            if getattr(opts, f"show_{which}", False) or kkt_filenames[which]:
                run_history.show_kkt_errors(
                    filename=kkt_filenames[which],
                    is_show_when_save=getattr(opts, f"show_{which}", False),
                    title=fig_title,
                    x_axis=x_axis,
                )

    # ---- visualization ------------------------------------------------------
    if not any([is_save, is_show]):
        return solution, geometry, run_history

    from dots_socp_torch.utils.show import (
        create_pv_mesh,
        decorator_factory_power_perceptual,
        normalize_density_to_plot,
        save_animation,
        save_description_of_dot,
        save_results_of_dot,
        show_animation,
    )

    try:
        mesh = create_pv_mesh(geometry["vertices"], geometry["triangles"])
    except ImportError as exc:
        logging.warning(f"Skipping visualization: {exc}")
        return solution, geometry, run_history

    cmap = getattr(opts, "cmap", None)
    power = getattr(opts, "power_perceptual", None)
    normalize = decorator_factory_power_perceptual(power=power)(
        normalize_density_to_plot
    )
    to_plot, to_plot_mu0, to_plot_mu1 = normalize(solution["mu"], geometry)

    if is_show:
        show_animation(
            mesh, to_plot, example_name, camera_config=camera_config, cmap=cmap
        )
    if is_save:
        save_description_of_dot(
            mesh,
            to_plot_mu0,
            to_plot_mu1,
            example_picture_filename,
            camera_config=camera_config,
            cmap=cmap,
        )
        save_results_of_dot(
            mesh,
            to_plot,
            animation_picture_filename,
            num_frames=7,
            camera_config=camera_config,
            cmap=cmap,
        )
        save_animation(
            mesh,
            to_plot,
            animation_filename,
            camera_config=camera_config,
            cmap=cmap,
        )

    return solution, geometry, run_history


def run_dot_surface_versus_exact(
    opts, solver=None, solver_name=None, type_time_grid: str = "center"
):
    """Solve and compare with the example's closed-form transport.

    Returns (solution, geometry, run_history, error_transportation,
    error_checkpoints)."""
    if type_time_grid not in ("center", "staggered"):
        raise ValueError("type_time_grid must be 'center' or 'staggered'")

    from dots_socp_torch.data.loader import load_exact_transportation
    from dots_socp_torch.utils.evaluate import compare_with_exact_transportation

    n_time = opts.ntime
    t_center = np.linspace(0.0, 1.0, n_time + 1)
    t_array = t_center if type_time_grid == "center" else 0.5 * (
        t_center[:-1] + t_center[1:]
    )

    _, exact = load_exact_transportation(
        t_array=t_array,
        example_name=getattr(opts, "example", None),
        path_to_mesh_file=getattr(opts, "mesh_file", None),
        path_to_setting_file=getattr(opts, "setting_file", None),
        kwargs_generating_mesh=(
            {"n": opts.n_space} if hasattr(opts, "n_space") else None
        ),
    )

    solution, geometry, run_history = run_dot_surface(
        opts=opts, solver=solver, solver_name=solver_name
    )

    error_transportation = compare_with_exact_transportation(
        mu=solution["mu"], mu_exact=exact, geometry=geometry, verbose=True
    )

    error_checkpoints = []
    if solution.get("checkpoints"):
        for checkpoint in solution["checkpoints"]:
            err = compare_with_exact_transportation(
                mu=checkpoint["mu"], mu_exact=exact, geometry=geometry, verbose=False
            )
            error_checkpoints.append(
                {
                    "error": err,
                    "kkt_error": max(
                        k for k in checkpoint["kkt"] if k is not None and k == k
                    ),
                    "iteration": checkpoint["iteration"],
                    "time": checkpoint["time"],
                }
            )
        from dots_socp_torch.utils.tables import export_table_from_checkpoints_error

        algo_name = solver_name if solver_name else solver.__name__ if solver else "socp"
        out_table = Path(
            getattr(opts, "outdir", "output") or "output"
        ) / f"error_versus_exact_{algo_name}.html"
        export_table_from_checkpoints_error(
            error_checkpoints=error_checkpoints, out=out_table
        )

    return solution, geometry, run_history, error_transportation, error_checkpoints
