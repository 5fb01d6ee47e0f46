"""Command-line interface of the port.

The flags of the JAX package's CLI (`parse_args` is the port's own copy of
`dots_socp_tpu/cli.py::parse_args`) plus `--device` and `--dist_backend`;
the solve goes through the port's `interface.run_dot_surface` with the
port's solver. Run as

    python -m dots_socp_torch.cli --example plane --n_space 200 --ntime 31 \
        --tol 1e-4 --precision float32 --device cuda

A sharded solve runs one process per (time, space) shard under torchrun:

    torchrun --nproc_per_node 2 -m dots_socp_torch.cli --example plane \
        --n_space 200 --ntime 31 --mesh_shape 1x2 --dist_backend nccl
    torchrun --nproc_per_node 4 -m dots_socp_torch.cli --example plane \
        --n_space 200 --ntime 32 --mesh_shape 2x2 --dist_backend nccl

(`gloo` shares one card between the ranks; `nccl` needs one card per
rank; --ntime must be a multiple of the time axis). `--num_processes`,
`--process_id` and `--coordinator_address` replace torchrun's environment;
under SLURM's srun or Open MPI's mpirun the rank and world size come from
theirs (`parallel.distributed.cluster_environment`). --mesh_shape and the
distributed flags are handled here, before `run_dot_surface`: the mesh is
bound into the solver the interface calls. On a mesh only world rank 0
logs, saves and traces (--profile_dir).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import logging

import torch.distributed as dist
from numpy import inf as np_inf

_DIST_FLAGS = ("coordinator_address", "num_processes", "process_id")


class CheckArgsRangeTau(argparse.Action):
    def __call__(self, arg_parser, namespace, values, option_string=None):
        if not (0.0 < float(values) < 2.0):
            raise argparse.ArgumentError(
                self, f"tau must be in range (0.0, 2.0), but got {values}"
            )
        setattr(namespace, self.dest, values)


class CheckArgsPowerPerceptual(argparse.Action):
    def __call__(self, arg_parser, namespace, values, option_string=None):
        if not float(values) > 0.0:
            raise argparse.ArgumentError(
                self, f"power_perceptual must be > 0.0, but got {values}"
            )
        setattr(namespace, self.dest, values)


def parse_args(parser=None, return_parser=False):
    """Build (and optionally return) the argument parser."""
    if parser is None:
        parser = argparse.ArgumentParser(
            description="Solve dynamic optimal transport on a triangulated surface and animate the transported density."
        )

    example_group = parser.add_argument_group(
        "Example configuration",
        "Pick a built-in problem with --example, or supply your own mesh and "
        "density settings with --mesh_file/--setting_file.",
    )
    example_group.add_argument(
        "--example",
        default=None,
        type=str,
        help="Name of a built-in problem (plane, airplane, armadillo, hand, "
        "bunny, sphere, ring, punctured_ball, knots_3, knots_5, hills, "
        "robot, eight, face, audi, square_regular, and their refined_* "
        "variants)",
    )
    example_group.add_argument(
        "--mesh_file", default=None, type=str, help="Path to a surface mesh in .off format"
    )
    example_group.add_argument(
        "--setting_file", default=None, type=str, help="Path to a density-settings module (.py defining get_mu)"
    )
    example_group.add_argument(
        "--congestion", default=0.0, type=float, help="Congestion penalty weight; 0 disables the congestion term"
    )
    example_group.add_argument(
        "--ntime", default=31, type=int, help="Number of time steps on the staggered grid"
    )

    algo_group = parser.add_argument_group("Algorithm parameters")
    algo_group.add_argument(
        "--tau",
        type=float,
        default=None,
        action=CheckArgsRangeTau,
        help="Over-relaxation step size for the multiplier ascent, in (0, 2)",
    )
    algo_group.add_argument("--nit", default=10**3, type=int, help="Iteration cap for the iALM loop")
    algo_group.add_argument(
        "--eps",
        default=0.0,
        type=float,
        help="Proximal regularization added to the phi-step Laplacian",
    )
    algo_group.add_argument(
        "--tol", default=10 ** (-3), type=float, help="Relative KKT error at which the solve stops"
    )
    algo_group.add_argument(
        "--time_limit",
        default=np_inf,
        type=float,
        help="Abort after this many seconds, returning the best iterate",
    )
    algo_group.add_argument(
        "--precision",
        default=None,
        choices=["float32", "float64"],
        help="Solver dtype (default: float32)",
    )
    algo_group.add_argument(
        "--laplacian_mode",
        default=None,
        choices=["auto", "spectral", "cg"],
        help="Space-time Laplacian solver: dense spectral factor or "
        "matrix-free CG (default: auto by mesh size)",
    )
    algo_group.add_argument(
        "--phi_refine",
        default="auto",
        choices=["auto", "on", "off"],
        help="Mixed-precision phi: f64 state.phi + f64 iterative refinement "
        "around the f32 inner CG (auto: on for the unsharded float32 CG "
        "path, where the f32 true-residual floor blocks tight tolerances)",
    )

    output_group = parser.add_argument_group("Output options")
    output_group.add_argument(
        "--show", default=False, action="store_true", help="Open an interactive window with the density animation"
    )
    output_group.add_argument(
        "--save", default=False, action="store_true", help="Write the density animation to the output directory"
    )
    output_group.add_argument(
        "--cmap", default=None, type=str, help="Colormap name used when rendering the density"
    )
    output_group.add_argument(
        "--power_perceptual",
        default=1.0,
        type=float,
        action=CheckArgsPowerPerceptual,
        help="Exponent applied to densities before coloring (1.0 = linear)",
    )
    output_group.add_argument(
        "--detail_runhist",
        default=False,
        action="store_true",
        help="Validate KKT and record the objective every iteration (slow)",
    )
    output_group.add_argument(
        "--show_kkt_it",
        "--show_kkt",
        default=False,
        action="store_true",
        help="Plot the KKT residuals against the iteration count",
    )
    output_group.add_argument(
        "--save_kkt_it",
        "--save_kkt",
        default=False,
        action="store_true",
        help="Write the KKT-vs-iteration plot to the output directory",
    )
    output_group.add_argument(
        "--show_kkt_time",
        default=False,
        action="store_true",
        help="Plot the KKT residuals against wall-clock time",
    )
    output_group.add_argument(
        "--save_kkt_time",
        default=False,
        action="store_true",
        help="Write the KKT-vs-time plot to the output directory",
    )
    output_group.add_argument(
        "-o", "--outdir", default="output/undated", type=str, help="Directory for saved animations, plots and tables"
    )
    output_group.add_argument(
        "--log_file", default=None, type=str, help="Also tee the log to this file (log2table input)"
    )

    dist_group = parser.add_argument_group(
        "Distributed execution",
        "Place the solver on a ('time', 'space') mesh of one process per "
        "shard (torchrun, or the same command line per process plus "
        "--process_id).",
    )
    dist_group.add_argument(
        "--mesh_shape",
        default=None,
        type=str,
        help="Device mesh as TxS or a bare shard count S (= 1xS, pure "
        "spatial sharding); T > 1 also cuts the (T, ...) arrays into T blocks "
        "of time slices and needs --ntime to be a multiple of T; default: "
        "single device",
    )
    dist_group.add_argument(
        "--coordinator_address",
        default=None,
        type=str,
        help="host:port of process 0 for torch.distributed (replaces "
        "torchrun's MASTER_ADDR / MASTER_PORT)",
    )
    dist_group.add_argument(
        "--num_processes",
        default=None,
        type=int,
        help="Total process count of the multi-host run",
    )
    dist_group.add_argument(
        "--process_id",
        default=None,
        type=int,
        help="This process's rank in [0, num_processes)",
    )

    exp_group = parser.add_argument_group("Experimental features")
    exp_group.add_argument(
        "--log_level",
        type=str,
        choices=["debug", "kkt", "scaling", "info"],
        default="info",
        help="Verbosity: info < scaling < kkt < debug (each adds detail)",
    )
    exp_group.add_argument(
        "--versus_exact",
        default=False,
        action="store_true",
        help="After solving, measure errors against the closed-form transport "
        "(settings module must define get_exact_transportation)",
    )
    exp_group.add_argument(
        "--checkpoints",
        default=None,
        nargs="+",
        type=float,
        help="KKT levels at which intermediate solutions are snapshotted for "
        "the --versus_exact error table",
    )
    exp_group.add_argument(
        "--n_space",
        type=int,
        default=None,
        help="Resolution parameter n for procedurally generated meshes "
        "(e.g. the plane example)",
    )
    exp_group.add_argument(
        "--sigma_freeze_error",
        type=float,
        default=None,
        help="Freeze sigma adjustments (sticky) once the KKT stop error "
        "first drops below this level; breaks the sigma limit cycle on "
        "large meshes (try 20*tol). Default: never freeze",
    )
    exp_group.add_argument(
        "--snapshot",
        dest="snapshot_path",
        type=str,
        default=None,
        help="Path to a .npz state snapshot: written periodically during the "
        "solve, and resumed from if it already exists",
    )
    exp_group.add_argument(
        "--snapshot_every",
        type=float,
        default=300.0,
        help="Seconds between periodic snapshots (with --snapshot)",
    )
    exp_group.add_argument(
        "--profile_dir",
        type=str,
        default=None,
        help="Capture a torch.profiler trace (Chrome trace, CPU and CUDA "
        "activities) of the solve into this directory; it covers the set-up "
        "and the first 10 iterations only, which bounds its size",
    )
    exp_group.add_argument(
        "--pad_multiple",
        type=int,
        default=None,
        help="Pad vertex/triangle counts to this multiple (default 1: no "
        "padding; a snapshot resumes only under the padding it was written with)",
    )
    exp_group.add_argument(
        "--max_dense_vertices",
        type=int,
        default=None,
        help="Largest padded vertex count solved with the dense spectral "
        "factor; larger problems take the matrix-free CG path",
    )

    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device of the solve (default cuda; cpu runs the plain "
        "PyTorch versions of the kernels). Asking for cuda without it fails",
    )
    parser.add_argument(
        "--dist_backend",
        choices=("nccl", "gloo"),
        default=None,
        help="torch.distributed backend of a --mesh_shape TxS solve (T * S > 1): "
        "nccl (one card per rank) or gloo (the ranks may share one card)",
    )

    if return_parser:
        return parser
    return parser.parse_args()


def device_solver(device, mesh=None):
    """The port's `solver` bound to `device` (and `mesh`), under a name
    for the logs."""
    from dots_socp_torch.solver import solver

    def solver_on_device(n_time, geometry, **kwargs):
        return solver(n_time, geometry, device=device, mesh=mesh, **kwargs)

    solver_on_device.__name__ = "dot_solver_socp_torch"
    return solver_on_device


def load_geometry(example, n_space=None):
    """The geometry the solver receives for a built-in example at
    resolution `n_space`: loaded and normalized as `main` does it."""
    from dots_socp_torch.data.loader import load_example
    from dots_socp_torch.geometry.normalize import normalize_geometry

    _, geometry, _ = load_example(example, kwargs_generating_mesh={"n": n_space})
    return normalize_geometry(geometry)[0]


def _solver_mesh(parser, args):
    """The SolverMesh of --mesh_shape (bringing up torch.distributed), or
    None for a single-device solve. Bad combinations exit via the parser."""
    from dots_socp_torch.parallel import distributed as pd

    dist_flags = [f"--{k}" for k in _DIST_FLAGS if getattr(args, k, None) is not None]
    if args.mesh_shape is None:
        if dist_flags or args.dist_backend is not None:
            parser.error(f"{' '.join(dist_flags) or '--dist_backend'} needs --mesh_shape TxS")
        return None
    try:
        time_axis, space_axis = pd.parse_mesh_shape(args.mesh_shape)
    except ValueError as err:
        parser.error(str(err))
    n_shards = time_axis * space_axis
    if n_shards == 1:
        return None
    if args.dist_backend is None:
        parser.error(f"--mesh_shape {args.mesh_shape} needs --dist_backend nccl|gloo")
    up = pd.initialize_distributed(
        args.dist_backend,
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    if not up:
        parser.error(
            f"--mesh_shape {time_axis}x{space_axis} runs {n_shards} processes: launch under "
            f"torchrun --nproc_per_node {n_shards} (or srun / mpirun), or pass "
            "--num_processes, --process_id and --coordinator_address"
        )
    mesh = pd.make_solver_mesh((time_axis, space_axis), device=args.device)
    print(
        f"mesh {time_axis}x{space_axis}: torch.distributed backend {mesh.backend}, "
        f"rank {mesh.world_rank} on {mesh.device}",
        flush=True,
    )
    return mesh


def main(argv=None):
    """Parse `argv` (default: sys.argv), solve, evaluate; returns what the
    interface returns: (solution, geometry, run_history), plus the errors
    with --versus_exact. On a mesh every rank returns the whole solution;
    only rank 0 logs."""
    parser = parse_args(return_parser=True)
    return run(parser, parser.parse_args(argv))


def run(parser, args, solver_name=None):
    """The solve of parsed `args` (`parser` reports bad combinations): the
    mesh of --mesh_shape brought up and bound into the port's solver on
    --device, the log set up, then the interface's `run_dot_surface` (or its
    versus-exact flow). The entry points that re-default the parser (the
    replication scripts, the demo) come through here."""
    from dots_socp_torch.interface import (
        print_example_info,
        run_dot_surface,
        run_dot_surface_versus_exact,
        set_logging_level,
    )

    group_was_up = dist.is_initialized()
    mesh = _solver_mesh(parser, args)
    # The mesh above carries these; the interface takes none of them.
    for attr in ("mesh_shape",) + _DIST_FLAGS:
        setattr(args, attr, None)
    quiet = contextlib.ExitStack()
    if mesh is not None and mesh.world_rank != 0:
        # Rank 0 logs, prints, saves and traces; the others only solve.
        for attr in vars(args):
            if attr.startswith(("save", "show")) and getattr(args, attr) is True:
                setattr(args, attr, False)
        args.log_file = args.profile_dir = None
        quiet.enter_context(contextlib.redirect_stdout(io.StringIO()))
    try:
        with quiet:
            set_logging_level(log_level=args.log_level, log_file=args.log_file)
            if mesh is not None and mesh.world_rank != 0:
                logging.getLogger().setLevel(logging.WARNING)
            print_example_info(args, additional_fields=["device", "dist_backend"])
            solver = device_solver(args.device, mesh)
            flow = run_dot_surface_versus_exact if args.versus_exact else run_dot_surface
            return flow(opts=args, solver=solver, solver_name=solver_name)
    finally:
        if mesh is not None and not group_was_up:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
