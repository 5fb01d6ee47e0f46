"""Command-line interface of the port.

The reference's flags (`dots_socp_tpu.cli.parse_args`) plus `--device`; the
solve goes through the reference's `interface.run_dot_surface` with the
port's solver. Run as

    python -m dots_socp_torch.cli --example plane --n_space 200 --ntime 31 \
        --tol 1e-4 --precision float32 --device cuda

Flags routed to JAX by the interface (--mesh_shape, --profile_dir, the
distributed flags) and --snapshot are not ported yet (ROADMAP.md) and are
rejected.
"""

from __future__ import annotations

from dots_socp_tpu.cli import parse_args

_UNPORTED = (
    ("mesh_shape", "--mesh_shape"),
    ("profile_dir", "--profile_dir"),
    ("coordinator_address", "--coordinator_address"),
    ("num_processes", "--num_processes"),
    ("process_id", "--process_id"),
    ("snapshot_path", "--snapshot"),
)


def build_parser():
    parser = parse_args(return_parser=True)
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device of the solve (default cuda; cpu runs the plain "
        "PyTorch versions of the kernels). Asking for cuda without it fails",
    )
    return parser


def device_solver(device):
    """The port's `solver` bound to `device`, under a name for the logs."""
    from dots_socp_torch.solver import solver

    def solver_on_device(n_time, geometry, **kwargs):
        return solver(n_time, geometry, device=device, **kwargs)

    solver_on_device.__name__ = "dot_solver_socp_torch"
    return solver_on_device


def load_geometry(example, n_space=None):
    """The geometry the solver receives for a built-in example at
    resolution `n_space`: loaded and normalized as `main` does it."""
    from dots_socp_tpu.data.loader import load_example
    from dots_socp_tpu.geometry.normalize import normalize_geometry

    _, geometry, _ = load_example(example, kwargs_generating_mesh={"n": n_space})
    return normalize_geometry(geometry)[0]


def main(argv=None):
    """Parse `argv` (default: sys.argv), solve, evaluate; returns what the
    interface returns: (solution, geometry, run_history), plus the errors
    with --versus_exact."""
    from dots_socp_tpu.interface import (
        print_example_info,
        run_dot_surface,
        run_dot_surface_versus_exact,
        set_logging_level,
    )

    parser = build_parser()
    args = parser.parse_args(argv)
    for attr, flag in _UNPORTED:
        if getattr(args, attr, None) is not None:
            parser.error(f"{flag} is not ported to dots_socp_torch yet (see ROADMAP.md)")
    set_logging_level(log_level=args.log_level, log_file=args.log_file)
    print_example_info(args, additional_fields=["device"])

    solver = device_solver(args.device)
    if args.versus_exact:
        return run_dot_surface_versus_exact(opts=args, solver=solver)
    return run_dot_surface(opts=args, solver=solver)


if __name__ == "__main__":
    main()
