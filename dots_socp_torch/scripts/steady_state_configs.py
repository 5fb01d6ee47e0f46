"""Steady-state wall clock of the protocol configs 2 and 3 on the port
(counterpart of the repository's `scripts/steady_state_configs.py`).

    python -m dots_socp_torch.scripts.steady_state_configs [--configs 2 3] [--device cpu]

Each config is the port's CLI (`dots_socp_torch.cli`: its parser, then
`interface.run_dot_surface` with the solver bound to --device) run twice in
one process: a 2-iteration solve of the same shape first absorbs what a
first solve pays once (the kernel build, the CUDA context, the factor
caches; the port compiles nothing per shape), then the measured solve
(host clock, closed by a device synchronisation). The JAX script's
`warmup_incl_compile_sec` is `warmup_sec` here. One JSON line per config,
then one with all of them.
"""

import argparse
import sys
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

CONFIGS = {
    # Protocol config 2: the congestion proximal term exercised.
    "2": ["--example=plane", "--n_space=64", "--ntime=31",
          "--congestion=0.05", "--tol=1e-4", "--nit=10000",
          "--time_limit=1200"],
    # Protocol config 3: the high-resolution time grid.
    "3": ["--example=plane", "--n_space=50", "--ntime=127",
          "--tol=1e-4", "--nit=10000", "--time_limit=1200"],
    # The whole measurement path in seconds, on either device.
    "smoke": ["--example=plane", "--n_space=12", "--ntime=4",
              "--congestion=0.05", "--tol=1e-2", "--nit=50",
              "--time_limit=60"],
}


def run_config(parser, argv, device, warmup_nit=2):
    """(result, run history) of one config: warm-up, then the measured solve."""
    import numpy as np

    from dots_socp_torch import cli
    from dots_socp_torch.scripts.common import timed

    argv = [*argv, f"--device={device}"]
    warm = parser.parse_args(argv)
    warm.nit = warmup_nit
    _, warmup = timed(lambda: cli.run(parser, warm), device)
    opts = parser.parse_args(argv)
    (_, _, history), wall = timed(lambda: cli.run(parser, opts), device)
    recorded = np.asarray(history.kkt_iteration)
    recorded = recorded[np.isfinite(recorded)]
    iterations = int(recorded[-1]) if recorded.size else 0
    errors = np.asarray(history.get_current_kkt_errors(), dtype=float)
    return {
        "argv": " ".join(argv),
        "warmup_sec": warmup,
        "solve_sec": wall,
        "iterations": iterations,
        "iters_per_sec": iterations / wall,
        "converged": bool(np.all(errors < opts.tol)),
    }, history


def main(argv=None):
    from dots_socp_torch.scripts.common import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=["2", "3"], choices=sorted(CONFIGS))
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from dots_socp_torch import cli
    from dots_socp_torch.ops import resolve_device
    from dots_socp_torch.scripts.common import device_fields, print_result

    device = str(resolve_device(args.device))
    parser = cli.parse_args(return_parser=True)
    results = {}
    for key in args.configs:
        results[f"config_{key}"], _ = run_config(parser, CONFIGS[key], device)
        print_result({f"config_{key}": results[f"config_{key}"]})
    return print_result({**results, **device_fields(device)})


if __name__ == "__main__":
    main()
