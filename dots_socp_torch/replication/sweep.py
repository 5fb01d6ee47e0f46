"""In-process replication sweep on the port: every example x congestion
level (counterpart of `replication/sweep.py`).

The reference Makefile runs one Python process per (example, congestion)
pair (`Makefile:56-91`). This script runs them in one process:

  * brings up the device once (the CUDA context and the kernels' nvcc
    build) before the first logged run, so the tables' "Time [seconds]"
    column is pure solve time;
  * appends the standard log blocks per run (same format `log2table`
    parses) plus a `Converged: yes|time-capped` annotation line, surfaced
    as a "Converged" table column;
  * emits the per-congestion comparison tables the reference's
    `make main` produces.

PyTorch runs eagerly, so the shared shape buckets of the JAX version, its ordering
by bucket and its per-bucket compile warm-up have no counterpart here;
--pad_multiple is still accepted and passed through (default: no padding).

Usage (what `make main` runs, on the port):
  python -m dots_socp_torch.replication.sweep --ntime=31 --nit=10000 \
      --tol=1e-4 --time_limit=300 --outdir=output/main \
      --congestions 0.00 0.01 0.05 --examples airplane refined_airplane ...
"""

import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

from dots_socp_torch import cli  # noqa: E402
from dots_socp_torch.config import LOG_LEVELS  # noqa: E402
from dots_socp_torch.interface import (  # noqa: E402
    print_example_info,
    run_dot_surface,
    set_logging_level,
)
from dots_socp_torch.replication.log2table import log2table  # noqa: E402

DEFAULT_EXAMPLES = [
    "airplane", "refined_airplane", "armadillo", "refined_armadillo",
    "hand", "refined_hand", "punctured_ball", "refined_punctured_ball",
    "bunny", "refined_bunny", "ring", "knots_3", "knots_5", "hills",
]


def build_opts(parser, args, example: str, congestion: float):
    argv = [
        f"--example={example}",
        f"--ntime={args.ntime}",
        f"--nit={args.nit}",
        f"--tol={args.tol}",
        f"--time_limit={args.time_limit}",
        f"--congestion={congestion}",
        f"--outdir={args.outdir}",
    ]
    if example == "hills":
        argv.append("--power_perceptual=0.5")
    opts = parser.parse_args(argv)
    opts.pad_multiple = args.pad_multiple
    return opts


def warm_up(device):
    """Bring up what the first solve on `device` would otherwise pay for:
    the CUDA context and the kernels' build. Nothing to do on the CPU."""
    import torch

    from dots_socp_torch.ops import _build, resolve_device

    if resolve_device(device).type != "cuda":
        return
    t0 = time.perf_counter()
    _build.load()
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    print(f"[sweep] device and kernels up: {time.perf_counter() - t0:.1f}s", flush=True)


def main(argv=None):
    """Run the sweep; returns [(example, congestion, run_history)] in the
    order run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--nit", type=int, default=10000)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--time_limit", type=float, default=300,
                    help="per-run wall budget; runs that hit it are marked "
                    "'time-capped' in the Converged column")
    ap.add_argument("--outdir", default="output/main")
    ap.add_argument("--congestions", nargs="+", type=float,
                    default=[0.0, 0.01, 0.05])
    ap.add_argument("--examples", nargs="+", default=DEFAULT_EXAMPLES)
    ap.add_argument("--pad_multiple", type=int, default=None,
                    help="pad vertex/triangle counts to this multiple "
                    "(default: no padding)")
    ap.add_argument("--no_warmup", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every solve (default cuda)")
    args = ap.parse_args(argv)

    parser = cli.parse_args(return_parser=True)
    solver = cli.device_solver(args.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    if not args.no_warmup:
        warm_up(args.device)

    runs = []
    for congestion in args.congestions:
        tag = f"{congestion:.2f}".replace(".", "_")
        c_dir = outdir / f"congestion_{tag}"
        c_dir.mkdir(parents=True, exist_ok=True)
        log_file = c_dir / "info.log"
        set_logging_level("info", log_file=str(log_file))
        for example in args.examples:
            print(f"[sweep] === {example} congestion={congestion}", flush=True)
            opts = build_opts(parser, args, example, congestion)
            opts.outdir = str(c_dir)
            t0 = time.perf_counter()
            print_example_info(opts)  # the block header log2table splits on
            _, _, history = run_dot_surface(opts=opts, solver=solver, solver_name="socp")
            runs.append((example, congestion, history))
            errors = np.asarray(history.get_current_kkt_errors(), dtype=float)
            converged = bool(np.all(errors < args.tol))
            logging.log(
                LOG_LEVELS["info"],
                f"Converged: {'yes' if converged else 'time-capped'}",
            )
            print(f"[sweep] --- {example}: "
                  f"{'converged' if converged else 'TIME-CAPPED'} in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        set_logging_level("info", log_file=None)  # release the file handler
        log2table(
            str(log_file),
            [str(c_dir / "comparison_table.tex"),
             str(c_dir / "comparison_table.html")],
        )

    print("[sweep] done", flush=True)
    return runs


if __name__ == "__main__":
    main()
