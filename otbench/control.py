"""The control of the benchmark's `correct`: the cell's runs with the program
in a lower precision than its configuration states, which the check has to
find not correct. Run on the chip by hand, never by the benchmark's runs:

    python3 -m otbench.control --workload <cell> --variant tf32 --seeds 1 2 3 --seconds 1

Variants:

  none  -- the program as the configuration states it (sound readings of
           several seeds in one process);
  tf32  -- the configuration's float32 with TF32 off, so the step below:
           the program's matrix products in TF32 (PyTorch's switch, which
           the program turns off when it is imported, turned on after);
  bf16  -- the program's answer (density, momentum, potential) rounded to
           bfloat16 where it is produced (`solver/socp.py::_recover_solution`);
  cost  -- a fault, not a precision: the transport cost the run reports
           altered by 1% where it is produced (`solver/socp.py`'s
           `objective_functional`), which only `cost_gap` can see.

One JSON line per seed: the compared numbers (the largest over the window's
problems), each problem's iterations and whether it converged, `correct`.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

if __name__ == "__main__":
    # The host pools as the benchmark's runs have them (`run.py`).
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from otbench import run  # noqa: E402


@contextlib.contextmanager
def variant(name: str):
    """The program with `name` switched on for the extent."""
    import torch

    import dots_socp_torch.ops  # noqa: F401  (sets TF32 off when imported)
    from dots_socp_torch.solver import socp

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    recover, objective = socp._recover_solution, socp.objective_functional
    if name == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    elif name == "bf16":
        def rounded(*args, **kwargs):
            solution = recover(*args, **kwargs)
            for key in ("phi", "mu", "E"):
                solution[key] = torch.from_numpy(solution[key]).to(torch.bfloat16).float().numpy()
            return solution

        socp._recover_solution = rounded
    elif name == "cost":
        def altered(*args, **kwargs):
            cost, lagrangian = objective(*args, **kwargs)
            return cost * 1.01, lagrangian

        socp.objective_functional = altered
    elif name != "none":
        raise ValueError(f"unknown variant {name!r}")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        socp._recover_solution, socp.objective_functional = recover, objective


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=("none", "tf32", "bf16", "cost"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.load_spec(args.workload)
    run.use_cache_dirs()
    os.environ.setdefault("TQDM_DISABLE", "1")
    t_process = T_PROCESS
    for seed in args.seeds:
        with variant(args.variant):
            result = run.run_cell(spec, seed, args.seconds, False, device=args.device,
                                  t_process=t_process)
        t_process = time.perf_counter()
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "correct": result["correct"], "compared": result["compared"],
                          "problems": [{k: p[k] for k in ("iterations", "converged", "residuals")}
                                       for p in result["problems"]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
