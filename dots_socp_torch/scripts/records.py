"""Every end-to-end record the JAX package left, run on the port at the
record's own size, each beside the JAX result read from its artifact.

    python -m dots_socp_torch.scripts.records [--only R1 R5 ...] [--device cpu]

A port-only measurement tool (no counterpart among the JAX package's
scripts). Each record runs through the port's public entry point, with the
flags of the JAX run that left it:

    R1   replication.sweep: 14 examples x congestion 0.00 / 0.01 / 0.05,
         ntime 31, tol 1e-4, padded as the JAX sweep pads (`make main`;
         42 rows, one per run)
    R2   scripts.steady_state_configs config 2 (plane n64, congestion 0.05)
    R3   scripts.steady_state_configs config 3 (plane n50, ntime 127)
    R4   scripts.solve_large, plane n200, ntime 31
    R5   scripts.solve_large, plane n200, ntime 127 (128 modes)
    R6   scripts.solve_large, plane n290, ntime 31
    R7   replication.main, plane n200, ntime 31, congestion 0.05
    R8   replication.main_versus_exact, plane n50, float64, tol 1e-5
    R9   replication.main_versus_exact, plane n200, ntime 31, tol 1e-5
    R10  scripts.solve_large, plane n410, ntime 31

The JAX side is parsed from the files under `artifacts/` at run time (the
LaTeX tables of the sweep, the "Total Iteration", "Transportation cost" and
"L_* Error" lines of a log, the last row of the versus-exact HTML table),
and every line names the file and line it came from. R4's artifact is a
`solve_large` log: the CLI de-scales the transport cost by the geometry's
normalisation and `solve_large` does not, so a cost is only compared with
one from the same entry point.

A row agrees when the port converged (every KKT entry <= tol), its
iterations are within ITER_RTOL of the record's, its transport cost within
COST_RTOL relative + COST_ATOL absolute, and each error against the exact
transport (R8, R9) within ERROR_RTOL. One JSON line per record (per row for
R1), then a summary line; the exit code is 1 when any row disagrees.

The whole run is long (on one H100: R1 about 15 minutes, R5, R6, R9 and R10
a few minutes each); split it over several calls with --only. Sizes are
never cut. The factor caches and the kernel library go to a fresh temporary
DOTS_SOCP_CACHE_DIR for the whole run: a factor computed by another LAPACK
build moves float32 iteration counts.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import Callable, NamedTuple

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

REPO = Path(__file__).resolve().parents[2]
ARTIFACTS = REPO / "artifacts"

# Tolerances of a row's verdict. Iterations: float32 rounding on another
# chip moves a count by ~3% (plane n50 at ntime 127: 1611 on the JAX
# package's TPU against 1663 on the CPU); 10% leaves about 3x that room.
ITER_RTOL = 0.10
# Transport cost: the sweep's tables print 4 decimals, and at tol 1e-4 two
# correct float32 solvers agree to about 1e-4.
COST_RTOL, COST_ATOL = 2e-3, 5e-5
ERROR_RTOL = 0.10  # each norm of the error against the exact transport

SWEEP_CONGESTIONS = ("0.00", "0.01", "0.05")
# R1 as `make main` ran it: the JAX sweep pads every mesh's vertex and
# triangle counts to a multiple of 4096 (its shape buckets, the default of
# its --pad_multiple), and padding moves float32 iteration counts; the time
# limit is high enough that no run is cut.
SWEEP_ARGV = ("--ntime", "31", "--nit", "10000", "--time_limit", "3000", "--pad_multiple", "4096")
# The CLI's own time limit is 300 s: every record's run gets room to finish.
TIME_LIMIT = ("--time_limit=3000",)


class Record(NamedTuple):
    title: str
    tol: float
    run: Callable  # (args, record) -> {row key: the port's result}
    argv: tuple  # the entry point's flags besides tol (R2, R3: the config's name)
    reference: Callable  # () -> {row key: the JAX result}


# ---- the JAX side -----------------------------------------------------------

def _where(path: Path, *lines: int) -> str:
    return f"{path.relative_to(REPO)}:{','.join(map(str, lines))}"


def _lines(path: Path) -> list:
    """The file's lines as an editor numbers them: a progress bar's carriage
    returns do not end a line."""
    return path.read_bytes().decode(errors="replace").split("\n")


def sweep_table(path: Path) -> dict:
    """Rows of a `log2table` LaTeX table: {example: {iterations, cost,
    source}}, the example named as the sweep's --examples name it."""
    rows = {}
    for lineno, line in enumerate(_lines(path), 1):
        cells = [c.strip() for c in line.rstrip("\\ ").split("&")]
        if len(cells) == 7 and cells[3].isdigit():
            rows[cells[0].lower().replace(" ", "_")] = {
                "iterations": int(cells[3]), "cost": float(cells[5]), "source": _where(path, lineno)}
    return rows


def sweep_reference(congestions=SWEEP_CONGESTIONS) -> dict:
    """R1: {(example, congestion): JAX result} from the three tables."""
    out = {}
    for congestion in congestions:
        tag = congestion.replace(".", "_")
        path = ARTIFACTS / "round5" / "make_main" / f"congestion_{tag}" / "comparison_table.tex"
        for example, row in sweep_table(path).items():
            out[(example, congestion)] = row
    return out


LOG_FIELDS = (
    ("iterations", int, re.compile(r"Total Iteration\s*:\s*(\d+) iterations")),
    ("cost", float, re.compile(r"Transportation cost:\s*(\S+)")),
    ("l1", float, re.compile(r"L_1 Error:\s*(\S+)")),
    ("l2", float, re.compile(r"L_2 Error:\s*(\S+)")),
    ("linf", float, re.compile(r"L_Inf Error:\s*(\S+)")),
)


def log_result(path: Path, before: int | None = None) -> dict:
    """The last "Total Iteration" and "Transportation cost" lines of a solver
    log above line `before` (1-based; the whole file by default), and its
    "L_* Error" lines where it has them (under `errors`)."""
    lines = _lines(path)
    found = {}
    for lineno, line in enumerate(lines[: None if before is None else before - 1], 1):
        for key, kind, pattern in LOG_FIELDS:
            match = pattern.search(line)
            if match:
                found[key] = (kind(match.group(1)), lineno)
    if "iterations" not in found or "cost" not in found:
        raise ValueError(f"{path} has no 'Total Iteration' and 'Transportation cost' lines")
    out = {"iterations": found["iterations"][0], "cost": found["cost"][0]}
    errors = {k: found[k][0] for k in ("l1", "l2", "linf") if k in found}
    if errors:
        out["errors"] = errors
    out["source"] = _where(path, *sorted({lineno for _, lineno in found.values()}))
    return out


def steady_state_result(path: Path, config: str) -> dict:
    """Protocol config `config` of the JAX package's steady_state_configs
    output: the log block above the config's first JSON line."""
    for lineno, line in enumerate(_lines(path), 1):
        if line.startswith("{") and f'"config_{config}"' in line:
            return log_result(path, before=lineno)
    raise ValueError(f"{path} has no line of config {config}")


def error_table_row(path: Path) -> dict:
    """The last row of a versus-exact checkpoint table (HTML): the
    iteration and the L1, L2 and L-Inf errors."""
    html = path.read_text()
    header = re.findall(r"<th>(.*?)</th>", html)
    start = html.rfind("<tr>")
    end = html.index("</tr>", start)
    row = dict(zip(header, re.findall(r"<td>(.*?)</td>", html[start:end])))
    first = html[:start].count("\n") + 1
    return {"iterations": int(row["Iteration"]),
            "errors": {"l1": float(row["L1"]), "l2": float(row["L2"]), "linf": float(row["L-Inf"])},
            "source": _where(path, first, first + html[start:end].count("\n"))}


def _one(parse, *args):
    return lambda: {None: parse(*args)}


# ---- the port's side --------------------------------------------------------

def history_result(history, tol: float, errors=None) -> dict:
    """What a record compares, from the run's history: iterations as its
    "Total Iteration" line counts them, convergence (every KKT entry <=
    tol), the largest final KKT entry, the transport cost, the loop's
    seconds."""
    import numpy as np

    kkt = np.asarray(history.get_current_kkt_errors(), dtype=float)
    iterations = int(history.kkt_iteration[-1])
    out = {
        "iterations": iterations,
        "converged": bool(np.nanmax(kkt) <= tol),
        "kkt_max": float(np.nanmax(kkt)),
        "cost": float(history.history["Transportation cost"][-1]),
        "seconds": float(history.running_time),
        "it_per_s": iterations / float(history.running_time),
    }
    if errors is not None:
        out["errors"] = {k: float(errors[k]) for k in ("l1", "l2", "linf")}
    return out


def run_sweep(args, record) -> dict:
    from dots_socp_torch.replication import sweep

    runs = sweep.main([*record.argv, "--tol", str(record.tol), "--outdir", args.outdir,
                       "--device", args.device, "--examples", *args.examples,
                       "--congestions", *args.congestions])
    return {(example, f"{congestion:.2f}"): history_result(history, record.tol)
            for example, congestion, history in runs}


def run_steady_state(args, record) -> dict:
    from dots_socp_torch import cli
    from dots_socp_torch.scripts import steady_state_configs

    (config,) = record.argv
    _, history = steady_state_configs.run_config(
        cli.parse_args(return_parser=True), steady_state_configs.CONFIGS[config], args.device)
    return {None: history_result(history, record.tol)}


def run_solve_large(args, record) -> dict:
    from dots_socp_torch.scripts import solve_large

    _, history, _ = solve_large.main([*record.argv, "--tol", str(record.tol), "--skip_histogram",
                                      "--device", args.device])
    return {None: history_result(history, record.tol)}


def _cli_argv(args, record):
    return ["--example=plane", f"--tol={record.tol}", *record.argv, *TIME_LIMIT,
            f"--outdir={args.outdir}", f"--device={args.device}"]


def run_cli(args, record) -> dict:
    from dots_socp_torch.replication import main

    _, _, history = main.main(_cli_argv(args, record))
    return {None: history_result(history, record.tol)}


def run_versus_exact(args, record) -> dict:
    from dots_socp_torch.replication import main_versus_exact

    _, _, history, errors, _ = main_versus_exact.main(_cli_argv(args, record))
    return {None: history_result(history, record.tol, errors)}


ROUND4, ROUND5 = ARTIFACTS / "round4", ARTIFACTS / "round5"
RECORDS = {
    "R1": Record("make main sweep: 14 examples x congestion 0.00 / 0.01 / 0.05, ntime 31", 1e-4,
                 run_sweep, SWEEP_ARGV, sweep_reference),
    "R2": Record("protocol config 2: plane n64, congestion 0.05", 1e-4, run_steady_state, ("2",),
                 _one(steady_state_result, ROUND4 / "steady_state_configs.stdout", "2")),
    "R3": Record("protocol config 3: plane n50, ntime 127", 1e-4, run_steady_state, ("3",),
                 _one(steady_state_result, ROUND4 / "steady_state_configs.stdout", "3")),
    "R4": Record("plane n200, ntime 31, CG + f64 refinement", 1e-4, run_solve_large,
                 ("--n_space", "200", "--ntime", "31"),
                 _one(log_result, ROUND4 / "solve_large_v46k_refine.stdout")),
    "R5": Record("plane n200, ntime 127 (128 modes)", 1e-4, run_solve_large,
                 ("--n_space", "200", "--ntime", "127"),
                 _one(log_result, ROUND5 / "nt127_v46k_chip.stdout")),
    "R6": Record("plane n290, ntime 31", 1e-4, run_solve_large, ("--n_space", "290", "--ntime", "31"),
                 _one(log_result, ROUND4 / "solve_large_v97k.log")),
    "R7": Record("plane n200, ntime 31, congestion 0.05", 1e-4, run_cli,
                 ("--n_space=200", "--ntime=31", "--congestion=0.05", "--nit=20000"),
                 _one(log_result, ROUND4 / "congestion005_v46k.stdout")),
    "R8": Record("versus exact: plane n50, ntime 31, float64, tol 1e-5", 1e-5, run_versus_exact,
                 ("--n_space=50", "--ntime=31", "--precision=float64", "--nit=20000"),
                 _one(error_table_row, ROUND5 / "true_error" / "error_versus_exact_socp.html")),
    "R9": Record("versus exact: plane n200, ntime 31, float32 + f64 refinement, tol 1e-5", 1e-5,
                 run_versus_exact, ("--n_space=200", "--ntime=31", "--nit=30000"),
                 _one(log_result, ROUND4 / "versus_exact_v46k.log")),
    "R10": Record("plane n410, ntime 31", 1e-4, run_solve_large, ("--n_space", "410", "--ntime", "31"),
                  _one(log_result, ROUND4 / "solve_large_v195k_r4.stdout")),
}


# ---- the verdict ------------------------------------------------------------

def compare(port: dict, jax: dict) -> dict:
    """{check: bool} of one row: the port converged, and each number the
    record holds is within its tolerance."""
    checks = {
        "converged": port["converged"],
        "iterations": abs(port["iterations"] - jax["iterations"]) <= ITER_RTOL * jax["iterations"],
    }
    if "cost" in jax:
        checks["cost"] = abs(port["cost"] - jax["cost"]) <= COST_RTOL * abs(jax["cost"]) + COST_ATOL
    for norm, value in jax.get("errors", {}).items():
        checks[f"error_{norm}"] = abs(port["errors"][norm] - value) <= ERROR_RTOL * value
    return checks


def main(argv=None):
    """Run the chosen records; returns the summary (its `lines` hold every
    row's line as printed)."""
    from dots_socp_torch.bench import fresh_cache_dir
    from dots_socp_torch.scripts.common import add_device_arg, device_fields, print_result

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=list(RECORDS), default=list(RECORDS),
                    help="records to run, in this order (default: all)")
    ap.add_argument("--examples", nargs="+", default=None,
                    help="R1's rows: these examples only (default: every row of the tables)")
    ap.add_argument("--congestions", nargs="+", default=list(SWEEP_CONGESTIONS),
                    choices=SWEEP_CONGESTIONS, help="R1's rows: these congestions only")
    ap.add_argument("--outdir", default="output/records",
                    help="the runs' logs and tables, one folder per record")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from dots_socp_torch.ops import resolve_device

    args.device = str(resolve_device(args.device))
    outdir = args.outdir
    device = device_fields(args.device)
    lines = []
    with fresh_cache_dir():
        for name in args.only:
            record = RECORDS[name]
            reference = record.reference()
            if name == "R1":
                known = sorted({e for e, _ in reference})
                if not set(args.examples or known) <= set(known):
                    ap.error(f"--examples: R1's rows are {known}")
                args.examples = args.examples or known
            args.outdir = str(Path(outdir) / name)
            for key, port in record.run(args, record).items():
                jax = reference[key]
                checks = compare(port, jax)
                row = "@".join(key) if key is not None else None
                lines.append(print_result({
                    "record": name, "row": row, "title": record.title, "tol": record.tol,
                    "port": port, "jax": jax, "checks": checks, "agrees": all(checks.values()),
                    **device,
                }))
    summary = print_result({
        "records": args.only, "rows": len(lines),
        "disagree": [f"{ln['record']}:{ln['row']}" if ln["row"] else ln["record"]
                     for ln in lines if not ln["agrees"]],
        "agrees": all(ln["agrees"] for ln in lines), **device,
    })
    return {**summary, "lines": lines}


if __name__ == "__main__":
    sys.exit(0 if main()["agrees"] else 1)
