"""The benchmark of dots_socp_torch: transport problems solved to a KKT
tolerance through the public entry point, back to back, on one NVIDIA GPU.

    python3 -m otbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Everything is found by name from
`BENCHMARK.json`: the cell's configuration (`otbench/configs/`), its traffic
mix (`otbench/traffic/`, drawn by `otbench/traffic.py`), its limits
(`otbench/limits/<cell>.json`), each metric's reader
(`otbench/metrics/<metric>.py`) and the kernel names of each kernel layer
(`otbench/kernels/<layer>.json`).

A run:

1. set-up (`setup_s`, from the start of this process): imports, the CUDA
   context, the program's kernel library and factor caches (built into
   `otbench/cache/` on a checkout's first run, read there after), the mesh,
   and a short warm-up solve of a pair outside the window;
2. the window: the mix's problems in a closed loop, one `solver()` call
   after another, until `--seconds` have passed; the problem in flight then
   finishes and closes the window (`solve_s` = window / problems);
3. with `--trace 1`, the window's first problem solved again under
   torch.profiler (a sample of the window, profiled whole; a session that
   recorded no device event, or fewer launches of a kernel layer than the
   program counted, is dropped and the next problem is tried);
4. the check (`correct`): every problem of the window held by the plain
   reference (`otbench/reference/optimality.py`) to the cell's limits, after
   the peak device memory is read and the program's state freed.

The last line of standard output is one JSON object; the compared numbers,
each beside its limit, end standard error and the result's line. The run
fails without a result when there is no CUDA device, and when a module of
JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402

if __name__ == "__main__":
    # One thread in each host pool (OpenMP, MKL, OpenBLAS), set before NumPy
    # and PyTorch load: the host's share of a problem, half of an n64
    # problem's time, varies less from run to run so (PERF.md, section 2).
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from otbench.reference import plane  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / "cache"
#: Top-level module names no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "dots_socp_tpu")
#: Profiled problems tried before the trace gives up.
PROFILE_TRIES = 3
COUNTERS = ("solves", "iterations", "window_matvecs", "fused_steps")
#: A configuration's `mesh` -> the generator of its geometry at `n_space`.
MESHES = {"plane": plane.geometry}


def forbidden_modules(modules=None) -> list:
    """Forbidden top-level names among `modules` (default: sys.modules),
    compared whole: the part of each name before the first dot."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


#: The program's build and kernel caches: variable -> directory under the cache.
CACHE_VARS = {"DOTS_SOCP_CACHE_DIR": ".", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def use_cache_dirs(cache: Path = CACHE):
    """Every build and kernel cache of the program at fixed paths under `cache`."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(cache / sub)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """Everything a cell's run reads, found by name from BENCHMARK.json."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / "otbench"

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "cell": cell,
        "config": load_json(root / configs[cell["config"]]["file"]),
        "mix": load_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(bench_dir / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "kernels": {p.stem: load_json(p) for p in sorted((bench_dir / "kernels").glob("*.json"))},
        "metrics_dir": bench_dir / "metrics",
    }


def reader(metrics_dir: Path, name: str):
    """The `read(record)` of `metrics/<name>.py`."""
    spec = importlib.util.spec_from_file_location(f"otbench_metric_{name}",
                                                  metrics_dir / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def counter(path: str) -> int:
    """A program counter named "module:attribute"."""
    module, attr = path.split(":")
    return int(getattr(importlib.import_module(module), attr))


class Program:
    """The system under test: the public `dots_socp_torch.solver` and the
    counters it keeps (CG work, CUDA graph captures, kernel launches)."""

    def __init__(self, config: dict, mix: dict, kernels: dict, device: str):
        import dots_socp_torch
        from dots_socp_torch.ops import graphs
        from dots_socp_torch.ops.laplacian import CG_COUNTERS

        self.solver, self.graphs, self.cg = dots_socp_torch.solver, graphs, CG_COUNTERS
        self.config, self.mix, self.device = config, mix, device
        self.launch_counters = {layer: k["launch_counter"] for layer, k in kernels.items()}

    def counts(self) -> dict:
        out = {f"cg.{name}": getattr(self.cg, name) for name in COUNTERS}
        out["capture_s"] = self.graphs.STATS.capture_seconds
        out.update({f"launches.{layer}": counter(c) for layer, c in self.launch_counters.items()})
        return out

    def solve(self, geom: dict, pair: dict, nit=None):
        """One call of the public entry point; (solution, record)."""
        problem = dict(geom, mu0=pair["mu0"], mu1=pair["mu1"])
        before = self.counts()
        t0 = time.perf_counter()
        solution, history = self.solver(
            self.config["ntime"], problem, tol=self.mix["tol"],
            nit=self.mix["nit"] if nit is None else nit, congestion=self.mix["congestion"],
            precision=self.config["precision"], device=self.device)
        call_s = time.perf_counter() - t0
        after = self.counts()
        record = {
            "call_s": call_s,
            "running_time": float(history.running_time),
            "iterations": int(history.kkt_iteration[-1]) + 1,
            "validations": len(history.kkt_iteration),
            "converged": bool((history.get_current_kkt_errors() < self.mix["tol"]).all()),
            "cost": float(history.history["Transportation cost"][-1]),
            **{k: after[k] - before[k] for k in after},
        }
        return solution, record


def sync(device):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def check_path(config: dict, records: list):
    """The phi solve the configuration names is the one that ran."""
    ran = "cg" if any(r["cg.solves"] for r in records) else "spectral"
    if ran != config["phi_solve"]:
        raise RuntimeError(f"the configuration names the {config['phi_solve']} phi solve; "
                           f"the program ran the {ran} one")


def profile_problem(program, geom, pair, kernels) -> dict | None:
    """One problem solved under torch.profiler, read by `trace.read`;
    None when the session lost its device events (whole or a kernel layer's
    launches in part)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from otbench import trace

    layers = {layer: k["pattern"] for layer, k in kernels.items()}
    sync(program.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.SPAN):
            _, rec = program.solve(geom, pair)
            torch.cuda.synchronize()
    got = trace.read(prof, layers)
    del prof
    if got is None:
        return None
    for layer in layers:
        if got["layers"][layer]["events"] != rec[f"launches.{layer}"]:
            return None
    got["record"] = rec
    return got


def run_cell(spec: dict, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
             t_process: float = T_PROCESS) -> dict:
    """One run of a cell; the result's dict (the last line's object)."""
    from otbench import traffic
    from otbench.reference import optimality

    logging.basicConfig(level=logging.WARNING)
    config, mix = spec["config"], spec["mix"]
    if device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    program = Program(config, mix, spec["kernels"], device)
    geom = MESHES[config["mesh"]](config["n_space"])
    program.solve(geom, next(traffic.problems(mix, geom, seed, traffic.WARMUP)),
                  nit=mix["warmup_nit"])

    sync(device)
    t_open = time.perf_counter()
    setup_s = t_open - t_process
    pairs = traffic.problems(mix, geom, seed, traffic.WINDOW)
    window = []
    while True:
        pair = next(pairs)
        solution, rec = program.solve(geom, pair)
        window.append((pair, solution, rec))
        if time.perf_counter() - t_open >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t_open
    records = [rec for _, _, rec in window]
    check_path(config, records)

    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    if device == "cuda":
        import torch

        dev.update(kind=torch.cuda.get_device_name(0),
                   memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
        dev["power_limit"] = nvidia_smi("power.limit")

    profiled, dropped = None, 0
    if trace_on and device == "cuda":
        # The window's first problem, then the next (the first again in a
        # window of one).
        for pair, _, _ in itertools.islice(itertools.cycle(window), PROFILE_TRIES):
            profiled = profile_problem(program, geom, pair, spec["kernels"])
            if profiled is not None:
                break
            dropped += 1
        if profiled is not None:
            dev.update(busy_s=profiled["busy_s"], window_s=profiled["wall_s"])

    del program
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()

    calc = optimality.Calculus(geom["vertices"], geom["triangles"])
    worst = {name: 0.0 for name in spec["limits"]["compared"]}
    for pair, solution, rec in window:
        got = optimality.residuals(calc, pair["mu0"], pair["mu1"], solution["mu"],
                                   solution["E"], solution["phi"], rec["cost"])
        rec["residuals"] = got
        for name in worst:
            value = got[name] if math.isfinite(got[name]) else float("inf")
            worst[name] = max(worst[name], value)
    compared = {name: {"value": worst[name], "limit": spec["limits"]["compared"][name]["limit"]}
                for name in worst}
    correct = bool(window) and all(c["value"] <= c["limit"] for c in compared.values())

    lanes = config["ntime"] + 1
    nnz = calc.laplacian_nnz()
    record = {
        "setup_s": setup_s, "window_s": window_s, "problems": records,
        "profile": profiled,
        "work": {"matvec": {"n_vertices": calc.n_vertices, "lanes": lanes, "nnz": nnz},
                 "cg_update": {"n_vertices": calc.n_vertices, "lanes": lanes}},
    }
    wanted = spec["per_layer"] if trace_on else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        value = reader(spec["metrics_dir"], m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct, "attempted": len(records),
              "failed": sum(not r["converged"] for r in records),
              "metrics": metrics, "device": dev}
    if profiled is not None:
        result["breakdown"] = {"device_ops": profiled["device_ops"],
                               "idle_gaps": profiled["idle_gaps"]}
        result["profiled"] = {"iterations": profiled["record"]["iterations"],
                              "launch_calls": profiled["launch_calls"],
                              "layers": profiled["layers"]}
    if trace_on:
        result.setdefault("profiled", {})["dropped"] = dropped
    result["problems"] = [{k: r[k] for k in ("iterations", "validations", "call_s",
                                               "running_time", "converged", "residuals")}
                          for r in records]
    result["compared"] = compared
    return result


def nvidia_smi(field: str):
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    use_cache_dirs()
    os.environ.setdefault("TQDM_DISABLE", "1")
    import dots_socp_torch  # noqa: F401  (the program: without it, no run)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"otbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"otbench: loaded {found}: the run may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
