"""The port's run-to-completion surface (`dots_socp_torch.replication`,
`dots_socp_torch.demo`, `dots_socp_torch.scripts.solve_large`,
`--profile_dir`) against the repository's `replication/` folder and the JAX
package, on the CPU at small sizes."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dots_socp_torch import cli as t_cli
from dots_socp_torch.replication import log2table as t_log2table
from dots_socp_torch.replication import main_versus_exact as t_versus
from dots_socp_torch.replication import sweep as t_sweep

from test_interface import REFERENCE_DIR, SHIM_DIR  # where the reference implementation may lie
from torch_rank_worker import ONE_THREAD_ENV, one_thread

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dots_socp_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def _load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("tol", [1e-1, 1e-2, 3e-3, 1e-4, 5e-5, 1e-6, 0.5])
def test_automatic_checkpoints_equal_the_originals(tol):
    original = _load_module("orig_main_versus_exact", REPO / "replication" / "main_versus_exact.py")
    assert t_versus.automatic_checkpoints(tol) == original.automatic_checkpoints(tol)
    assert t_versus.EXACT_EXAMPLES == original.EXACT_EXAMPLES


def test_versus_exact_parser_is_redefaulted_like_the_original():
    original = _load_module("orig_main_versus_exact", REPO / "replication" / "main_versus_exact.py")
    ref = vars(original.parse_args(return_parser=True).parse_args([]))
    port = vars(t_versus.parse_args(return_parser=True).parse_args([]))
    assert {k: port[k] for k in ref} == ref
    assert port["versus_exact"] is True and port["outdir"] == "output/undated_versus_exact"
    with pytest.raises(SystemExit):
        t_versus.parse_args(argv=["--example", "ring"])


def test_versus_exact_flow_matches_reference(tmp_path):
    """The port's versus-exact script (plane n16, ntime 8, tol 1e-2, f64,
    one checkpoint per decade) gives the error rows of the JAX package's
    `run_dot_surface_versus_exact`: the same checkpoint iterations, every
    error and KKT value within 1e-8 relative (the bound of
    test_torch_solver.py::test_full_solve_matches_reference), the
    final l2 error below 0.5, and the exported table."""
    from dots_socp_tpu.cli import parse_args as j_parse_args
    from dots_socp_tpu.interface import run_dot_surface_versus_exact
    from dots_socp_tpu.solver import solver as j_solver

    argv = ["--example=plane", "--n_space=16", "--ntime=8", "--tol=1e-2", "--nit=1500"]
    _, _, _, err_t, rows_t = t_versus.main(
        argv + ["--precision=float64", "--device=cpu", f"--outdir={tmp_path / 'port'}"]
    )
    opts = j_parse_args(return_parser=True).parse_args(argv + [f"--outdir={tmp_path / 'jax'}"])
    opts.checkpoints = [1e-1, 1e-2]
    _, _, _, err_j, rows_j = run_dot_surface_versus_exact(
        solver=j_solver, solver_name="socp", opts=opts
    )
    assert 0 < err_t["l2"] < 0.5
    for key in ("l1", "l2", "linf"):
        assert abs(err_t[key] - err_j[key]) <= 1e-8 * abs(err_j[key]), key
    assert len(rows_t) == len(rows_j) == 2
    assert rows_t[1]["kkt_error"] < rows_t[0]["kkt_error"] <= 1e-1
    for row_t, row_j in zip(rows_t, rows_j):
        assert row_t["iteration"] == row_j["iteration"]
        assert abs(row_t["kkt_error"] - row_j["kkt_error"]) <= 1e-8 * row_j["kkt_error"]
        for key in ("l1", "l2", "linf"):
            assert abs(row_t["error"][key] - row_j["error"][key]) <= 1e-8 * row_j["error"][key]
    assert (tmp_path / "port" / "error_versus_exact_socp.html").exists()


def test_port_log_parses_alike_through_every_log2table(tmp_path):
    """A log written by a port solve (`replication.main`, --log_file)
    parses to the same CSV through the port's log2table, through the
    repository's `replication/log2table.py` and, where it exists, through
    the reference implementation's (the log format is an API)."""
    from dots_socp_torch.interface import set_logging_level
    from dots_socp_torch.replication import main as t_main

    log_path = tmp_path / "info.log"
    try:
        t_main.main(["--example=plane", "--n_space=16", "--ntime=8", "--tol=1e-2", "--nit=1500",
                     "--precision=float64", "--device=cpu", f"--outdir={tmp_path}",
                     f"--log_file={log_path}"])
    finally:
        set_logging_level("info")
    log = log_path.read_text()
    for block in ("Info: Experiment Setting", "---- Discretization", "Transportation cost:",
                  "Time of steps", "Total Iteration"):
        assert block in log, block

    t_log2table.log2table(str(log_path), [str(tmp_path / "port.csv"), str(tmp_path / "port.tex")])
    port_csv = (tmp_path / "port.csv").read_text()
    assert "Plane" in port_csv and "Transport Cost" in port_csv
    assert (tmp_path / "port.tex").exists()

    original = _load_module("orig_log2table", REPO / "replication" / "log2table.py")
    original.log2table(str(log_path), [str(tmp_path / "orig.csv")])
    assert port_csv == (tmp_path / "orig.csv").read_text()
    assert t_log2table.parse_log(str(log_path)) == original.parse_log(str(log_path))

    if not REFERENCE_DIR.exists():
        return  # the reference implementation is not on this machine
    sys.path.insert(0, str(SHIM_DIR))
    sys.path.insert(0, str(REFERENCE_DIR))
    try:
        ref = _load_module("ref_log2table", REFERENCE_DIR / "replication" / "log2table.py")
    finally:
        sys.path.remove(str(SHIM_DIR))
        sys.path.remove(str(REFERENCE_DIR))
    ref.log2table(str(log_path), [str(tmp_path / "ref.csv")])
    assert port_csv == (tmp_path / "ref.csv").read_text()


def test_sweep_writes_its_logs_and_tables(tmp_path):
    """Two examples x two congestions at nit=3: one info.log and one pair
    of tables per congestion, one row per run, the Converged column filled
    (time-capped: three iterations reach no tolerance), hills' perceptual
    power passed on."""
    from dots_socp_torch.interface import set_logging_level

    try:
        t_sweep.main(["--examples", "plane", "ring", "--congestions", "0.0", "0.01", "--ntime", "4",
                      "--nit", "3", "--tol", "1e-2", "--device", "cpu", "--outdir", str(tmp_path)])
    finally:
        set_logging_level("info")
    for tag in ("0_00", "0_01"):
        c_dir = tmp_path / f"congestion_{tag}"
        rows = t_log2table.parse_log(str(c_dir / "info.log"))
        assert [r["Example"] for r in rows] == ["plane", "ring"]
        assert [r["Converged"] for r in rows] == ["time-capped"] * 2
        assert f"congestion: {float(tag.replace('_', '.'))}" in (c_dir / "info.log").read_text()
        tex = (c_dir / "comparison_table.tex").read_text()
        assert "Converged" in tex and "Plane" in tex and "Ring" in tex
        assert "time-capped" in (c_dir / "comparison_table.html").read_text()
    parser = t_cli.parse_args(return_parser=True)
    args = t_sweep.argparse.Namespace(ntime=4, nit=3, tol=1e-2, time_limit=5, outdir="o", pad_multiple=16)
    opts = t_sweep.build_opts(parser, args, "hills", 0.05)
    assert (opts.power_perceptual, opts.pad_multiple, opts.congestion) == (0.5, 16, 0.05)
    assert t_sweep.build_opts(parser, args, "ring", 0.0).power_perceptual == 1.0


SCRIPTS = {
    "main": (PORT / "replication" / "main.py",
             ["--example=plane", "--n_space=10", "--ntime=4", "--nit=5", "--tol=1e-2"]),
    "main_versus_exact": (PORT / "replication" / "main_versus_exact.py",
                          ["--example=plane", "--n_space=10", "--ntime=4", "--nit=40", "--tol=1e-1"]),
    "sweep": (PORT / "replication" / "sweep.py",
              ["--examples", "ring", "--congestions", "0.0", "--ntime", "4", "--nit", "2"]),
    "demo": (PORT / "demo.py", ["--n_space=10", "--ntime=4", "--nit=5"]),
    "solve_large": (PORT / "scripts" / "solve_large.py",
                    ["--n_space", "12", "--ntime", "4", "--nit", "3", "--time_limit", "60",
                     "--tol", "1e-2"]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_runs_from_anywhere_without_pythonpath(name, tmp_path):
    """Each entry point, started by its path from another directory with no
    PYTHONPATH and --device cpu, finds the package by itself, runs to its end and
    leaves neither jax nor the JAX package imported; solve_large's last
    line carries the keys of tests/test_scripts_smoke.py."""
    path, argv = SCRIPTS[name]
    argv = [str(path), *argv, "--device", "cpu"]
    if name != "solve_large":
        argv += ["--outdir", str(tmp_path)]
    code = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        f"runpy.run_path({str(path)!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dots_socp_tpu'))\n"
        "assert not bad, bad\n"
        "print('IMPORTS_CLEAN')\n"
    )
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("IMPORTS_CLEAN")
    if name == "solve_large":
        result = json.loads(proc.stdout.strip().splitlines()[-2])
        assert result["iterations"] >= 0
        assert {"metric", "wall_sec", "iters_per_sec", "kkt_stop_error", "converged"} <= set(result)
        assert set(result["cg_iters_by_rtol_cold"]) == {"0.001", "0.0003", "0.0001", "3e-05",
                                                       "1e-05", "2e-06"}
    if name == "main_versus_exact":
        assert (tmp_path / "error_versus_exact_socp.html").exists()
    if name == "sweep":
        assert (tmp_path / "congestion_0_00" / "comparison_table.html").exists()


def test_module_form_runs_from_the_repository_root(tmp_path):
    """`python -m dots_socp_torch.replication.log2table` (the module form of
    every entry point) on a log of `python -m dots_socp_torch.replication.main`."""
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("PYTHONPATH", None)
    log = tmp_path / "info.log"
    for module, argv in (
        ("main", ["--example=plane", "--n_space=10", "--ntime=4", "--nit=5", "--device=cpu",
                  f"--log_file={log}", f"--outdir={tmp_path}"]),
        ("log2table", ["-i", str(log), "-o", str(tmp_path / "t.html")]),
    ):
        proc = subprocess.run([sys.executable, "-m", f"dots_socp_torch.replication.{module}", *argv],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Plane" in (tmp_path / "t.html").read_text()


def test_replication_main_on_a_time_sharded_mesh(tmp_path):
    """`python -m dots_socp_torch.replication.main --mesh_shape 2x1` in two
    gloo CPU processes (the replication entry points take the mesh flags
    through the CLI's `run`): both exit 0, world rank 0 alone writes the log,
    and its KKT lines and transport cost equal the single-process run's
    (the 2x1 solve is the single-device one, block by block)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("PYTHONPATH", None)
    argv = ["--example=plane", "--n_space=10", "--ntime=4", "--nit=20", "--tol=1e-3",
            "--precision=float64", "--device=cpu"]

    def command(outdir, *extra):
        return [sys.executable, "-m", "dots_socp_torch.replication.main", *argv,
                f"--log_file={outdir / 'info.log'}", f"--outdir={outdir}", *extra]

    dirs = [tmp_path / name for name in ("rank0", "rank1", "single")]
    for d in dirs:
        d.mkdir()
    procs = [subprocess.Popen(
        command(dirs[r], "--mesh_shape=2x1", "--dist_backend=gloo", "--num_processes=2",
                f"--process_id={r}", f"--coordinator_address=127.0.0.1:{port}"),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    procs.append(subprocess.Popen(command(dirs[2]), cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert not (dirs[1] / "info.log").exists()

    def results(path):
        return [ln for ln in path.read_text().splitlines()
                if "Org" in ln or "Transportation cost" in ln]

    mesh_lines, single_lines = results(dirs[0] / "info.log"), results(dirs[2] / "info.log")
    assert len(mesh_lines) == 6 and mesh_lines == single_lines  # 5 "Org" rows, the cost


def test_profile_dir_leaves_a_bounded_trace(tmp_path):
    """--profile_dir wraps the solve in torch.profiler and leaves a Chrome
    trace; it covers at most PROFILE_ITERATIONS iterations (here nit=3 ends
    it first), and the iteration hook is cleared afterwards."""
    from dots_socp_torch import interface
    from dots_socp_torch.solver import step

    profile_dir = tmp_path / "trace"
    t_cli.main(["--example=plane", "--n_space=10", "--ntime=4", "--nit=3", "--tol=1e-2",
                "--device=cpu", f"--profile_dir={profile_dir}"])
    trace = profile_dir / "solve_trace.json"
    assert trace.is_file() and step.AFTER_ITERATION is None
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)

    # The cap: 2 of 6 iterations traced, the trace closed inside the solve.
    counted = []
    with interface.profiler_trace(tmp_path / "capped", iterations=2) as out:
        for _ in range(6):
            if step.AFTER_ITERATION is not None:
                step.AFTER_ITERATION()
                counted.append(out.exists())
    assert counted == [False, True] and out.is_file()
