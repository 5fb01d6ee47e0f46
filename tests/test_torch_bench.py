"""The port's bench lane (`dots_socp_torch.bench`), `scripts.bench_large` and
`scripts.steady_state_configs` at tiny sizes on the CPU: each ends in one
JSON line with its keys, and where the JAX script gives a number that is
not a time, the JAX script (a subprocess, as tests/test_scripts_smoke.py
runs it) gives the same on the same problem."""

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import pytest

from dots_socp_torch import bench
from dots_socp_torch.scripts import bench_large, steady_state_configs
from torch_rank_worker import one_thread

REPO = Path(__file__).resolve().parents[1]
LANE_ARGV = ["--n_space", "12", "--large_n_space", "24", "--ntime", "4", "--flagship_iters", "6",
             "--large_iters", "3", "--repeats", "2", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def run_main(main, argv):
    """(returned result, printed lines) of a driver's main."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = main(argv)
    return out, printed.getvalue().strip().splitlines()


def run_jax_script(name, args):
    """The last JSON line of the JAX package's scripts/`name` on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / name), *args], cwd="/tmp",
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])


def jax_vertices(n_space):
    import __graft_entry__ as graft

    return graft._build(n_space, 4, "float32")[0].n_vertices_real


@pytest.fixture(scope="module")
def lane():
    return run_main(bench.main, LANE_ARGV)


def test_lane_ends_in_one_json_line_with_every_repeat(lane):
    out, lines = lane
    last = json.loads(lines[-1])
    assert last == json.loads(json.dumps(out))
    assert last["unit"] == "iter/s" and last["device"] == "cpu" and last["card"] is None
    for cell, nit in (("flagship", 6), ("large_mesh", 3)):
        line = last[cell]
        assert line["nit"] == nit and len(line["repeats"]) == len(line["solve_sec"]) == 2
        assert line["iters_per_sec"] == statistics.median(line["repeats"]) > 0
    assert last["value"] == last["flagship"]["iters_per_sec"]
    reference = json.loads((REPO / ".bench_reference_cpu.json").read_text())["iters_per_sec"]
    assert last["reference_iters_per_sec"] == reference
    assert last["vs_baseline"] == pytest.approx(last["value"] / reference, rel=1e-12)


def test_lane_cells_take_their_paths_and_b1_is_not_timed_on_the_cpu(lane):
    """flagship: the spectral phi-solve, no window matvec; large_mesh: the CG
    path with f64 refinement, the window matvec (B1's plain version) in
    every inner iteration. B1's device time and the library call's are not
    measured on the CPU (null); its bound is computed from the operator."""
    out, _ = lane
    flag, large = out["flagship"], out["large_mesh"]
    assert flag["phi_solve"] == "spectral" and flag["window_matvecs"] == 0
    assert large["phi_solve"] == "cg+f64 refinement" and large["window_matvecs"] > 0
    assert large["inner_cg_per_outer"] > 0
    assert large["window_matvec_us"] is None and large["library_us"] is None
    assert large["window_bound_us"] > 0 and large["window_bound_by"] in ("bytes", "operations")
    assert large["tile_rows"] % 16 == 0 and large["window_width"] >= large["tile_rows"]
    assert large["chained_matvecs"] == 0 and out["kernel_build_sec"] is None


def test_lane_vertex_counts_match_reference(lane):
    """n_vertices of both cells, exact, against the JAX package's build of the
    same plane meshes (`__graft_entry__._build`, which bench.py uses)."""
    out, _ = lane
    assert out["flagship"]["n_vertices"] == jax_vertices(12) == 182
    assert out["large_mesh"]["n_vertices"] == jax_vertices(24)


def test_lane_converge_uses_fresh_factors(monkeypatch):
    """--converge runs both cells to the tolerance (1e-2 here for speed) with
    DOTS_SOCP_CACHE_DIR at a temporary directory, restored afterwards."""
    monkeypatch.setattr(bench, "CONVERGE_TOL", 1e-2)
    monkeypatch.setenv("DOTS_SOCP_CACHE_DIR", "/nonexistent/before")
    seen = []
    solve = bench.solve
    monkeypatch.setattr(bench, "solve", lambda *a: seen.append(os.environ["DOTS_SOCP_CACHE_DIR"])
                        or solve(*a))
    out, _ = run_main(bench.main, [*LANE_ARGV[:-4], "--repeats", "1", "--converge",
                                   "--device", "cpu"])
    conv = out["converge"]
    assert conv["tol"] == 1e-2 and conv["cache_dir"] == "fresh temporary directory"
    for cell in ("flagship", "large_mesh"):
        assert conv[cell]["converged"] and conv[cell]["iterations"] > 0
        assert 2 <= conv[cell]["validations"] <= conv[cell]["iterations"] + 2
    assert len(set(seen)) == 1 and "dots_bench_cache_" in seen[0]
    assert not os.path.exists(seen[0])
    assert os.environ["DOTS_SOCP_CACHE_DIR"] == "/nonexistent/before"


def test_bench_large_matches_reference_kkt():
    """plane n12, ntime 4, CG path forced, cg_max_iters 5. The JAX script runs
    2 + 2 + (2 + iters) iterations, the port 2 + iters: the port at 14 and
    JAX at 10 both make 16. kkt_stop_error within 1e-5 relative (float32
    inner CG, sums in another order; measured 2.2e-7); the vertex count
    exact. compile_sec is warmup_sec here, and raw_iters_per_sec is gone
    (no dispatch round trip to difference out)."""
    ours, lines = run_main(bench_large.main, ["--n_space", "12", "--n_time", "4", "--iters", "14",
                                              "--cg_max_iters", "5", "--device", "cpu"])
    assert json.loads(lines[-1]) == ours
    ref = run_jax_script("bench_large.py", ["--n_space", "12", "--n_time", "4", "--iters", "10",
                                            "--cg_max_iters", "5"])
    assert ours["iterations"] == 16 and ours["phi_refine"] and ours["window_spmv"]
    assert ours["n_vertices"] == 182 and "V=182" in ref["metric"]
    assert ours["kkt_stop_error"] == pytest.approx(ref["kkt_stop_error"], rel=1e-5)
    for key in ("value", "sec_per_iter", "setup_sec", "warmup_sec"):
        assert ours[key] > 0, key
    assert "compile_sec" not in ours and "raw_iters_per_sec" not in ours


def test_steady_state_smoke_matches_reference():
    """--configs smoke (plane n12, ntime 4, congestion 0.05, tol 1e-2): the
    iteration count within 2 of the JAX script's (float32 sums in another
    order move the validation at which tol is crossed; measured equal, 38)
    and the same convergence. `warmup_incl_compile_sec` is `warmup_sec`."""
    ours, lines = run_main(steady_state_configs.main, ["--configs", "smoke", "--device", "cpu"])
    assert json.loads(lines[-1]) == ours and ours["device"] == "cpu"
    assert json.loads(lines[-2]) == {"config_smoke": ours["config_smoke"]}
    ref = run_jax_script("steady_state_configs.py", ["--configs", "smoke"])["config_smoke"]
    got = ours["config_smoke"]
    assert abs(got["iterations"] - ref["iterations"]) <= 2
    assert got["converged"] == ref["converged"] is True
    assert got["warmup_sec"] > 0 and got["solve_sec"] > 0 and got["iters_per_sec"] > 0
    assert "warmup_incl_compile_sec" not in got
    assert got["argv"].endswith("--device=cpu")
