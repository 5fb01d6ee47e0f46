"""The port's solver slice against the JAX package on the conftest plane
(n=12): problem assembly, 60 iterations from the same initial state, the
adaptive segment's decisions, the f32 production path and the full solve;
plus the port's import graph, device rule and CLI."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_socp_torch.convert import problem_from_reference, state_from_reference
from dots_socp_torch.solver import problem as t_problem
from dots_socp_torch.solver import step as t_step
from dots_socp_torch.solver.kkt import kkt_table as t_kkt
from dots_socp_tpu.ops.mesh_ops import grad_space
from dots_socp_tpu.ops.time_stencils import decouple_space_adjoint, grad_time
from dots_socp_tpu.solver import problem as j_problem
from dots_socp_tpu.solver import step as j_step
from dots_socp_tpu.solver.kkt import compute_kkt as j_kkt
from dots_socp_tpu.solver.scaling import apply_z_scale
from dots_socp_tpu.solver.state import init_state

REPO = Path(__file__).resolve().parents[1]
N_TIME = 7

CONFIGS = {
    # f64 matrix-free CG at a fixed tight inner tolerance, no refinement.
    "cg_f64": dict(dtype="float64", laplacian_mode="cg", phi_refine="off", cg_rtol=1e-10),
    "spectral_f64": dict(dtype="float64", laplacian_mode="spectral"),
    # The production path: f32 CG with f64 refinement (auto); the port's
    # inner matvec is the window SpMV (plain version here), JAX's the ELL.
    "cg_f32": dict(dtype="float32", laplacian_mode="cg", cg_rtol=1e-6),
}


def _jax_setup(geometry, **kw):
    """The reference's problem and its initial state (z scaled by 2, as the
    solver starts), built the way `solver_socp` builds them."""
    config, data, extras = j_problem.build_problem(N_TIME, geometry, **kw)
    dt = config.stepsize_time
    state = init_state(
        N_TIME, config.n_vertices, config.n_triangles,
        extras["mu0_padded"], extras["mu1_padded"], dt,
        grad_time_fn=lambda p: grad_time(dt, p),
        grad_space_fn=lambda p: grad_space(data.ops, p),
        decouple_adjoint_fn=decouple_space_adjoint,
        norm_constant_d=extras["norm_constant_d"],
        dtype=config.jnp_dtype, phi_dtype=config.phi_dtype,
    )
    return config, data, apply_z_scale(state, 2.0)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setups(plane_geometry):
    """name -> (jax config, data, state; port config, data, state). The JAX
    chunk functions donate their state, so each call gets fresh arrays of the
    initial one (`jax.tree.map(jnp.asarray, ...)` of the numpy copy kept
    here)."""
    out = {}
    for name, kw in CONFIGS.items():
        jc, jd, js = _jax_setup(plane_geometry, **kw)
        tc, td = problem_from_reference(jc, _to_numpy(jd))
        js = _to_numpy(js)
        ts = state_from_reference(js)
        out[name] = (jc, jd, js, tc, td, ts)
    return out


def _fresh(js):
    return jax.tree.map(jnp.asarray, js)


def _rel(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    port, ref = port.astype(np.float64), np.asarray(ref, dtype=np.float64)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_build_problem_matches_reference(setups, plane_geometry, name):
    """The port's own build_problem gives exactly the arrays the reference
    builds (carried over by convert.py); the port also builds the window
    operator on the f32 CG path, which JAX builds only on a TPU."""
    jc, _, _, tc, td, _ = setups[name]
    kw = dict(CONFIGS[name])
    pc, pd, _ = t_problem.build_problem(N_TIME, plane_geometry, device="cpu", **kw)
    assert pc == tc
    assert pc.phi_refine == (name == "cg_f32")
    for field in ("ops", "spectral", "cg_op"):
        a, b = getattr(pd, field), getattr(td, field)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        for leaf in a._fields:
            x, y = getattr(a, leaf), getattr(b, leaf)
            if leaf == "window":
                assert (x is not None) == (name == "cg_f32")
                assert y is None
                continue
            assert (x is None) == (y is None), leaf
            if x is not None:
                np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=leaf)
                assert x.dtype == y.dtype, leaf
    for leaf in pd._fields[3:]:
        assert torch.equal(getattr(pd, leaf), getattr(td, leaf)), leaf


@pytest.mark.parametrize("name", ["cg_f64", "spectral_f64"])
def test_sixty_iterations_match_reference(setups, name):
    """60 iterations from the same f64 state: every state array within 1e-8
    relative of JAX's run_chunk, and the (7, 2) KKT tables within 1e-8."""
    jc, jd, js, tc, td, ts = setups[name]
    ts = t_step.run_chunk(tc, td, ts, 60)
    js = j_step.run_chunk(jc, jd, _fresh(js), np.int32(60))
    for field in ts._fields:
        assert _rel(getattr(ts, field), getattr(js, field)) <= 1e-8, field
    np.testing.assert_allclose(
        t_kkt(tc, td, ts).numpy(), np.asarray(j_kkt(jc, jd, js)), rtol=1e-8, atol=1e-14
    )


def test_f32_production_path_matches_reference(setups, plane_geometry):
    """10 iterations of the f32 CG path with f64 refinement (port: its own
    problem, whose inner matvec is the window SpMV, plain version; JAX:
    ELL). Bound 1e-4 relative, measured 6.8e-6 (dt_phi, the worst field):
    the f32 inner CG sums in another order (window vs ELL), so the two
    refined solves stop at different points inside the cg_rtol=1e-6 band,
    and the f32 iteration carries the difference. KKT entries at f32 noise
    level (~1e-7, the congestion row) get atol 1e-7."""
    jc, jd, js, _, _, ts = setups["cg_f32"]
    tc, td, _ = t_problem.build_problem(N_TIME, plane_geometry, device="cpu", **CONFIGS["cg_f32"])
    assert tc.phi_refine and td.cg_op.window is not None
    ts = t_step.run_chunk(tc, td, ts, 10)
    js = j_step.run_chunk(jc, jd, _fresh(js), np.int32(10))
    assert ts.phi.dtype == torch.float64
    worst = max(_rel(getattr(ts, f), getattr(js, f)) for f in ts._fields)
    assert worst <= 1e-4, worst
    np.testing.assert_allclose(
        t_kkt(tc, td, ts).numpy(), np.asarray(j_kkt(jc, jd, js)), rtol=1e-4, atol=1e-7
    )


def test_adaptive_segment_decisions_match_reference(setups):
    """run_chunk_adaptive: the same validations (iteration offsets), sigma
    adjustments and factors, stop point and header as the reference's
    device-resident segment; KKT tables within 1e-8."""
    jc, jd, js, tc, td, ts = setups["spectral_f64"]
    aux = np.asarray([-1.0, 0.0, 1e-3, -np.inf, -np.inf])
    _, packed_t = t_step.run_chunk_adaptive(tc, td, ts, 0, 150, 1, aux, 32)
    _, packed_j = j_step.run_chunk_adaptive(
        jc, jd, _fresh(js), np.int32(0), np.int32(150), np.int32(1), aux, 32
    )
    packed_j = np.asarray(packed_j)
    hdr = j_step.ADAPTIVE_HEADER
    np.testing.assert_array_equal(packed_t[:hdr], packed_j[:hdr])
    n = int(packed_t[0])
    assert n >= 5
    rec_t = packed_t[hdr:].reshape(32, -1)
    rec_j = packed_j[hdr:].reshape(32, -1)
    np.testing.assert_array_equal(rec_t[:n, :3], rec_j[:n, :3])
    assert rec_t[:n, 1].sum() >= 3  # sigma adjustments happened
    np.testing.assert_allclose(rec_t[:n, 3:], rec_j[:n, 3:], rtol=1e-8, atol=1e-14)
    assert np.isnan(rec_t[n:]).all()


@pytest.mark.parametrize("mode", ["cg", "spectral"])
def test_full_solve_matches_reference(plane_geometry, mode):
    """solver() at ntime=7, tol=1e-3, f64: the same iteration count and
    validation points as JAX, and the transport cost within 1e-8 relative."""
    from dots_socp_torch.solver import solver as t_solver
    from dots_socp_tpu.solver import solver as j_solver

    kw = dict(tol=1e-3, nit=2000, time_limit=600, precision="float64", laplacian_mode=mode)
    sol_t, hist_t = t_solver(N_TIME, plane_geometry, device="cpu", **kw)
    sol_j, hist_j = j_solver(N_TIME, plane_geometry, **kw)
    np.testing.assert_array_equal(hist_t.kkt_iteration, hist_j.kkt_iteration)
    assert np.all(hist_t.get_current_kkt_errors() < 1e-3)
    cost_t = hist_t.history["Transportation cost"][-1]
    cost_j = hist_j.history["Transportation cost"][-1]
    assert abs(cost_t - cost_j) <= 1e-8 * abs(cost_j)
    assert sol_t["mu"].shape == sol_j["mu"].shape
    np.testing.assert_allclose(sol_t["mu"], sol_j["mu"], rtol=0, atol=1e-8 * np.abs(sol_j["mu"]).max())


@pytest.mark.parametrize(
    "options",
    [
        {"check_kkt_step_by_step": True, "nit": 40},
        {"tol_checkpoints": [1e-1, 1e-2]},
        {"congestion": 0.01},
        {"is_constant_scaling": True},
        {"is_palm": True},
        {"sigma_freeze_error": 2e-2},
    ],
    ids=["step_by_step", "checkpoints", "congestion", "constant_scaling", "palm", "sigma_freeze"],
)
def test_solver_options_match_reference(plane_geometry, options):
    """The host loop's other paths (per-iteration validation, tolerance
    checkpoints, congestion, constant scaling, PALM, the sigma freeze), f64
    spectral: the same validation points and KKT history as JAX (1e-8
    relative), and the same checkpoint iterations."""
    from dots_socp_torch.solver import solver_socp as t_solver
    from dots_socp_tpu.solver import solver_socp as j_solver

    kw = dict(tol=1e-3, nit=1500, time_limit=600, precision="float64", laplacian_mode="spectral")
    kw.update(options)
    sol_t, hist_t = t_solver(5, plane_geometry, device="cpu", **kw)
    sol_j, hist_j = j_solver(5, plane_geometry, **kw)
    np.testing.assert_array_equal(hist_t.kkt_iteration, hist_j.kkt_iteration)
    np.testing.assert_allclose(hist_t.kkt_errors, hist_j.kkt_errors, rtol=1e-8, atol=1e-13)
    for key in hist_j.history:
        np.testing.assert_allclose(hist_t.history[key], hist_j.history[key], rtol=1e-8)
    cps_t, cps_j = sol_t.get("checkpoints") or [], sol_j.get("checkpoints") or []
    assert [c["iteration"] for c in cps_t] == [c["iteration"] for c in cps_j]
    for ct, cj in zip(cps_t, cps_j):
        np.testing.assert_allclose(ct["mu"], cj["mu"], rtol=0, atol=1e-8 * np.abs(cj["mu"]).max())


def test_warm_start_matches_reference(plane_geometry):
    """init_solution: a warm start from a previous (real-sized) solution
    replays the JAX run."""
    from dots_socp_torch.solver import solver_socp as t_solver
    from dots_socp_tpu.solver import solver_socp as j_solver

    kw = dict(tol=1e-10, nit=30, time_limit=60, precision="float64", laplacian_mode="spectral")
    warm, _ = j_solver(5, plane_geometry, **kw)
    _, hist_t = t_solver(5, plane_geometry, device="cpu", init_solution=warm, **kw)
    _, hist_j = j_solver(5, plane_geometry, init_solution=warm, **kw)
    np.testing.assert_array_equal(hist_t.kkt_iteration, hist_j.kkt_iteration)
    np.testing.assert_allclose(hist_t.kkt_errors, hist_j.kkt_errors, rtol=1e-8, atol=1e-13)


def test_port_imports_no_jax():
    """The port's import graph (package, solver, kernel wrapper, CLI, the
    profiler, chip_smoke.py and the reference's jax-free interface the CLI
    drives) leaves jax unimported."""
    code = (
        "import sys\n"
        "import dots_socp_torch, dots_socp_torch.solver, dots_socp_torch.ops.window_spmv\n"
        "import dots_socp_torch.ops._build, dots_socp_torch.cli, dots_socp_torch.convert\n"
        "import dots_socp_torch.profile_slice, chip_smoke\n"
        "import dots_socp_tpu.interface\n"
        "from dots_socp_torch import solver\n"
        "assert callable(solver)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_cuda_request_without_cuda_raises(plane_geometry):
    """Asking for the card where there is none raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from dots_socp_torch.solver import solver

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_problem.build_problem(N_TIME, plane_geometry, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solver(N_TIME, plane_geometry, nit=5)  # device="cuda" is the default


def test_solver_rejects_unported_options(plane_geometry):
    from dots_socp_torch.solver import solver_socp

    for kw in ({"mesh": object()}, {"snapshot_path": "s.npz"}, {"profile_dir": "p"}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            solver_socp(N_TIME, plane_geometry, device="cpu", **kw)


def test_cli_runs_on_cpu_and_rejects_unported_flags(capsys):
    from dots_socp_torch import cli

    base = ["--example", "plane", "--n_space", "8", "--ntime", "4", "--nit", "30",
            "--tol", "1e-2", "--precision", "float64", "--device", "cpu"]
    solution, geometry, history = cli.main(base)
    assert solution["mu"].shape == (5, geometry["vertices"].shape[0])
    assert np.isfinite(history.kkt_errors).all()
    for extra in (["--mesh_shape", "2"], ["--profile_dir", "p"], ["--process_id", "0"]):
        with pytest.raises(SystemExit):
            cli.main(base + extra)
