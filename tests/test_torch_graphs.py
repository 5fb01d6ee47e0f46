"""The port's device-resident loops on the CPU: the latched CG of
`ops.laplacian.cg_solve`, run in blocks of k inner iterations, against the
JAX package's `lax.while_loop` (`dots_socp_tpu.ops.laplacian.cg_solve`,
its window kernel in interpret mode) and against the port's own host loop;
the static buffers of `ops.graphs` through `solver.step.run_chunk` and a
whole solve against the same solve without them; and the profiler tally of
`profile_slice`. On the CPU the buffers are written eagerly; on the card the
same segments are captured as CUDA graphs (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dots_socp_torch import cli
from dots_socp_torch.ops import graphs
from dots_socp_torch.ops import laplacian as tl
from dots_socp_torch.ops import mesh_ops as t_mesh
from dots_socp_torch.profile_slice import tally
from dots_socp_torch.solver import solver_socp
from dots_socp_torch.solver import step as t_step
from dots_socp_torch.solver.problem import build_problem, initial_state
from dots_socp_tpu.geometry.generators import generate_plane_mesh
from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
from dots_socp_tpu.ops import laplacian as jl
from dots_socp_tpu.ops import mesh_ops as j_mesh
from torch_rank_worker import one_thread

T = 5
BLOCKS = (1, 3, 8, 64)
# (refinement, window matvec): f64 refinement around the f32 inner CG on the
# window SpMV (the main path) or on the ELL gather; the plain CG in f32 on the
# window SpMV, or in f64 on the ELL gather.
PATHS = [(True, True), (True, False), (False, True), (False, False)]
PATH_IDS = ["refined-window", "refined-ell", "f32-window", "f64-ell"]
# Mean-removed |x - x_jax| (the solves agree up to the singular row's
# constant): test_torch_laplacian.py's bounds, 1e-6 where the inner CG runs
# in float32 (window SpMV summed in another order than the Pallas kernel),
# 1e-8 for the f64 CG.
X_TOL = {True: 1e-6, False: 1e-8}
RTOL = {(True, True): 1e-8, (True, False): 1e-8, (False, True): 1e-5, (False, False): 1e-8}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def problems():
    """Per path: the JAX and port operators on test_torch_laplacian.py's
    perturbed plane n7, a seeded right-hand side and warm start."""
    rng = np.random.default_rng(7)
    vertices, triangles, _ = generate_plane_mesh(n=7)
    vertices = vertices.copy()
    vertices[:, 2] = 0.03 * rng.standard_normal(vertices.shape[0])
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    av = np.asarray(j_mesh.build_surface_ops(vertices, triangles, dtype=jnp.float64).av)
    rhs = np.random.default_rng(34).standard_normal((T + 1, av.shape[0]))
    rhs -= rhs.mean()
    x0 = np.random.default_rng(33).standard_normal(rhs.shape)
    out = {}
    for refine, window in PATHS:
        f64 = refine or not window
        j_dt, t_dt, n_dt = ((jnp.float64, torch.float64, np.float64) if f64
                            else (jnp.float32, torch.float32, np.float32))
        kw = dict(deflation_k=8, spmv_tile_rows=64, refine=refine)
        jop = jl.build_cg_operator(T, 1.0 / T, av, lap, dtype=j_dt, use_pallas_spmv=window, **kw)
        top = tl.build_cg_operator(T, 1.0 / T, av, lap, dtype=t_dt, **kw)
        if not window:
            top = top._replace(window=None)
        assert (top.window is not None) == (jop.window is not None) == window
        out[refine, window] = dict(
            jops=j_mesh.build_surface_ops(vertices, triangles, dtype=j_dt), jop=jop,
            tops=t_mesh.build_surface_ops(vertices, triangles, dtype=t_dt), top=top,
            rhs=rhs.astype(n_dt), x0=x0.astype(n_dt), rtol=RTOL[refine, window],
        )
    return out


_JAX = {}


def _jax_solve(p, key, max_iters):
    """The JAX package's solve of a path (once per path and max_iters)."""
    if (key, max_iters) not in _JAX:
        x, it = jl.cg_solve(p["jops"], p["jop"], jnp.asarray(p["rhs"]), x0=jnp.asarray(p["x0"]),
                            max_iters=max_iters, rtol=p["rtol"], return_iters=True)
        _JAX[key, max_iters] = np.asarray(x), int(it)
    return _JAX[key, max_iters]


def _port_solve(p, max_iters, block, x0=None):
    """The port's blocked solve with `CG_BLOCK` = block."""
    before, tl.CG_BLOCK = tl.CG_BLOCK, block
    try:
        return tl.cg_solve(p["tops"], p["top"], torch.from_numpy(p["rhs"]),
                           x0=torch.from_numpy(p["x0"]) if x0 is None else x0,
                           max_iters=max_iters, rtol=p["rtol"], return_iters=True)
    finally:
        tl.CG_BLOCK = before


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("refine, window", PATHS, ids=PATH_IDS)
def test_blocked_cg_matches_reference(problems, refine, window, block):
    """The latched CG in blocks of `block` iterations: the JAX package's
    inner iteration count exactly (every refinement pass summed), and x
    within the bound of test_torch_laplacian.py."""
    p = problems[refine, window]
    ref, ref_iters = _jax_solve(p, (refine, window), 600)
    x, iters = _port_solve(p, 600, block)
    assert iters == ref_iters > 0
    diff = x.numpy() - ref
    assert np.abs(diff - diff.mean()).max() < X_TOL[refine or window]


@pytest.mark.parametrize("max_iters", [5, 600], ids=["max_iters_mid_block", "to_tolerance"])
@pytest.mark.parametrize("refine, window", PATHS, ids=PATH_IDS)
def test_blocked_cg_bit_equal_across_blocks(problems, refine, window, max_iters):
    """Every block length gives the same x, bit for bit, and the same count,
    as the host loop that reads its flag every iteration (the mesh path's);
    at max_iters 5 the limit falls inside a block of 3, 8 and 64 and the
    solve stops where the JAX package's while loop stops."""
    p = problems[refine, window]
    rtol = torch.as_tensor(p["rtol"], dtype=p["top"].u_time.dtype)
    x_host, it_host = tl._cg_solve_hosted(
        p["tops"], p["top"], torch.from_numpy(p["rhs"]), torch.from_numpy(p["x0"]),
        max_iters, rtol, None, None, None)
    _, ref_iters = _jax_solve(p, (refine, window), max_iters)
    assert it_host == ref_iters
    for block in BLOCKS:
        x, iters = _port_solve(p, max_iters, block)
        assert iters == it_host, block
        assert torch.equal(x, x_host), block
    if max_iters == 5:  # the limit stops the plain CG, and the refinement's passes
        assert it_host == 5 if not refine else 5 < it_host <= 5 * tl.MAX_REFINE


@pytest.mark.parametrize("refine, window", PATHS, ids=PATH_IDS)
def test_blocked_cg_from_a_converged_start(problems, refine, window):
    """Warm-started at its own answer, a solve needs no inner iteration: in
    the refinement the first pass's block then runs as no-ops (its gate,
    the f64 check, read with the block's flags) and leaves x as the host
    loop leaves it, bit for bit, for every block length."""
    p = problems[refine, window]
    rtol = torch.as_tensor(p["rtol"], dtype=p["top"].u_time.dtype)
    rhs = torch.from_numpy(p["rhs"])
    x_start, _ = tl._cg_solve_hosted(p["tops"], p["top"], rhs, torch.from_numpy(p["x0"]),
                                     600, rtol, None, None, None)
    x_host, it_host = tl._cg_solve_hosted(p["tops"], p["top"], rhs, x_start, 600, rtol,
                                          None, None, None)
    assert it_host == 0
    for block in BLOCKS:
        x, iters = _port_solve(p, 600, block, x0=x_start)
        assert iters == 0, block
        assert torch.equal(x, x_host), block


def _plane_n13(mode):
    geometry = cli.load_geometry("plane", 13)
    precision = "float32" if mode == "cg" else "float64"
    return geometry, dict(laplacian_mode=mode, precision=precision, device="cpu")


def _solve_legs(geometry, kw, snap):
    """A solve with sigma updates, the constant and z scaling events and
    two tolerance checkpoints, cut at iteration 60 by a snapshot and resumed
    to 120."""
    common = dict(tol=1e-12, tol_checkpoints=[0.05, 0.01], is_constant_scaling=True,
                  time_limit=600, snapshot_path=snap, **kw)
    first, _ = solver_socp(6, geometry, nit=60, **common)
    second, history = solver_socp(6, geometry, nit=120, **common)
    return first, second, history


@pytest.mark.parametrize("mode", ["cg", "spectral"])
def test_buffered_solve_equals_the_solve_without_buffers(mode, tmp_path, monkeypatch):
    """The public solve through `run_chunk`'s static buffers (the CG path:
    the segments before and after the phi solve and `cg_solve`'s own; the
    adaptive segment's validations, decided on the device) equals
    the same solve inside `graphs.eager()`, bit for bit: solutions,
    checkpoints, the resumed leg and the KKT history."""
    geometry, kw = _plane_n13(mode)
    ran = []
    real_run = graphs.Workspace.run
    monkeypatch.setattr(graphs.Workspace, "run",
                        lambda self, name, fn: ran.append(name) or real_run(self, name, fn))
    buffered = _solve_legs(geometry, kw, str(tmp_path / "a.npz"))
    segments = set(ran)
    ran.clear()
    with graphs.eager():
        plain = _solve_legs(geometry, kw, str(tmp_path / "b.npz"))
    expect = {"before", "after", "start", "init", "block", "finish", "result"} if mode == "cg" else {"iteration"}
    expect.add("validate")  # the adaptive segment's validations
    assert segments == expect
    assert not graphs._CACHE  # released with the solve
    for leg_b, leg_p in zip(buffered[:2], plain[:2]):
        for key in ("phi", "mu", "E", "A", "B", "z_mid", "beta_mid", "lambda_c"):
            np.testing.assert_array_equal(leg_b[key], leg_p[key], err_msg=key)
        assert len(leg_b["checkpoints"] or []) == len(leg_p["checkpoints"] or [])
        for cb, cp in zip(leg_b["checkpoints"] or [], leg_p["checkpoints"] or []):
            assert cb["iteration"] == cp["iteration"]
            np.testing.assert_array_equal(cb["mu"], cp["mu"])
            np.testing.assert_array_equal(cb["E"], cp["E"])
    assert buffered[0]["checkpoints"], "no tolerance checkpoint was crossed"
    np.testing.assert_array_equal(buffered[2].kkt_errors, plain[2].kkt_errors)
    np.testing.assert_array_equal(buffered[2].kkt_iteration, plain[2].kkt_iteration)


@pytest.mark.parametrize("mode", ["cg", "spectral"])
def test_run_chunk_hands_out_copies(mode):
    """`run_chunk` copies the state in and out: a returned state is not
    overwritten by the next chunk, and the chunks equal the eager ones."""
    geometry, kw = _plane_n13(mode)
    config, data, extras = build_problem(6, geometry, laplacian_mode=mode,
                                         dtype=kw["precision"], cg_rtol=1e-4, device="cpu")
    state = initial_state(config, data, extras)
    first = t_step.run_chunk(config, data, state, 3)
    kept = [t.clone() for t in first]
    second = t_step.run_chunk(config, data, first, 3)
    for name, a, b in zip(first._fields, first, kept):
        assert torch.equal(a, b), name
    with graphs.eager():
        e_first = t_step.run_chunk(config, data, state, 3)
        e_second = t_step.run_chunk(config, data, e_first, 3)
    for name, a, b in zip(second._fields, second, e_second):
        assert torch.equal(a, b), name
    runner = next(obj for obj, _ in graphs._CACHE.values()
                  if isinstance(obj, t_step._GraphedIteration))
    buffers = {t.data_ptr() for t in runner.ws.bufs.values()}
    assert not any(t.data_ptr() in buffers for t in second)
    graphs.release()


def test_workspace_writes_into_its_buffers():
    """On the CPU a segment runs eagerly and its values are copied into the
    same buffers (identity kept), inside `uncaptured()` too; `eager()`
    rebinds instead; a buffer on another device than the workspace's raises
    before the segment runs."""
    ws = graphs.Workspace("cpu")
    ws.load("x", torch.arange(4.0))
    buf = ws.bufs["x"]
    ws.run("double", lambda b: {"x": 2 * b["x"], "y": b["x"].sum()})
    assert ws.bufs["x"] is buf and torch.equal(buf, torch.tensor([0.0, 2, 4, 6]))
    assert float(ws.bufs["y"]) == 6.0  # every value from the buffers before the segment
    with graphs.uncaptured():
        ws.run("half", lambda b: {"x": b["x"] / 2})
    assert ws.bufs["x"] is buf and torch.equal(buf, torch.arange(4.0)) and graphs._CAPTURE
    ws.run("double", lambda b: {"x": 2 * b["x"]})
    with graphs.eager():
        ws.run("double", lambda b: {"x": 2 * b["x"]})
    assert ws.bufs["x"] is not buf and torch.equal(buf, torch.tensor([0.0, 2, 4, 6]))
    bad = graphs.Workspace("cpu")
    bad.load("x", torch.zeros(2))
    bad.bufs["w"] = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="meta"):
        bad.run("never", lambda b: pytest.fail("the segment ran"))
    with pytest.raises(ValueError, match="does not fit"):
        ws.load("x", torch.zeros(3))


def test_cache_keys_by_the_identity_of_what_segments_read():
    """`cached` makes one object per key and set of tensors, keeps those
    tensors alive, drops the least recently used past MAX_CACHED, and is
    bypassed inside `eager()`."""
    graphs.release()
    a, b = torch.zeros(2), torch.zeros(2)
    first = graphs.cached("k", object, (a,))
    assert graphs.cached("k", object, (a,)) is first
    assert graphs.cached("k", object, (b,)) is not first
    assert any(a is t for _, keep in graphs._CACHE.values() for t in keep)
    with graphs.eager():
        assert graphs.cached("k", object, (a,)) is not first
    for i in range(graphs.MAX_CACHED):
        graphs.cached(i, object)
    assert graphs.cached("k", object, (a,)) is not first
    graphs.release()
    assert not graphs._CACHE


def test_profile_tally_counts_host_launch_calls():
    """`profile_slice`'s tally: kernels and copies on the device, and the
    host's launch calls (an eager launch and a graph replay alike) beside
    its synchronisations."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(name, device, us=0.0):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(elapsed_us=lambda: us))

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [event("window_spmv_kernel", cuda, 10.0), event("elementwise_kernel", cuda, 2.0),
              event("Memcpy DtoH (Device -> Pageable)", cuda, 1.0),
              event("cudaLaunchKernel", cpu), event("cudaGraphLaunch", cpu),
              event("cuLaunchKernel", cpu), event("cudaLaunchKernelExC", cpu),
              event("cudaStreamSynchronize", cpu), event("aten::add", cpu)]
    counts, groups = tally(events)
    assert counts.pop("device_ms") == pytest.approx(0.013)
    assert counts == {"launches": 2, "host_launch_calls": 4, "host_syncs": 1, "dtoh_copies": 1}
    assert groups["window_spmv_B1"] == {"ms": pytest.approx(0.01), "launches": 1}


def test_chip_smoke_graphs_phase_needs_a_card(capsys):
    """`chip_smoke.py --phase graphs` fails at the device phase without a
    card, and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chip_smoke.main(["--phase", "graphs"])
    assert capsys.readouterr().out == ""
