"""Tests of the port that need an NVIDIA GPU: the CUDA window SpMV kernels
(B1, and B2 on every shard of a blocked problem) and the CG phi-solve and
solver on the card, each against the plain PyTorch version on the same
inputs, plus a 2-rank gloo sharded CG solve and a 2-rank sharded spectral
solve on one card, and a snapshot round trip on the card. They skip without
a card. The file imports neither jax nor the JAX package, so it runs where
only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from dots_socp_torch import kernel_checks
from dots_socp_torch.kernel_checks import CG_STEP_NAMES, cg_step_system
from dots_socp_torch.kernel_checks import plane_operators as _plane
from dots_socp_torch.ops import laplacian as tl
from dots_socp_torch.ops import mesh_ops as t_mesh
from dots_socp_torch.ops import sharded_window as tsw
from dots_socp_torch.ops import window_spmv as tw
from dots_socp_torch.parallel.partition import blocked_layout
from dots_socp_torch.geometry.surface import cotan_laplacian, triangle_quantities

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _kernels_recorded(fn):
    """The names of the CUDA kernels torch.profiler records while `fn()`
    runs, in the order it lists them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _widened(lap):
    """`lap` with two more symmetric off-diagonals: rows of 9 nonzeros, so
    the row width is not the mesh's 7 and the kernel takes its run-time loop
    over DP = 12 slots."""
    import scipy.sparse as sp

    v = lap.shape[0]
    extra = sp.diags([np.full(v - 3, 0.25), np.full(v - 3, 0.25)], [3, -3])
    return (lap + extra).tocsr()


@pytest.mark.parametrize("n, tile_rows, widen", [(7, 64, False), (24, None, False), (24, 96, True)])
def test_kernel_matches_plain_and_f64(n, tile_rows, widen):
    """The kernel equals the plain version on the card, and scipy's f64
    L @ x on the host, within 1e-5 max|y| (float32 rounding of L and x,
    FMA and summation order), for 8, 32, 40 and 128 modes (40 and 128: more
    than one mode group) and a single 1-D mode, at the mesh's row width
    (D = 7, the unrolled body) and at a wider one (the run-time loop); one
    counted launch per call."""
    _need_cuda()
    vertices, _, av, lap = _plane(n)
    if widen:
        lap = _widened(lap)
    tiles = tw.build_window_tiles(lap, tile_rows=tile_rows, coords=vertices)
    assert (tiles.meta["nnz_width"] == 7) != widen
    v = av.shape[0]
    op = tw.window_operator(tiles, av, np.ones((1, v)), av, np.zeros((v, 0)), device="cuda")
    rng = np.random.default_rng(5)
    for lanes in (8, 32, 40, 128, None):
        x = rng.standard_normal((lanes or 1, v)).astype(np.float32)
        xp = torch.from_numpy(np.ascontiguousarray(x[:, tiles.perm])).cuda()
        if lanes is None:
            xp = xp[0]
        before = tw.KERNEL_LAUNCHES
        y = tw.window_matvec(op, xp)
        torch.cuda.synchronize()
        assert tw.KERNEL_LAUNCHES == before + 1
        assert y.shape == xp.shape
        y_plain = tw.window_matvec_plain(op, xp)
        ref = (lap @ x.astype(np.float64).T).T
        scale = np.abs(ref).max()
        got = y.cpu().numpy().reshape(x.shape)[:, tiles.iperm]
        plain = y_plain.cpu().numpy().reshape(x.shape)[:, tiles.iperm]
        assert np.abs(got - plain).max() <= 1e-5 * scale
        assert np.abs(got - ref).max() <= 1e-5 * scale


def test_kernel_rejects_float64():
    _need_cuda()
    vertices, _, av, lap = _plane(7)
    tiles = tw.build_window_tiles(lap, tile_rows=64, coords=vertices)
    v = av.shape[0]
    op = tw.window_operator(tiles, av, np.ones((6, v)), av, np.zeros((v, 0)), device="cuda")
    with pytest.raises(TypeError):
        tw.window_matvec(op, torch.zeros((6, v), dtype=torch.float64, device="cuda"))


def test_kernel_rejects_what_it_cannot_read():
    """The kernel reads x modes-major in place: a non-contiguous x (a
    transposed view, a strided slice), a wrong last axis, more than 128
    modes and an operator on another device each raise, and launch nothing."""
    _need_cuda()
    vertices, _, av, lap = _plane(7)
    tiles = tw.build_window_tiles(lap, tile_rows=64, coords=vertices)
    v = av.shape[0]
    op = tw.window_operator(tiles, av, np.ones((6, v)), av, np.zeros((v, 0)), device="cuda")
    before = tw.KERNEL_LAUNCHES
    bad = [
        torch.zeros((v, 6), device="cuda").t(),
        torch.zeros((6, 2 * v), device="cuda")[:, ::2],
        torch.zeros((6, v + 1), device="cuda"),
        torch.zeros((129, v), device="cuda"),
    ]
    for x in bad:
        with pytest.raises(ValueError):
            tw.window_matvec(op, x)
    cpu_op = tw.window_operator(tiles, av, np.ones((6, v)), av, np.zeros((v, 0)), device="cpu")
    with pytest.raises(ValueError):
        tw.window_matvec(cpu_op, torch.zeros((6, v), device="cuda"))
    assert tw.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("dtype, lanes", kernel_checks.B1_CASES)
def test_b1_on_the_main_paths_n200_operator(dtype, lanes):
    """`kernel_checks.b1`: B1 (float32) and B1-f64 (float64) on plane n200's
    window operator at 32, 33 and 128 modes against the plain version, SciPy
    and (float64) the ELL gather; one launch and nothing else."""
    _need_cuda()
    kernel_checks.b1(dtype, lanes)


def test_k4_f64_is_bit_equal_to_the_f64_torch_route_over_a_solve():
    """`kernel_checks.k4_f64_latched`: K4-f64 bit for bit against the float64
    torch route after every latched step of plane n200's settled float64
    phi solve, with B1-f64's and K4-f64's launches counted, no float32
    kernel."""
    _need_cuda()
    kernel_checks.k4_f64_latched()


def test_graphed_f64_cg_solve_equals_eager():
    """A float64 cg_solve on plane n200 on the card (B1-f64 and K4-f64 in
    every inner iteration), its blocks CUDA graph replays, against the same
    solve inside `graphs.eager()` (the host loop, one flag read per
    iteration): x bit for bit, the same inner iteration count, all of them
    counted in `CG_COUNTERS.f64_fused_steps`, and no float32 kernel launched."""
    _need_cuda()
    from dots_socp_torch.ops import cg_step as k4
    from dots_socp_torch.ops import graphs

    vertices, triangles, av, lap = _plane(200)
    op = tl.build_cg_operator(31, 1.0 / 31, av, lap, dtype=torch.float64, deflation_k=16,
                              coords=vertices, device="cuda")
    assert op.window.vals.dtype == torch.float64
    ops = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64, device="cuda")
    rhs = np.random.default_rng(41).standard_normal((32, av.shape[0]))
    rhs = torch.from_numpy(rhs - rhs.mean()).cuda()
    f32_launches = (tw.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES)
    out = {}
    for name, ctx in (("graphed", contextlib.nullcontext()), ("eager", graphs.eager())):
        tl.CG_COUNTERS.reset()
        with ctx:
            x, iters = tl.cg_solve(ops, op, rhs, max_iters=2000, rtol=1e-8, return_iters=True)
        torch.cuda.synchronize()
        out[name] = (x.cpu(), iters, tl.CG_COUNTERS.f64_fused_steps)
    graphs.release()
    (xg, ig, fg), (xe, ie, fe) = out["graphed"], out["eager"]
    assert ig == ie > 0 and fg == ig and fe == ie
    assert torch.equal(xg, xe)
    assert (tw.KERNEL_LAUNCHES, k4.KERNEL_LAUNCHES) == f32_launches


def test_refined_cg_on_card_matches_cpu():
    """cg_solve with f64 refinement around the f32 inner CG: the card (the
    kernel) against the CPU (the plain version), same operator; the
    mean-removed difference within 1e-6 (the reference's bound for its
    window path), and every inner matvec launched the kernel."""
    _need_cuda()
    vertices, triangles, av, lap = _plane(24)
    T = 7
    kw = dict(dtype=torch.float64, deflation_k=16, refine=True, coords=vertices)
    ops_cpu = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64)
    ops_gpu = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64, device="cuda")
    op_cpu = tl.build_cg_operator(T, 1.0 / T, av, lap, **kw)
    op_gpu = tl.build_cg_operator(T, 1.0 / T, av, lap, device="cuda", **kw)
    rhs = np.random.default_rng(9).standard_normal((T + 1, av.shape[0]))
    rhs -= rhs.mean()
    x_cpu = tl.cg_solve(ops_cpu, op_cpu, torch.from_numpy(rhs), max_iters=600, rtol=1e-8)
    launches, matvecs = tw.KERNEL_LAUNCHES, tl.CG_COUNTERS.window_matvecs
    x_gpu = tl.cg_solve(ops_gpu, op_gpu, torch.from_numpy(rhs).cuda(), max_iters=600, rtol=1e-8)
    assert tw.KERNEL_LAUNCHES - launches == tl.CG_COUNTERS.window_matvecs - matvecs > 0
    diff = x_gpu.cpu().numpy() - x_cpu.numpy()
    assert np.abs(diff - diff.mean()).max() < 1e-6


def test_solver_on_card():
    """A short f32 CG solve on the card: finite KKT, launches counted."""
    _need_cuda()
    from dots_socp_torch.solver import solver

    vertices, triangles, av, _ = _plane(16)
    area_f, _, _ = triangle_quantities(vertices, triangles)
    mu = av / av.sum()
    geometry = dict(
        vertices=vertices, triangles=triangles, edges=None, mu0=mu, mu1=mu[::-1].copy(),
        area_triangles=area_f, area_vertices=3.0 * av,
    )
    before = tw.KERNEL_LAUNCHES
    _, history = solver(7, geometry, nit=50, tol=1e-4, laplacian_mode="cg", precision="float32")
    assert tw.KERNEL_LAUNCHES > before
    assert np.isfinite(history.kkt_errors).all()


def _blocked_window(n, n_parts, tile_rows=None, widen=False):
    """Plane n in n_parts blocked shards: the blocked Laplacian (scipy, f64)
    and the port's every-shard window operator on the card."""
    vertices, triangles, av, _ = _plane(n)
    v = vertices.shape[0]
    layout = blocked_layout(triangles, v, n_parts)
    _, angles, _ = triangle_quantities(vertices, triangles)
    v_pad = n_parts * layout.v_chunk
    lap = cotan_laplacian(layout.vertex_slot[triangles], angles, v_pad)
    if widen:
        lap = _widened(lap)
    av_p = np.full(v_pad, av.mean())
    av_p[layout.vertex_slot] = av
    host, _ = tsw.build_sharded_window(
        lap, layout.v_chunk, n_parts, av=av_p, jacobi=np.ones((1, v_pad)),
        s_vec=1.0 / np.sqrt(av_p), defl_q=np.zeros((v_pad, 0)), real=np.ones(v_pad),
        tile_rows=tile_rows,
    )
    return lap, tsw.sharded_window_to_torch(host, device="cuda")


@pytest.mark.parametrize("tile_rows, widen", [(None, False), (64, False), (128, True)])
def test_sharded_kernel_matches_plain_and_f64(tile_rows, widen):
    """B2 on every shard of plane n40 x 4 shards, for 8, 32, 33 (a second mode
    group with one live lane, as ntime 32 gives it) and 128 modes,
    at the mesh's row width and at a wider one: the kernel, which gathers
    its window from the shard's state and the export buffer, against its
    plain version on the window vector, and the shards assembled through the
    inverse window permute against scipy's f64 L @ x, each within 1e-5
    max|y|; one counted launch per shard-call."""
    _need_cuda()
    n_parts = 4
    lap, sw_all = _blocked_window(40, n_parts, tile_rows, widen)
    assert (sw_all.nnz_width == 7) != widen
    shards = [tsw.shard_of(sw_all, s) for s in range(n_parts)]
    v_chunk = shards[0].state_in.shape[0]
    for lanes in (8, 32, 33, 128):
        x = np.random.default_rng(6).standard_normal((lanes, lap.shape[0])).astype(np.float32)
        xs = [tsw.window_permute(sw, torch.from_numpy(x[:, s * v_chunk:(s + 1) * v_chunk]).cuda())
              for s, sw in enumerate(shards)]
        buf = torch.cat([xl[..., sw.exp_codes] for sw, xl in zip(shards, xs)], dim=-1)
        ref = (lap @ x.astype(np.float64).T).T
        scale = np.abs(ref).max()
        ys = []
        for sw, xl in zip(shards, xs):
            before = tsw.KERNEL_LAUNCHES
            y = tsw.shard_spmv(sw, xl, buf)
            torch.cuda.synchronize()
            assert tsw.KERNEL_LAUNCHES == before + 1
            plain = tsw.sharded_window_matvec_plain(sw, tsw.window_vector(sw, xl, buf))
            assert (y - plain).abs().max().item() <= 1e-5 * scale
            ys.append(tsw.window_permute(sw, y, inverse=True).cpu().numpy())
        assert np.abs(np.concatenate(ys, axis=-1) - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("shards, lanes", kernel_checks.B2_CASES)
def test_b2_on_the_main_paths_n200_shards(shards, lanes):
    """`kernel_checks.b2`: B2 on every shard of plane n200 blocked in 2 and 4
    shards at 32 modes and 2 at 33, against the plain version and, the
    shards assembled, SciPy; one launch and nothing else per shard-call."""
    _need_cuda()
    kernel_checks.b2(shards, lanes)


def test_sharded_kernel_rejects_what_it_cannot_read():
    """B2 takes contiguous float32 state and export buffer with the same
    leading modes, and one shard's operator: anything else raises."""
    _need_cuda()
    _, sw_all = _blocked_window(16, 2)
    sw = tsw.shard_of(sw_all, 0)
    v_chunk, n_buf = sw.state_in.shape[0], sw_all.exp_codes.numel()
    x = torch.zeros((8, v_chunk), device="cuda")
    buf = torch.zeros((8, n_buf), device="cuda")
    before = tsw.KERNEL_LAUNCHES
    with pytest.raises(TypeError):
        tsw.shard_spmv(sw, x.double(), buf.double())
    for bad_x, bad_buf in [
        (torch.zeros((v_chunk, 8), device="cuda").t(), buf),
        (x, torch.zeros((n_buf, 8), device="cuda").t()),
        (x, buf[:4]),
        (x, buf.cpu()),
    ]:
        with pytest.raises(ValueError):
            tsw.shard_spmv(sw, bad_x, bad_buf)
    with pytest.raises(ValueError):
        tsw.shard_spmv(sw_all, x, buf)  # every shard's arrays, not one shard's
    assert tsw.KERNEL_LAUNCHES == before
    tsw.shard_spmv(sw, x, buf)
    assert tsw.KERNEL_LAUNCHES == before + 1


def test_two_rank_gloo_cg_on_card(tmp_path):
    """The refined CG of a 1x2 mesh, both gloo ranks on this card: every
    inner matvec of each rank launched B2, and the solution agrees with the
    single-device port's refined CG (on the card, B1) within 1e-5."""
    _need_cuda()
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.solver.problem import build_problem
    from torch_rank_worker import geometry_inputs, run_ranks

    n_time = 6
    geometry = load_geometry("plane", 40)
    kw = dict(dtype="float32", laplacian_mode="cg", cg_deflation_k=16, cg_rtol=1e-7, phi_refine="on")
    config, _, extras = build_problem(n_time, geometry, space_partitions=2, device="cpu", **kw)
    rng = np.random.default_rng(3)
    rhs_real = rng.standard_normal((n_time + 1, geometry["vertices"].shape[0]))
    rhs_real -= rhs_real.mean(axis=1, keepdims=True)
    rhs = np.zeros((n_time + 1, config.n_vertices), np.float32)
    rhs[:, extras["vertex_slot"]] = rhs_real
    x = np.zeros_like(rhs)
    ranks = run_ranks(tmp_path, "window", 2, dict(geometry_inputs(geometry), n_time=n_time,
                                                 x=x, rhs=rhs), device="cuda")
    for r in ranks:
        assert r["cg_b2_launches"] == r["cg_window_matvecs"] > r["cg_iters"] > 0
        assert r["cg_strided_matvecs"] == 0
    x_s = np.concatenate([r["cg_x"] for r in ranks], axis=-1)[:, extras["vertex_slot"]]
    cfg_u, data_u, ex_u = build_problem(n_time, geometry, device="cuda", **kw)
    rhs_u = np.zeros((n_time + 1, cfg_u.n_vertices), np.float32)
    rhs_u[:, ex_u["vertex_slot"]] = rhs_real
    x_u = tl.cg_solve(data_u.ops, data_u.cg_op, torch.from_numpy(rhs_u).cuda(), max_iters=2000)
    x_u = x_u.cpu().numpy()[:, ex_u["vertex_slot"]]
    assert np.abs(x_u - x_s).max() <= 1e-5 * np.abs(x_u).max()


def _mesh_loops_on_card(tmp_path, backend):
    """20 iterations of plane n24 (ntime 6, float32, CG with f64 refinement
    around the f32 inner CG, B2 in every inner matvec) on a 1x2 mesh over
    `backend`, both ranks on the card(s): the worker's `loops` task, the
    mesh loops then `graphs.eager()`. phi, mu, E and the run history are
    bit-equal between the two on every rank, and the same on both ranks;
    B2's launches (counted through replays) equal the window matvecs."""
    from dots_socp_torch.cli import load_geometry
    from torch_rank_worker import geometry_inputs, run_ranks

    kw = dict(nit=20, tol=1e-12, time_limit=300, precision="float32", laplacian_mode="cg",
              cg_rtol=1e-5)
    inputs = dict(geometry_inputs(load_geometry("plane", 24)), n_time=6, kw_device="cuda",
                  **{f"kw_{k}": v for k, v in kw.items()})
    ranks = run_ranks(tmp_path, "loops", 2, inputs, device="cuda", backend=backend)
    for out in ranks:
        for key in ("phi", "mu", "E", "kkt_iteration", "kkt_errors", "inner"):
            np.testing.assert_array_equal(out[f"loops_{key}"], out[f"eager_{key}"], err_msg=key)
        for mode in ("loops", "eager"):
            assert int(out[f"{mode}_b2_launches"]) == int(out[f"{mode}_window_matvecs"]) > 0
        assert int(out["eager_captures"]) == 0
        np.testing.assert_array_equal(out["loops_phi"], ranks[0]["loops_phi"])
    return ranks


def test_mesh_loops_over_gloo_on_one_card_equal_eager(tmp_path):
    """Over gloo (both ranks on one card) nothing is captured: the mesh
    loops run every segment op by op, and equal the host loops bit for
    bit."""
    _need_cuda()
    for out in _mesh_loops_on_card(tmp_path, "gloo"):
        assert not out["capturable"]
        assert int(out["loops_captures"]) == 0 and int(out["loops_uncaptured_runs"]) > 0


def test_mesh_loops_over_nccl_are_captured_and_equal_eager(tmp_path):
    """Over nccl (a card per rank) every segment of the mesh loops is a CUDA
    graph replay with its collectives inside, and the captured solve equals
    the host loops bit for bit. Needs two cards."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    for out in _mesh_loops_on_card(tmp_path, "nccl"):
        assert out["capturable"]
        assert int(out["loops_captures"]) > 0 and int(out["loops_uncaptured_runs"]) == 0


@pytest.mark.parametrize("name", ["space_any", "rank0_decides"])
def test_capture_reaching_a_host_side_collective_raises(name):
    """A segment that reaches a collective read on the host raises before
    the capture holds it; the workspace keeps no graph and its buffers."""
    _need_cuda()
    from dots_socp_torch.ops import collectives, graphs

    calls = {"space_any": lambda x: collectives.space_any(x > 0, None),
             "rank0_decides": lambda x: collectives.rank0_decides(True, None)}
    x = torch.arange(4.0, device="cuda")
    ws = graphs.Workspace(x.device)
    ws.load("x", x)
    with pytest.raises(RuntimeError, match=f"{name} reads the host"):
        ws.run("host_side", lambda b: {"x": b["x"] * float(calls[name](b["x"]))})
    torch.cuda.synchronize()
    assert torch.equal(ws.bufs["x"], x) and not ws._graphs


def test_four_rank_gloo_time_sharded_iterations_on_card(tmp_path):
    """10 iterations on a 2x2 mesh (two time blocks x two space shards), all
    four gloo ranks on this card: f64 state, f64 refinement to 1e-12 around
    the f32 inner CG. Every inner matvec of every rank launched B2, phi and
    every other gathered field are bit-equal on the four ranks, and the
    state agrees with the same ranks on the CPU (B2's plain version) within
    1e-8 of each field's largest entry."""
    _need_cuda()
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.solver.state import SolverState
    from torch_rank_worker import geometry_inputs, run_ranks

    kw = dict(dtype="float64", laplacian_mode="cg", cg_deflation_k=16, cg_rtol=1e-12,
              phi_refine="on")
    inputs = dict(geometry_inputs(load_geometry("plane", 24)), n_time=6, iterations=10,
                  **{f"kw_{k}": v for k, v in kw.items()})
    runs = {}
    for device in ("cuda", "cpu"):
        (tmp_path / device).mkdir()
        runs[device] = run_ranks(tmp_path / device, "chunk", 4, inputs, device=device,
                                 mesh_shape="2x2")
    for out in runs["cuda"]:
        assert out["b2_launches"] == out["window_matvecs"] > 0
        for name in SolverState._fields:
            np.testing.assert_array_equal(out[f"st_{name}"], runs["cuda"][0][f"st_{name}"], name)
    for name in SolverState._fields:
        got, ref = runs["cuda"][0][f"st_{name}"], runs["cpu"][0][f"st_{name}"]
        assert np.abs(got - ref).max() <= 1e-8 * max(np.abs(ref).max(), 1e-300), name


def _solver_geometry(n):
    vertices, triangles, av, _ = _plane(n)
    area_f, _, _ = triangle_quantities(vertices, triangles)
    mu = av / av.sum()
    return dict(
        vertices=vertices, triangles=triangles, edges=None, mu0=mu, mu1=mu[::-1].copy(),
        area_triangles=area_f, area_vertices=3.0 * av,
    )


def test_snapshot_round_trip_on_card(tmp_path):
    """A snapshot written by a solve on the card (f32 CG with f64
    refinement): the file holds phi in float64; `state_from_arrays` puts
    every tensor back on the card in the run dtype, phi in float64; saving
    that state again gives the same arrays bit for bit; and a run resumed
    from it (10 -> 20 iterations) equals the uninterrupted 20 on the card
    within 1e-6 relative."""
    _need_cuda()
    from dots_socp_torch.solver import solver_socp
    from dots_socp_torch.utils import snapshot

    geometry = _solver_geometry(16)
    kw = dict(tol=1e-12, laplacian_mode="cg", precision="float32")
    snap = str(tmp_path / "state.npz")
    solver_socp(7, geometry, nit=10, snapshot_path=snap, **kw)
    arrays, meta = snapshot.load_snapshot(snap)
    assert arrays["phi"].dtype == np.float64 and arrays["mu"].dtype == np.float32
    assert meta["iteration"] == 9 and meta["cg_rtol"] > 0
    state = snapshot.state_from_arrays(arrays, torch.float32, phi_dtype=torch.float64, device="cuda")
    for name, t in zip(state._fields, state):
        assert t.device.type == "cuda", name
        assert t.dtype == (torch.float64 if name == "phi" else torch.float32), name
    again = str(tmp_path / "again.npz")
    snapshot.save_snapshot(again, state, meta)
    arrays_again, meta_again = snapshot.load_snapshot(again)
    assert meta_again == meta
    for name in arrays:
        np.testing.assert_array_equal(arrays_again[name], arrays[name], err_msg=name)
    full, _ = solver_socp(7, geometry, nit=20, **kw)
    resumed, history = solver_socp(7, geometry, nit=20, snapshot_path=snap, **kw)
    assert np.nanmin(history.kkt_iteration) >= 10
    for key in ("mu", "phi", "E"):
        off = np.abs(resumed[key] - full[key]).max() / np.abs(full[key]).max()
        assert off <= 1e-6, (key, off)


def test_two_rank_gloo_spectral_solve_on_card(tmp_path):
    """The sharded spectral path on a 1x2 mesh, both gloo ranks on this
    card, float32: 30 iterations agree with the single-device solve on the
    card within 1e-4 max|.| (the shards' partial eigen-coefficients sum in
    another order than one GEMM; measured on an H100: mu 7.2e-7, phi 2.7e-6,
    E 2.3e-5; TF32 would be ~1e-3 off per solve), and no rank took the CG
    path."""
    _need_cuda()
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.solver import solver_socp
    from torch_rank_worker import geometry_inputs, run_ranks

    n_time = 6
    geometry = load_geometry("plane", 24)
    kw = dict(nit=30, tol=1e-12, time_limit=300, precision="float32")
    inputs = dict(geometry_inputs(geometry), n_time=n_time, **{f"kw_{k}": v for k, v in kw.items()})
    rank0, rank1 = run_ranks(tmp_path, "solve", 2, inputs, device="cuda")
    before = tl.CG_COUNTERS.solves
    single, history = solver_socp(n_time, geometry, **kw)
    assert tl.CG_COUNTERS.solves == before  # the spectral path
    np.testing.assert_array_equal(rank0["kkt_iteration"], history.kkt_iteration)
    for key in ("mu", "E", "phi"):
        np.testing.assert_array_equal(rank0[key], rank1[key])
        off = np.abs(rank0[key] - single[key]).max() / np.abs(single[key]).max()
        print(f"sharded spectral vs single device, {key}: {off:.3e}")
        assert off <= 1e-4, (key, off)


def test_spectral_solve_on_card_holds_the_host_accuracy():
    """knots_3, padded to 4,096 vertices as the `make main` sweep pads it,
    ntime 31: the card's float32 spectral solve against float64, in the
    energy norm, within 1.25x of the host's float32 error (one library GEMM
    over all of K, the port before the chains, read 2.5-3.7x); and the
    solve allocates no copy of q (its blocks are views)."""
    _need_cuda()
    from dots_socp_torch.scripts import spectral_floor

    out = spectral_floor.main(["--examples", "knots_3", "--variants", "long", "--rhs", "2",
                               "--device", "cuda"])
    ratios = out["energy_device_over_host_blas"]["knots_3"]
    print(f"card over host, energy norm: {ratios}; same code on both: "
          f"{out['energy_device_over_cpu_f32']['knots_3']}")
    assert all(r <= 1.25 for r in ratios.values()), ratios

    v, m = 4096, 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    factor = tl.SpectralFactor(
        u_time=torch.linalg.qr(torch.randn(m, m, device="cuda", generator=gen))[0],
        s=torch.rand(v, device="cuda", generator=gen) + 0.5,
        q=torch.linalg.qr(torch.randn(v, v, device="cuda", generator=gen))[0],
        invfac=torch.randn(m, v, device="cuda", generator=gen))
    rhs = torch.randn(m, v, device="cuda", generator=gen)
    tl.spectral_solve(factor, rhs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tl.spectral_solve(factor, rhs)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < factor.q.numel() * 4 // 4, extra


def _spectral_problem(n, iterations):
    """Plane n on the card (float32, spectral path, ntime 7) and its state
    after `iterations` eager iterations."""
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.solver import step
    from dots_socp_torch.solver.problem import build_problem, initial_state

    config, data, extras = build_problem(7, load_geometry("plane", n), laplacian_mode="spectral",
                                         dtype="float32", device="cuda")
    with graphs.eager():
        state = step.run_chunk(config, data, initial_state(config, data, extras), iterations)
    return config, data, state


def test_graphed_spectral_iteration_equals_eager():
    """The spectral iteration as one CUDA graph replay per iteration: 5
    replays give the state of 5 eager iterations bit for bit (the same
    kernels on the same inputs; cuBLAS picks the same algorithms under
    capture), twice in a row through the cached graph."""
    _need_cuda()
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.solver import step

    config, data, state = _spectral_problem(24, 3)
    graphed = state
    for _ in range(2):
        with graphs.eager():
            state = step.run_chunk(config, data, state, 5)
        graphed = step.run_chunk(config, data, graphed, 5)
        for name, a, b in zip(state._fields, graphed, state):
            assert torch.equal(a, b), name
    graphs.release()


def test_graphed_cg_blocks_equal_eager_and_count_each_replay():
    """cg_solve (f64 refinement around the f32 inner CG on kernel B1) with
    its segments captured: x and the inner count equal the eager host
    loop's bit for bit, and once captured, B1's launches counted through
    the replays equal the launches of the same blocked loop run op by op
    (`graphs.uncaptured()`) and the window matvecs; the blocks' no-op
    iterations launch B1 too, so at least as often as the host loop."""
    _need_cuda()
    from dots_socp_torch.ops import graphs

    vertices, triangles, av, lap = _plane(24)
    T = 7
    ops = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64, device="cuda")
    op = tl.build_cg_operator(T, 1.0 / T, av, lap, dtype=torch.float64, deflation_k=16,
                              refine=True, coords=vertices, device="cuda")
    rhs = np.random.default_rng(9).standard_normal((T + 1, av.shape[0]))
    rhs = torch.from_numpy(rhs - rhs.mean()).cuda()
    kw = dict(max_iters=600, rtol=1e-8, return_iters=True)

    def counted(fn):
        launches, matvecs = tw.KERNEL_LAUNCHES, tl.CG_COUNTERS.window_matvecs
        x, iters = fn()
        torch.cuda.synchronize()
        return x, iters, tw.KERNEL_LAUNCHES - launches, tl.CG_COUNTERS.window_matvecs - matvecs

    with graphs.eager():
        x_e, it_e, launches_e, matvecs_e = counted(lambda: tl.cg_solve(ops, op, rhs, **kw))
    with graphs.uncaptured():
        x_u, it_u, launches_u, matvecs_u = counted(lambda: tl.cg_solve(ops, op, rhs, **kw))
    tl.cg_solve(ops, op, rhs, **kw)  # warm-up and capture
    x_g, it_g, launches_g, matvecs_g = counted(lambda: tl.cg_solve(ops, op, rhs, **kw))
    assert it_g == it_u == it_e > 0
    assert torch.equal(x_g, x_e) and torch.equal(x_u, x_e)
    assert launches_g == launches_u == matvecs_g == matvecs_u
    assert launches_u >= launches_e == matvecs_e > it_e
    graphs.release()


def test_capture_of_a_wrong_segment_raises_and_runs_nothing():
    """On the card a segment is captured or the call raises: a segment that
    reads a value on the host cannot be captured (the capture raises, the
    buffers keep their values and no graph is kept), and a buffer on
    another device is refused before anything runs."""
    _need_cuda()
    from dots_socp_torch.ops import graphs

    x = torch.arange(4.0, device="cuda")
    ws = graphs.Workspace(x.device)
    ws.load("x", x)
    with pytest.raises(RuntimeError):
        ws.run("host_read", lambda b: {"x": b["x"] * float(b["x"].sum())})
    torch.cuda.synchronize()
    assert torch.equal(ws.bufs["x"], x) and not ws._graphs
    ws.bufs["cpu"] = torch.zeros(2)
    with pytest.raises(ValueError, match="cpu"):
        ws.run("double", lambda b: {"x": 2 * b["x"]})
    assert torch.equal(ws.bufs["x"], x)


def _adaptive_problem(n):
    """Plane n on the card (float32, ntime 31): n64 on the spectral path,
    n200 on the CG path (inner rtol 5e-4), and its initial state."""
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.solver.problem import build_problem, initial_state

    mode = "cg" if n == 200 else "spectral"
    config, data, extras = build_problem(31, load_geometry("plane", n), laplacian_mode=mode,
                                         dtype="float32", cg_rtol=5e-4, device="cuda")
    return config, data, initial_state(config, data, extras)


@pytest.mark.parametrize("n", [64, 200])
def test_graphed_adaptive_segment_equals_eager(n):
    """The adaptive segment with its validations captured (`validate`, one
    replay each; the state in the workspace for the whole segment) against
    the same segment inside `graphs.eager()`, on plane n64 (spectral) and
    n200 (CG): the packed records and every state array bit for bit, the
    first call (captures) and the second (replays) alike, and one host read
    per validation plus one of the records."""
    _need_cuda()
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.solver import step

    config, data, state = _adaptive_problem(n)
    args = (0, 120, 1, np.asarray([-1.0, 0.0, 1e-3, -np.inf, -np.inf]), 64)
    with graphs.eager():
        state_e, packed_e = step.run_chunk_adaptive(config, data, state, *args)
    for _ in range(2):
        reads = graphs.HOST_READS
        state_g, packed_g = step.run_chunk_adaptive(config, data, state, *args)
        assert graphs.HOST_READS - reads == int(packed_g[0]) + 1
        np.testing.assert_array_equal(packed_g, packed_e)
        for name, a, b in zip(state_g._fields, state_g, state_e):
            assert torch.equal(a, b), name
    assert int(packed_g[0]) >= 10 and packed_g[4 + 1::step.ADAPTIVE_REC_SIZE][:10].sum() >= 3
    graphs.release()


def test_validate_segment_launches_the_same_kernels_as_its_replay():
    """Under `graphs.uncaptured()` the `validate` segment launches, op by op,
    the kernels and copies that its CUDA graph replays (the same names, as
    many of each), and both write the same flags."""
    _need_cuda()
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.solver import step

    config, data, state = _adaptive_problem(64)
    aux = np.asarray([-1.0, 0.0, 1e-3, -np.inf, -np.inf])
    runner = step._runner(config, data, state)

    def validate():
        runner.load(state)
        runner.load_segment(step.segment_scalars(config, 0, 50, 1, aux, 8))
        names = sorted(_kernels_recorded(
            lambda: runner.run("validate", lambda b: step._validate(config, data, b, 8))))
        return names, runner.bufs["flags"].tolist()

    with graphs.uncaptured():
        validate()  # the constant tables, cuBLAS and the allocator warmed
        eager_names, eager_flags = validate()
    validate()  # warm-up and capture
    replay_names, replay_flags = validate()
    assert eager_names and replay_names == eager_names
    assert replay_flags == eager_flags
    graphs.release()


# ---- kernel K4: the fused inner CG iteration (ops/cg_step.py) ---------------

@pytest.mark.parametrize("n, deflation_k", [
    (7, 16), (24, 16), (7, 0), (24, 0), (200, None)],
    ids=["deflated-7", "deflated-24", "jacobi_only-7", "jacobi_only-24", "main_path-200"])
def test_cg_step_kernel_matches_plain(n, deflation_k):
    """K4 against its plain version on the same inputs, on small planes
    with and without deflation and on the main path's own inputs (plane
    n200's settled inner state, 32 modes, deflation rank 181): every
    stage's outputs and every output within 1e-5 max|.|, the frozen and
    den = 0 rows hold still, STAGES launches per call, live false keeps
    every bit, two launches bit-equal (`kernel_checks.k4`)."""
    _need_cuda()
    kernel_checks.k4(n, deflation_k)


def test_cg_step_kernel_rejects_what_it_cannot_read():
    """Float64, a non-contiguous state and a state on another device raise
    before any launch."""
    _need_cuda()
    from dots_socp_torch.ops import cg_step as k4

    cg, st, thresh = cg_step_system(7, 16)
    ins = tuple(st[k] for k in CG_STEP_NAMES)
    lap = tw.window_matvec(cg.wop, st["p"])
    before = k4.KERNEL_LAUNCHES
    with pytest.raises(TypeError):
        k4.cg_step(lap.double(), *ins, thresh, 600, cg.leaves)
    with pytest.raises(ValueError):
        k4.cg_step(lap, ins[0].t().contiguous().t(), *ins[1:], thresh, 600, cg.leaves)
    with pytest.raises(ValueError):
        k4.cg_step(lap, *ins[:5], ins[5].cpu(), ins[6], thresh, 600, cg.leaves)
    assert k4.KERNEL_LAUNCHES == before


def test_graphed_cg_with_k4_counts_each_replay():
    """cg_solve on K4's route with its segments captured: x and the inner
    count equal the eager host loop's (K4 too) bit for bit and the op-by-op
    blocks' (`graphs.uncaptured()`); K4's launches counted through the
    replays equal the op-by-op blocks' and STAGES per fused inner
    iteration; inside `cg_step.torch_route()` nothing launches K4 and x
    agrees to the solve's tolerance."""
    _need_cuda()
    from dots_socp_torch.ops import cg_step as k4
    from dots_socp_torch.ops import graphs

    vertices, triangles, av, lap = _plane(24)
    T = 7
    ops = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64, device="cuda")
    op = tl.build_cg_operator(T, 1.0 / T, av, lap, dtype=torch.float64, deflation_k=16,
                              refine=True, coords=vertices, device="cuda")
    rhs = np.random.default_rng(9).standard_normal((T + 1, av.shape[0]))
    rhs = torch.from_numpy(rhs - rhs.mean()).cuda()
    kw = dict(max_iters=600, rtol=1e-8, return_iters=True)

    def counted(fn):
        launches, steps = k4.KERNEL_LAUNCHES, tl.CG_COUNTERS.fused_steps
        x, iters = fn()
        torch.cuda.synchronize()
        return x, iters, k4.KERNEL_LAUNCHES - launches, tl.CG_COUNTERS.fused_steps - steps

    with graphs.eager():
        x_e, it_e, launches_e, steps_e = counted(lambda: tl.cg_solve(ops, op, rhs, **kw))
    with graphs.uncaptured():
        x_u, it_u, launches_u, steps_u = counted(lambda: tl.cg_solve(ops, op, rhs, **kw))
    tl.cg_solve(ops, op, rhs, **kw)  # warm-up and capture
    x_g, it_g, launches_g, steps_g = counted(lambda: tl.cg_solve(ops, op, rhs, **kw))
    with k4.torch_route():
        x_t, it_t, launches_t, _ = counted(lambda: tl.cg_solve(ops, op, rhs, **kw))
    assert it_g == it_u == it_e > 0 and it_t > 0
    assert torch.equal(x_g, x_e) and torch.equal(x_u, x_e)
    assert float((x_t - x_e).abs().max()) <= 1e-6 * float(x_e.abs().max())
    assert launches_g == launches_u == k4.STAGES * steps_g and steps_g == steps_u
    assert launches_e == k4.STAGES * steps_e == k4.STAGES * it_e and launches_t == 0
    graphs.release()


def test_graphed_n200_solve_with_k4_equals_eager():
    """Plane n200 (float32, ntime 31, the CG path with refinement), 30
    iterations with CUDA graphs and inside `graphs.eager()`, K4 in both:
    phi bit for bit, K4 launched in both."""
    _need_cuda()
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.ops import cg_step as k4
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.solver import solver_socp

    geometry = load_geometry("plane", 200)
    phis, launches = [], []
    for ctx in (graphs.eager, contextlib.nullcontext):
        before = k4.KERNEL_LAUNCHES
        with ctx():
            solution, _ = solver_socp(31, geometry, nit=30, tol=1e-12, precision="float32",
                                      device="cuda", time_limit=600)
        torch.cuda.synchronize()
        launches.append(k4.KERNEL_LAUNCHES - before)
        phis.append(solution["phi"])
    np.testing.assert_array_equal(phis[0], phis[1])
    assert min(launches) > 0


ROW_SUM_SHAPES = [(32, 46_431), (128, 46_431), (32, 194_814), (8, 700), (8, 64), (32, 97_485),
                  (33, 46_431)]


@pytest.mark.parametrize("rows, n", ROW_SUM_SHAPES)
def test_cg_step_row_sums_are_pytorchs(rows, n):
    """K4 sums each row as PyTorch's reduce kernel does (its geometry, its
    order): on random states of these shapes (one block per row, rows split
    over 17 blocks, a warp per row, no 4-wide loads; n290; 33 rows, which
    start at every offset mod 4) den, rr, rz and the null row's mean equal
    torch's `.sum(dim=1)` of the same products bit for bit, and so do x,
    r, p."""
    _row_sums_case(rows, n, torch.float32)


@pytest.mark.parametrize("rows, n", ROW_SUM_SHAPES)
def test_cg_step_f64_row_sums_are_pytorchs(rows, n):
    """K4-f64 on the same shapes in float64: PyTorch's reduce geometry for
    double (`row_sum_config`, the float one) and its order, bit for bit."""
    _row_sums_case(rows, n, torch.float64)


def _row_sums_case(rows, n, dtype):
    _need_cuda()
    from dots_socp_torch.ops import cg_step as k4

    gen = torch.Generator(device="cuda").manual_seed(rows + n)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen, dtype=dtype)

    k = 16
    q = rand(n, k)
    real = torch.ones(n, device="cuda", dtype=dtype)
    real[-3:] = 0.0
    null = torch.zeros(rows, device="cuda", dtype=dtype)
    null[-1] = 1.0
    leaves = k4.CGStepLeaves(
        shifts=-rand(rows).abs(), av=rand(n).abs() + 0.1, jacobi=rand(rows, n).abs(),
        s=rand(n).abs() + 0.1, real=real, null=null, n_real=real.sum(), defl_q=q,
        defl_qt=q.t().contiguous(), defl_winv=rand(rows, k))
    state = (rand(rows, n), rand(rows, n), rand(rows, n), rand(rows, 1).abs(),
             rand(rows, 1).abs() + 1.0, torch.zeros((), dtype=torch.int64, device="cuda"),
             torch.ones((), dtype=torch.bool, device="cuda"))
    thresh = torch.full((rows, 1), 1e-3, device="cuda", dtype=dtype)
    lap = rand(rows, n)
    trace_k, trace_p = {}, {}
    out_k = tuple(t.clone() for t in state)
    out_p = tuple(t.clone() for t in state)
    k4.cg_step(lap, *out_k, thresh, 600, leaves, trace=trace_k)
    k4.cg_step_plain(lap, *out_p, thresh, 600, leaves, trace=trace_p)
    torch.cuda.synchronize()
    for key in ("den", "rr", "rz", "alpha", "beta", "x", "r", "z"):
        assert torch.equal(trace_k[key], trace_p[key]), key
    assert torch.equal(trace_k["mean"][-1], trace_p["mean"][-1])
    assert all(torch.equal(a, b) for a, b in zip(out_k, out_p))


@pytest.mark.parametrize("rows, n", [(32, 46_431), (33, 46_431), (32, 194_814)])
def test_cg_step_every_split_is_bit_equal_and_leaves_counters_at_zero(rows, n):
    """Every split `split_plan` accepts (lane rows per block, load depth,
    hand-over through a cluster or device memory) at n200 (32 and 33 rows)
    and n410 (rows split over 17 blocks): one call launches STAGES kernels
    of K4, every stage's outputs equal the plain version's bit for bit, and
    every handshake counter is 0 after the call (`kernel_checks.
    k4_every_split`). It counts the launches with torch.profiler, in a
    process of its own: on an H100 the profiler's sessions lost launches
    in a process that had run this file's earlier card tests."""
    _need_cuda()
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys; from dots_socp_torch.kernel_checks import k4_every_split; "
            "k4_every_split(int(sys.argv[1]), int(sys.argv[2]))")
    run = subprocess.run([sys.executable, "-c", code, str(rows), str(n)], cwd=repo,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr


IALM_SETUPS = kernel_checks.IALM_SETUPS
IALM_IDS = ["n64-f32-spectral", "n200-f32-cg-f64phi", "n200-f64-cg"]


def _ialm_inputs(n, precision, congestion=None, scale_z=None, settle=15):
    from dots_socp_torch.scripts.common import settled_ialm_state

    return settled_ialm_state(n, 31, precision, "cuda", settle=settle, congestion=congestion,
                              scale_z=scale_z)


@pytest.mark.parametrize("congestion, scale_z", kernel_checks.IALM_CASES,
                         ids=["congestion0", "congestion0.05-scale_z1.7"])
@pytest.mark.parametrize("n, precision", IALM_SETUPS, ids=IALM_IDS)
def test_ialm_step_is_bit_equal_to_the_torch_route(n, precision, congestion, scale_z):
    """`kernel_checks.k6`: one K6 step after phi from a settled state gives
    every array of the torch route bit for bit, in place; plane n64 float32
    (spectral), n200 float32 (CG, float64 phi) and n200 float64, without and
    with congestion and scale_z."""
    _need_cuda()
    kernel_checks.k6(n, precision, congestion, scale_z)


@pytest.mark.parametrize("n, precision", IALM_SETUPS, ids=IALM_IDS)
def test_graphed_ialm_iterations_equal_the_torch_route(n, precision):
    """52 iterations with CUDA graphs through K6 (the `iteration` or `after`
    segment, in place) against the same iterations with graphs inside
    `ialm_step.torch_route()` and inside `graphs.eager()`, from a settled
    state with congestion 0.05 and scale_z 1.7: every state array bit for
    bit; `step.fused_steps` ticks once an iteration on K6's route only, and
    K6 launches three times an iteration and once more at the capture's
    warm-up."""
    _need_cuda()
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.ops import ialm_step as k6
    from dots_socp_torch.solver import step

    config, data, state, _ = _ialm_inputs(n, precision, 0.05, 1.7, settle=5)
    iters = 52
    counts = {}
    runs = {}
    for route in ("k6", "torch", "eager"):
        steps, launches = step.FUSED_STEPS, k6.KERNEL_LAUNCHES
        ctx = {"k6": contextlib.nullcontext, "torch": k6.torch_route,
               "eager": graphs.eager}[route]
        with ctx():
            runs[route] = step.run_chunk(config, data, state, iters)
        torch.cuda.synchronize()
        counts[route] = (step.FUSED_STEPS - steps, k6.KERNEL_LAUNCHES - launches)
        graphs.release()
    for route in ("torch", "eager"):
        for name, a, b in zip(state._fields, runs["k6"], runs[route]):
            assert torch.equal(a, b), (route, name)
    assert counts == {"k6": (iters, k6.LAUNCHES * (iters + 1)), "torch": (0, 0),
                      "eager": (0, 0)}


@pytest.mark.parametrize(
    "kernel, n, precision, nit",
    [("k6", 64, "float32", 10_000), ("k6", 200, "float32", 120), ("k6", 200, "float64", 120),
     ("k4", 200, "float32", 10_000), ("k4", 200, "float64", 100)],
    ids=["k6-n64-f32-to-tolerance", "k6-n200-f32", "k6-n200-f64", "k4-n200-f32-to-tolerance",
         "k4-n200-f64"])
def test_solver_through_the_kernel_equals_the_torch_route(kernel, n, precision, nit):
    """One whole `solver` call on the kernel's route against the same call
    inside its `torch_route()`: K6 (`ialm_step`) on plane n64 to tol 1e-4
    and on n200 in float32 and float64 for `nit` iterations; K4 and K4-f64
    (`cg_step`) on n200 to tol 1e-4 in float32 and for `nit` iterations in
    float64. Every returned array and the KKT history bit for bit, the same
    validation points and iteration count. On K6's route every iteration
    counted in `step.fused_steps` and three K6 launches per iteration and
    per capture's warm-up; on K4's, STAGES launches of K4 (K4-f64 in
    float64) per fused inner iteration, B1 (B1-f64) once per window matvec
    on both routes, and in float64 every live inner iteration counted in
    `f64_fused_steps`, no float32 kernel and float64 arrays back. The torch
    route launches neither kernel."""
    _need_cuda()
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.kernel_timing import f64_launches, reset_counts
    from dots_socp_torch.ops import cg_step as k4
    from dots_socp_torch.ops import ialm_step as k6
    from dots_socp_torch.solver import solver, step

    geometry = load_geometry("plane", n)
    module = k6 if kernel == "k6" else k4
    out = {}
    for route in ("kernel", "torch"):
        steps, k6_launches = step.FUSED_STEPS, k6.KERNEL_LAUNCHES
        reset_counts()
        with contextlib.nullcontext() if route == "kernel" else module.torch_route():
            solution, history = solver(31, geometry, nit=nit, tol=1e-4, time_limit=3000,
                                       precision=precision, device="cuda")
        torch.cuda.synchronize()
        out[route] = {"solution": solution, "points": np.asarray(history.kkt_iteration),
                      "kkt": history.kkt_errors, "fused_steps": step.FUSED_STEPS - steps,
                      "k6": k6.KERNEL_LAUNCHES - k6_launches, "cg": dict(vars(tl.CG_COUNTERS)),
                      "launches": dict(zip(("b1_f64", "k4_f64", "b1", "k4"), f64_launches()))}
    run, ref = out["kernel"], out["torch"]
    arrays = [key for key, value in ref["solution"].items() if isinstance(value, np.ndarray)]
    assert {"phi", "mu", "E"} <= set(arrays)
    for key in arrays:
        np.testing.assert_array_equal(run["solution"][key], ref["solution"][key], err_msg=key)
    np.testing.assert_array_equal(run["points"], ref["points"])
    np.testing.assert_array_equal(run["kkt"], ref["kkt"])
    iterations = int(run["points"][-1]) + 1
    if nit == 10_000:
        assert iterations < nit  # converged
    if kernel == "k6":
        assert run["fused_steps"] == iterations and ref["fused_steps"] == 0
        assert run["k6"] == k6.LAUNCHES * (iterations + 1) and ref["k6"] == 0
        return
    f64 = precision == "float64"
    b1, k4_name = ("b1_f64", "k4_f64") if f64 else ("b1", "k4")
    assert run["cg"]["fused_steps"] > 0
    for on_kernel, r in ((True, run), (False, ref)):
        assert r["launches"][b1] == r["cg"]["window_matvecs"] > 0
        assert r["launches"][k4_name] == k4.STAGES * r["cg"]["fused_steps"] * on_kernel
        if f64:
            assert r["launches"]["b1"] == r["launches"]["k4"] == 0
            assert r["cg"]["f64_fused_steps"] == r["cg"]["iterations"] * on_kernel
            assert {str(r["solution"][key].dtype) for key in ("phi", "mu", "E")} == {"float64"}
