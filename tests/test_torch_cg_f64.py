"""The float64 CG phi solve on its kernels' route (B1-f64 in every inner
matvec, K4-f64 in every inner iteration), on the CPU, where each kernel
wrapper runs its plain version: the float64 window operator's matvec
against the padded-ELL gather and SciPy; a whole float64 solve through the
public entry point, its arrays and its agreement with the ELL route and the
torch route; the float32 CG solve's bits, unchanged by the float64 route;
the float64 tiling, split plan, counters and input contracts. The kernels
themselves run on the card (tests/test_torch_cuda.py). No JAX."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dots_socp_torch.cli import load_geometry
from dots_socp_torch.geometry.generators import generate_plane_mesh
from dots_socp_torch.geometry.surface import cotan_laplacian, triangle_quantities, vertex_areas
from dots_socp_torch.ops import cg_step as k4
from dots_socp_torch.ops import laplacian as tl
from dots_socp_torch.ops import mesh_ops
from dots_socp_torch.ops import window_spmv as tw
from dots_socp_torch.solver import problem as t_problem
from dots_socp_torch.solver import solver_socp
from dots_socp_torch.utils import trace
from torch_rank_worker import one_thread

# The float32 CG solve of `_solve(16, "float32")`: its phi's sha256 and its
# counts, as the commit before the float64 route gave them on this test's
# CPU path (one thread).
F32_PHI_SHA256 = "111a6751cb32df4250158c72e078a0bb5581e15cba32a1bbcee76d96c7040c71"
F32_COUNTS = {"iterations": 1090, "inner": 3402, "window_matvecs": 10089, "passes": 1121}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def _plane(n, pad=0):
    """Plane n's cotan Laplacian and vertex areas, with `pad` structurally
    empty rows and columns appended (padding slots, area 1)."""
    vertices, triangles, _ = generate_plane_mesh(n=n)
    area_f, angles, _ = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, vertices.shape[0]) / 3.0
    lap = sp.csr_matrix(cotan_laplacian(triangles, angles, vertices.shape[0]))
    if pad:
        lap = sp.block_diag([lap, sp.csr_matrix((pad, pad))], format="csr")
        av = np.concatenate([av, np.ones(pad)])
    return lap, av


@pytest.mark.parametrize("n, pad, lanes", [(12, 0, 8), (24, 0, 32), (12, 10, 33)],
                         ids=["n12", "n24", "n12-padded"])
def test_f64_window_matvec_equals_ell_and_scipy(n, pad, lanes):
    """The float64 window operator (`value_bytes=8`, float64 values) times
    x, by its plain version, equals the float64 padded-ELL gather and
    SciPy's CSR product within 1e-13 relative, padding slots included."""
    lap, av = _plane(n, pad)
    v = av.shape[0]
    tiles = tw.build_window_tiles(lap, n_modes=lanes, value_bytes=8)
    assert tiles.vals.dtype == np.float64
    op = tw.window_operator(tiles, av, np.ones((lanes, v)), 1.0 / np.sqrt(av),
                            np.zeros((v, 0)), dtype=torch.float64)
    assert op.vals.dtype == op.jacobi_p.dtype == op.s_p.dtype == torch.float64
    x = np.random.default_rng(n + pad).standard_normal((lanes, v))
    xp = torch.from_numpy(np.ascontiguousarray(x[:, tiles.perm]))
    got = tw.window_matvec(op, xp).numpy()[:, tiles.iperm]
    idx, w = tl._ell_arrays(lap)
    ell = tl.ell_matvec(SimpleNamespace(ell_idx=torch.from_numpy(idx).long(),
                                        ell_w=torch.from_numpy(w)), torch.from_numpy(x)).numpy()
    ref = (lap @ x.T).T
    scale = np.abs(ref).max()
    assert np.abs(got - ell).max() <= 1e-13 * scale
    assert np.abs(got - ref).max() <= 1e-13 * scale
    if pad:
        assert not got[:, -pad:].any()


def test_f64_tiles_fit_the_f64_block_at_plane_n200():
    """B1-f64's block holds 12 bytes per (column, value) slot and 8 per
    window element: at plane n200 and 32 modes its tiles are the float32
    ones (352 rows, one per SM) and fit 227 KB; the float32 block's bytes
    are unchanged."""
    lap, _ = _plane(200)
    t64 = tw.build_window_tiles(lap, n_modes=32, value_bytes=8)
    t32 = tw.build_window_tiles(lap, n_modes=32)
    assert t64.meta["tile_rows"] == t32.meta["tile_rows"] == 352
    assert t64.meta["smem_bytes"] == tw.smem_bytes(352, t64.meta["width"], 8, 8) <= tw.SMEM_BYTES
    assert t32.meta["smem_bytes"] == 16 + 352 * 8 * 8 + 32 * max(t32.meta["width"] | 1, 353) * 4
    np.testing.assert_array_equal(t64.perm, t32.perm)
    np.testing.assert_array_equal(t64.vals.astype(np.float32), t32.vals)


def _solve(n, precision, tol=1e-4):
    """The plane example at n, ntime 7, on the CG path on the CPU; the
    solution, the history and the change in `CG_COUNTERS`."""
    geometry = load_geometry("plane", n)
    tl.CG_COUNTERS.reset()
    solution, history = solver_socp(7, geometry, tol=tol, nit=3000, precision=precision,
                                    laplacian_mode="cg", device="cpu")
    return solution, history, dict(vars(tl.CG_COUNTERS))


def test_f64_solve_takes_the_f64_window_and_agrees_with_the_other_routes(monkeypatch):
    """precision="float64" on the CG path: converged to tol 1e-4, float64
    arrays, every inner matvec through the float64 window operator, and
    phi, mu and E within float64 round-off (1e-12 relative) of the same
    solve on the ELL gather (the route before B1-f64) with the same
    iteration counts; `torch_route()` changes nothing on the CPU. Traced:
    the `cg_solve` spans say float64, and the counters hold
    `cg.f64_fused_steps` (0 here: K4-f64 runs on a card only)."""
    trace.enable()
    try:
        sol, hist, counts = _solve(16, "float64")
        problem = trace.last_problem()
    finally:
        trace.disable()
    assert (hist.get_current_kkt_errors() < 1e-4).all()
    for key in ("phi", "mu", "E"):
        assert sol[key].dtype == np.float64, key
    assert counts["refined_solves"] == 0 and counts["f64_fused_steps"] == 0
    # Every matvec of the inner CG, the latched blocks' no-ops included.
    assert counts["window_matvecs"] >= counts["iterations"] + counts["passes"] > 0
    works = {s["attrs"].get("work") for s in problem["spans"] if s["name"] == "cg_solve"}
    assert works == {"float64"}
    assert problem["counters"]["cg.f64_fused_steps"] == 0
    with k4.torch_route():
        sol_t, hist_t, _ = _solve(16, "float64")
    for key in ("phi", "mu", "E"):
        np.testing.assert_array_equal(sol_t[key], sol[key])
    monkeypatch.setattr(tl, "build_window_tiles", lambda *a, **kw: None)
    t_problem.clear()  # the kept assembly holds the window operator
    try:
        sol_e, hist_e, counts_e = _solve(16, "float64")
    finally:
        t_problem.clear()
    assert counts_e["window_matvecs"] == 0
    assert int(hist_e.kkt_iteration[-1]) == int(hist.kkt_iteration[-1])
    assert counts_e["iterations"] == counts["iterations"]
    for key in ("phi", "mu", "E"):
        scale = np.abs(sol_e[key]).max()
        assert np.abs(sol[key] - sol_e[key]).max() <= 1e-12 * scale, key


def test_f32_cg_solve_keeps_its_bits():
    """The float32 CG solve (f64 refinement around B1's plain version) of
    the same problem: phi bit for bit and the same counts as before the
    float64 route existed (F32_PHI_SHA256, F32_COUNTS); no K4-f64 step."""
    sol, hist, counts = _solve(16, "float32")
    digest = hashlib.sha256(np.ascontiguousarray(sol["phi"]).tobytes()).hexdigest()
    got = {"iterations": int(hist.kkt_iteration[-1]) + 1, "inner": counts["iterations"],
           "window_matvecs": counts["window_matvecs"], "passes": counts["passes"]}
    assert (digest, got) == (F32_PHI_SHA256, F32_COUNTS)
    assert counts["f64_fused_steps"] == 0


def test_f64_fused_steps_count_live_iterations_of_the_f64_route(monkeypatch):
    """`CG_COUNTERS.f64_fused_steps` counts the live inner iterations that
    went through `cg_step` in a float64 solve (K4-f64's route, forced here
    onto its plain version), every one of them, and none of a float32
    solve's."""
    monkeypatch.setattr(tl, "_fused_route", lambda cg, device: True)
    lap, av = _plane(12)
    vertices, triangles, _ = generate_plane_mesh(n=12)
    ops = mesh_ops.build_surface_ops(vertices, triangles, dtype=torch.float64)
    rhs = np.random.default_rng(3).standard_normal((8, av.shape[0]))
    rhs = torch.from_numpy(rhs - rhs.mean())
    for dtype, refine in ((torch.float64, False), (torch.float32, True)):
        op = tl.build_cg_operator(7, 1.0 / 7, av, lap, dtype=dtype, deflation_k=8,
                                  refine=refine)
        assert op.window.vals.dtype == (torch.float32 if refine else torch.float64)
        tl.CG_COUNTERS.reset()
        _, iters = tl.cg_solve(ops, op, rhs, max_iters=600, rtol=1e-8, return_iters=True)
        assert iters > 0 and tl.CG_COUNTERS.iterations == iters
        assert tl.CG_COUNTERS.f64_fused_steps == (iters if dtype == torch.float64 else 0)


def test_f64_split_plan_loads_four_deep_in_half_blocks():
    """K4-f64's walks: PyTorch's geometry for the same rows (the float
    one), 4 vectors deep, at most 256 threads a block (128 at 8 deep); the
    float32 plan keeps 8 deep in a cluster at plane n200."""
    for rows, n in ((32, 46_431), (128, 46_431), (32, 194_814), (8, 700)):
        red = k4.row_sum_config(rows, n)
        plan64 = k4.split_plan(red, rows, elem_bytes=8)
        assert plan64.depth == 4 and plan64.threads <= k4.WALK_THREADS_F64[4]
        assert (plan64.groups, plan64.ctas, plan64.virtual) == (
            lambda p: (p.groups, p.ctas, p.virtual))(k4.split_plan(red, rows))
    plan32 = k4.split_plan(k4.row_sum_config(32, 46_431), 32)
    assert (plan32.depth, plan32.cluster) == (8, True)
    with pytest.raises(ValueError, match="threads"):
        k4.split_plan(k4.row_sum_config(128, 46_431), 128, lanes=16, elem_bytes=8)


def test_kernel_entry_points_reject_a_dtype_mix():
    """The kernels' contracts: K4 takes every array in one dtype (float32
    or float64), B1 an x of its operator's value dtype, B1-f64's tiles
    float64 values; a mix raises before any launch."""
    rows, n = 4, 64
    f32 = dict(dtype=torch.float32)
    state = [torch.zeros(rows, n, **f32) for _ in range(4)]  # lap, x, r, p
    scal = [torch.ones(rows, **f32) for _ in range(3)]  # rz, rr, thresh
    it, live = torch.zeros((), dtype=torch.int64), torch.ones((), dtype=torch.bool)
    leaves = k4.CGStepLeaves(
        shifts=torch.zeros(rows, **f32), av=torch.ones(n, **f32),
        jacobi=torch.ones(rows, n, **f32), s=torch.ones(n, **f32), real=torch.ones(n, **f32),
        null=torch.zeros(rows, **f32), n_real=torch.tensor(float(n)),
        defl_q=torch.zeros(n, 0, **f32), defl_qt=torch.zeros(0, n, **f32),
        defl_winv=torch.zeros(rows, 0, **f32))
    lap, x, r, p = state
    rz, rr, thresh = scal
    assert k4._check(lap, x, r, p, rz, rr, it, live, thresh, leaves) == (rows, n, 0)
    as64 = leaves._replace(**{k: getattr(leaves, k).double() for k in leaves._fields})
    assert k4._check(lap.double(), x.double(), r.double(), p.double(), rz.double(),
                     rr.double(), it, live, thresh.double(), as64) == (rows, n, 0)
    with pytest.raises(TypeError, match="one dtype"):
        k4._check(lap, x, r, p, rz, rr, it, live, thresh, as64)
    with pytest.raises(TypeError, match="one dtype"):
        k4._check(lap.double(), x.double(), r.double(), p.double(), rz.double(), rr.double(),
                  it, live, thresh, as64)
    with pytest.raises(TypeError, match="float32 or float64"):
        k4._check(lap.half(), x.half(), r, p, rz, rr, it, live, thresh, leaves)

    lap_s, av = _plane(7)
    tiles = tw.build_window_tiles(lap_s, tile_rows=64, value_bytes=8)
    v = av.shape[0]
    op64 = tw.window_operator(tiles, av, np.ones((6, v)), av, np.zeros((v, 0)),
                              dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        tw.check_kernel_input("window kernel", torch.zeros(6, v), v, op64.vals.dtype)
    tw.check_kernel_input("window kernel", torch.zeros(6, v, dtype=torch.float64), v,
                          op64.vals.dtype)
    n_tiles = tw.check_kernel_tiles("window kernel", op64, v, op64.vals.device, torch.float64)
    assert n_tiles == -(-v // 64)
    with pytest.raises(ValueError, match="vals"):
        tw.check_kernel_tiles("window kernel", op64, v, op64.vals.device)


def test_chip_smoke_reset_counts_zeroes_the_f64_launches(monkeypatch):
    """`kernel_timing.reset_counts` (which the smoke, `bench_kernels` and
    the card tests call) sets both float64 launch counters to 0 with the
    float32 ones, and `f64_launches` reads all four."""
    from dots_socp_torch import kernel_timing

    for module in (tw, k4):
        monkeypatch.setattr(module, "KERNEL_LAUNCHES", 3)
        monkeypatch.setattr(module, "KERNEL_LAUNCHES_F64", 5)
    assert kernel_timing.f64_launches() == (5, 5, 3, 3)
    kernel_timing.reset_counts()
    assert kernel_timing.f64_launches() == (0, 0, 0, 0)


def test_smoke_reference_laplacian_of_the_f64_operator():
    """The card tests' float64 reference L (`kernel_timing.ell_laplacian`)
    of the float64 CG operator (no refinement: from `ell_w`) is the float32
    operator's (from `ell_w_hi`) bit for bit, and the float64 operator
    carries the float64 window."""
    from dots_socp_torch.kernel_timing import ell_laplacian

    geometry = load_geometry("plane", 12)
    ops = {}
    for dtype in ("float32", "float64"):
        config, data, _ = t_problem.build_problem(7, geometry, laplacian_mode="cg", dtype=dtype,
                                                  device="cpu")
        ops[dtype] = data.cg_op
    assert ops["float64"].ell_w_hi is None and ops["float32"].ell_w_hi is not None
    assert ops["float64"].window.vals.dtype == torch.float64
    lap64, lap32 = (ell_laplacian(ops[d]) for d in ("float64", "float32"))
    assert lap64.shape == lap32.shape and abs(lap64 - lap32).max() == 0.0
