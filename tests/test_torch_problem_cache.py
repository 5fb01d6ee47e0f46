"""The port's assembly kept across calls (`solver/problem.py::build_problem`)
on small planes (n=12 and n=10, ntime 7), on the spectral and the CG path:
solves that reuse the last mesh's operators give, bit for bit, what a fresh
assembly gives; the key misses on another mesh, an in-place edit of the
vertices and another option; the CG's inner tolerance starts each solve
where the build set it; a sharded build never reads or fills the cache; and
the tracer's counters feed `assembly_hit_share`."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from dots_socp_torch.geometry.generators import generate_plane_mesh
from dots_socp_torch.geometry.surface import triangle_quantities, vertex_areas
from dots_socp_torch.solver import problem, step
from dots_socp_torch.solver.decorators import solver
from dots_socp_torch.utils import trace
from torch_rank_worker import one_thread

REPO = Path(__file__).resolve().parents[1]
N_TIME = 7
PATHS = {"spectral": dict(laplacian_mode="spectral", precision="float64"),
         "cg": dict(laplacian_mode="cg", precision="float32")}
SOLVE = dict(tol=1e-2, nit=150, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


@pytest.fixture(autouse=True)
def _nothing_kept():
    problem.clear()
    yield
    problem.clear()


def _mesh(n):
    vertices, triangles, _ = generate_plane_mesh(n=n)
    area_f, _, _ = triangle_quantities(vertices, triangles)
    return vertices, triangles, area_f, vertex_areas(triangles, area_f, vertices.shape[0])


def _pair(mesh, c0, c1):
    """The mesh's geometry with gaussians centred at c0 and c1."""
    vertices, triangles, area_f, av = mesh

    def gauss(centre):
        mu = av * np.exp(-np.linalg.norm(vertices - np.asarray(centre), axis=1) ** 2 / 0.02)
        return mu / mu.sum()

    return {"vertices": vertices, "triangles": triangles, "area_triangles": area_f,
            "area_vertices": av, "mu0": gauss(c0 + [0.0]), "mu1": gauss(c1 + [0.0])}


def _counted(fn):
    """fn's result and the hits and misses it added."""
    before = dict(problem.ASSEMBLY_COUNTS)
    out = fn()
    return out, {k: v - before[k] for k, v in problem.ASSEMBLY_COUNTS.items()}


def _assert_same_answer(got, want):
    (sol, hist), (sol_want, hist_want) = got, want
    assert sorted(sol) == sorted(sol_want)
    for name, value in sol.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value, sol_want[name], err_msg=name)
    np.testing.assert_array_equal(hist.kkt_iteration, hist_want.kkt_iteration)
    assert hist.history["Transportation cost"][-1] == hist_want.history["Transportation cost"][-1]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_kept_assembly_answers_as_a_fresh_one(path, monkeypatch):
    """Pairs A, B on mesh 1, C on mesh 2, A on mesh 1 again: miss, hit,
    miss, miss, and every answer bit-equal to the same call after `clear()`.
    On the CG path each solve's first inner tolerance is the build's, though
    the solves before lowered theirs."""
    mesh1, mesh2 = _mesh(12), _mesh(10)
    calls = [_pair(mesh1, [0.4, 0.4], [0.6, 0.6]), _pair(mesh1, [0.3, 0.6], [0.65, 0.35]),
             _pair(mesh2, [0.35, 0.4], [0.6, 0.65]), _pair(mesh1, [0.4, 0.4], [0.6, 0.6])]
    # Short segments: the host loop's inner tolerance reaches the next one.
    kw = dict(SOLVE, max_chunk=20, **PATHS[path])
    rtols = []
    real = step.cg_solve

    def spy(ops, op, *args, **kwargs):
        rtols[-1].append(float(op.rtol))
        return real(ops, op, *args, **kwargs)

    monkeypatch.setattr(step, "cg_solve", spy)

    def solve(geometry):
        rtols.append([])
        return solver(N_TIME, geometry, **kw)

    kept = [_counted(lambda g=g: solve(g)) for g in calls]
    assert [counts for _, counts in kept] == [{"hits": 0, "misses": 1}, {"hits": 1, "misses": 0},
                                             {"hits": 0, "misses": 1}, {"hits": 0, "misses": 1}]
    kept_rtols = rtols[:]
    for geometry, (answer, _) in zip(calls, kept):
        problem.clear()
        _assert_same_answer(answer, solve(geometry))
    if path == "cg":
        fresh_rtols = rtols[len(kept_rtols):]
        built = float(np.float32(1e-3))  # the solver's first inner tolerance, in float32
        assert all(r and r[0] == built for r in kept_rtols)
        assert [r[0] for r in kept_rtols] == [r[0] for r in fresh_rtols]
        assert min(kept_rtols[0]) < kept_rtols[0][0]  # the host loop lowered it
    else:
        assert not any(rtols)


def test_vertices_edited_in_place_miss():
    geometry = _pair(_mesh(12), [0.4, 0.4], [0.6, 0.6])
    geometry["vertices"] = geometry["vertices"].copy()
    build = lambda: problem.build_problem(N_TIME, geometry, device="cpu")  # noqa: E731
    (config, data, extras), counts = _counted(build)
    assert counts == {"hits": 0, "misses": 1}
    (config2, data2, extras2), counts = _counted(build)
    assert counts == {"hits": 1, "misses": 0}
    assert config2 is config and data2 is data and extras2 is not extras
    assert not extras2["av"].flags.writeable
    np.testing.assert_array_equal(extras2["mu0_padded"], extras["mu0_padded"])
    geometry["vertices"][5, 0] += 1e-3
    (_, data3, _), counts = _counted(build)
    assert counts == {"hits": 0, "misses": 1} and data3 is not data


@pytest.mark.parametrize("change", [dict(precision="float64"), dict(cg_rtol=1e-5),
                                    dict(laplacian_mode="spectral")], ids=lambda c: next(iter(c)))
def test_another_option_misses(change):
    geometry = _pair(_mesh(12), [0.4, 0.4], [0.6, 0.6])
    base = dict(SOLVE, nit=3, **PATHS["cg"])
    seen = [_counted(lambda kw=kw: solver(N_TIME, geometry, **kw))[1]
            for kw in (base, base, dict(base, **change), base)]
    assert seen == [{"hits": 0, "misses": 1}, {"hits": 1, "misses": 0},
                    {"hits": 0, "misses": 1}, {"hits": 0, "misses": 1}]


def test_sharded_build_bypasses_the_cache():
    geometry = _pair(_mesh(12), [0.4, 0.4], [0.6, 0.6])
    problem.build_problem(N_TIME, geometry, device="cpu")
    kept = problem._KEPT
    for _ in range(2):
        (_, data, extras), counts = _counted(lambda: problem.build_problem(
            N_TIME, geometry, laplacian_mode="cg", space_partitions=2, device="cpu"))
        assert counts == {"hits": 0, "misses": 0} and data.halo is not None
        assert extras["av"].flags.writeable
    assert problem._KEPT is kept


def test_traced_problem_counts_its_lookup_and_the_reader_reads_it():
    """The tracer takes the lookups over a problem; `assembly_hit_share`
    reads them from the profiled problem."""
    spec = importlib.util.spec_from_file_location(
        "otbench_metric_assembly_hit_share", REPO / "otbench" / "metrics" / "assembly_hit_share.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    geometry = _pair(_mesh(12), [0.4, 0.4], [0.6, 0.6])
    kw = dict(SOLVE, nit=3, **PATHS["spectral"])
    shares = []
    for _ in range(2):
        trace.enable()
        try:
            _, history = solver(N_TIME, geometry, **kw)
        finally:
            trace.disable()
        got = trace.last_problem()
        rec = {"profile": {"record": {"iterations": int(history.kkt_iteration[-1]) + 1}}}
        shares.append((got["counters"]["assembly.hits"], got["counters"]["assembly.misses"],
                       module.read(rec)))
    assert shares == [(0, 1, 0.0), (1, 0, 100.0)]
