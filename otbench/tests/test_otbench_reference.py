"""The plain reference: independent of the program by its imports, its
calculus exact on what it must be exact on, its plane the program's, and
its residuals small on a converged solve of the program and large on a
perturbed one."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

from otbench import traffic
from otbench.reference import optimality, plane

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
ALLOWED = {"__future__", "numpy", "scipy", "otbench"}


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_only_numpy_and_scipy(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top in ALLOWED, f"{path.name} imports {name}"
            if top == "otbench":
                assert name.startswith("otbench.reference"), f"{path.name} imports {name}"


def test_calculus_on_linear_functions():
    geom = plane.geometry(8)
    calc = optimality.Calculus(geom["vertices"], geom["triangles"])
    x, y = geom["vertices"][:, 0], geom["vertices"][:, 1]
    grad = calc.grad(np.stack([2 * x - 3 * y, np.ones_like(x)]))
    assert np.allclose(grad[0], [2.0, -3.0, 0.0]) and np.allclose(grad[1], 0.0)
    field = np.random.default_rng(0).standard_normal((2, calc.n_triangles, 3))
    phi = np.random.default_rng(1).standard_normal((2, calc.n_vertices))
    # div is minus the adjoint of grad in the area-weighted pairing.
    lhs = np.einsum("kv,kv->", phi, calc.div(field * calc.area_f[None, :, None]))
    rhs = -np.einsum("kfc,kfc,f->", calc.grad(phi), field, calc.area_f)
    assert lhs == pytest.approx(rhs)
    assert calc.av.sum() == pytest.approx(calc.area_f.sum())


def test_plane_is_the_programs_plane():
    from dots_socp_torch.cli import load_geometry

    ours, theirs = plane.geometry(16), load_geometry("plane", 16)
    assert np.array_equal(ours["triangles"], theirs["triangles"])
    assert np.allclose(ours["vertices"], theirs["vertices"], rtol=0, atol=1e-15)
    assert np.allclose(ours["area_vertices"], theirs["area_vertices"], rtol=1e-13)


def test_pairs_follow_the_seed_and_the_mix():
    mix = {"family": "gauss_pair", "scale": 0.02, "displacement": 0.2 * 2**0.5,
           "box": [0.25, 0.75]}
    geom = plane.geometry(8)
    seed = 2**40 + 17
    a = [next(traffic.problems(mix, geom, seed)) for _ in range(2)]
    b = traffic.problems(mix, geom, seed)
    first, second = next(b), next(b)
    assert np.array_equal(a[0]["mu0"], first["mu0"]) and a[0]["centers"] == a[1]["centers"]
    assert first["centers"] != second["centers"]
    warm = next(traffic.problems(mix, geom, seed, traffic.WARMUP))
    assert warm["centers"] != first["centers"]
    for p in (first, second, warm):
        c0, c1 = np.asarray(p["centers"])[:, :2]
        assert np.linalg.norm(c1 - c0) == pytest.approx(0.2 * 2**0.5)
        assert np.all((c0 >= 0.25) & (c0 <= 0.75) & (c1 >= 0.25) & (c1 <= 0.75))
        assert p["mu0"].sum() == pytest.approx(1.0) and p["mu1"].sum() == pytest.approx(1.0)


@pytest.fixture(scope="module")
def converged(tmp_path_factory):
    """The program's plane n10 solve at ntime 7 to tol 1e-4 on the CPU."""
    import dots_socp_torch

    mp = pytest.MonkeyPatch()
    mp.setenv("DOTS_SOCP_CACHE_DIR", str(tmp_path_factory.mktemp("cache")))

    geom = plane.geometry(10)
    pair = next(traffic.problems({"family": "gauss_pair", "scale": 0.02,
                                  "displacement": 0.2 * 2**0.5, "box": [0.25, 0.75]},
                                 geom, 5))
    problem = dict(geom, mu0=pair["mu0"], mu1=pair["mu1"])
    solution, history = dots_socp_torch.solver(7, problem, tol=1e-4, nit=5000,
                                               precision="float64", device="cpu")
    mp.undo()
    assert (history.get_current_kkt_errors() < 1e-4).all()
    cost = history.history["Transportation cost"][-1]
    return geom, problem, solution, cost


def test_reference_holds_a_converged_solve(converged):
    geom, problem, sol, cost = converged
    calc = optimality.Calculus(geom["vertices"], geom["triangles"])
    got = optimality.residuals(calc, problem["mu0"], problem["mu1"], sol["mu"], sol["E"],
                               sol["phi"], cost)
    assert max(got.values()) < 2e-4, got
    assert cost == pytest.approx(optimality.dual_objective(sol["phi"], problem["mu0"],
                                                           problem["mu1"]), rel=1e-9)


@pytest.mark.parametrize("fault", ["momentum", "density", "potential", "cost"])
def test_reference_fails_a_perturbed_solve(converged, fault):
    geom, problem, sol, cost = converged
    calc = optimality.Calculus(geom["vertices"], geom["triangles"])
    mu, E, phi = sol["mu"].copy(), sol["E"].copy(), sol["phi"].copy()
    if fault == "momentum":
        E *= 1.01
    elif fault == "density":
        mu[3] *= 1.01
    elif fault == "potential":
        phi[1:-1] += 1e-3 * np.random.default_rng(0).standard_normal(phi[1:-1].shape)
    else:
        cost *= 1.01
    got = optimality.residuals(calc, problem["mu0"], problem["mu1"], mu, E, phi, cost)
    assert max(got.values()) > 2e-3, got
