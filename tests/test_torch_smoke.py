"""CPU checks of the helpers `chip_smoke.py` and `dots_socp_torch.profile_slice`
use on the card: the smoke script imports only the port, its float64
reference Laplacian and mass check equal the JAX package's, and the
profiler's kernel groups name the kernels they should."""

import ast
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from dots_socp_torch import cli
from dots_socp_torch.profile_slice import group_of
from dots_socp_torch.solver.problem import build_problem
from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
from dots_socp_tpu.utils.evaluate import check_mass_conservation

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_imports_only_the_port():
    """Every import of chip_smoke.py is the standard library, numpy, scipy,
    torch or dots_socp_torch: nothing of jax or of the JAX package."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    allowed = {"__future__", "json", "subprocess", "sys", "time", "numpy", "scipy",
               "torch", "dots_socp_torch"}
    assert roots <= allowed, roots - allowed


def test_smoke_reference_laplacian_is_the_cotan_laplacian():
    """The smoke's float64 reference L (from the CG operator's ELL arrays)
    is exactly the JAX package's cotan Laplacian, on the geometry the
    solver receives."""
    geometry = cli.load_geometry("plane", 12)
    config, data, _ = build_problem(7, geometry, laplacian_mode="cg", dtype="float32", device="cpu")
    assert config.phi_refine and data.cg_op.window is not None
    lap = chip_smoke.ell_laplacian(data.cg_op)
    _, angles, _ = triangle_quantities(geometry["vertices"], geometry["triangles"])
    ref = cotan_laplacian(geometry["triangles"], angles, geometry["vertices"].shape[0])
    assert abs(lap - ref).max() == 0.0


def test_smoke_mass_error_matches_reference():
    mu = np.random.default_rng(5).random((8, 40))
    mu /= mu.sum(axis=1, keepdims=True)
    mu[3] *= 1.01
    np.testing.assert_allclose(
        chip_smoke.mass_conservation_error(mu),
        check_mass_conservation(mu, verbose=False),
        rtol=1e-12,
    )


@pytest.mark.parametrize(
    "name, group",
    [
        ("(anonymous namespace)::window_spmv_kernel(float const*, int const*)", "window_spmv_B1"),
        ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32", "gemm"),
        ("void gemv2T_kernel_val<int, int, float, float, float>", "gemm"),
        ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reduction"),
        ("void at::native::index_elementwise_kernel<128, 4>", "gather_index"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>", "elementwise"),
        ("Memcpy DtoH (Device -> Pageable)", "memcpy_dtoh"),
        ("Memcpy HtoD (Pageable -> Device)", "memcpy_memset"),
    ],
)
def test_profile_groups(name, group):
    assert group_of(name) == group
