"""Tests of the port that need an NVIDIA GPU: the CUDA window SpMV kernel and
the CG phi-solve and solver on the card, each against the plain PyTorch
version on the same inputs. They skip without a card. The file imports no
jax, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dots_socp_torch.ops import laplacian as tl
from dots_socp_torch.ops import mesh_ops as t_mesh
from dots_socp_torch.ops import window_spmv as tw
from dots_socp_tpu.geometry.generators import generate_plane_mesh
from dots_socp_tpu.geometry.surface import (
    cotan_laplacian,
    triangle_quantities,
    vertex_areas,
)

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _plane(n):
    vertices, triangles, _ = generate_plane_mesh(n=n)
    area_f, angles, _ = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, vertices.shape[0]) / 3.0
    return vertices, triangles, av, cotan_laplacian(triangles, angles, vertices.shape[0])


@pytest.mark.parametrize("n, tile_rows", [(7, 64), (24, None)])
def test_kernel_matches_plain_and_f64(n, tile_rows):
    """The kernel equals the plain version on the card, and scipy's f64
    L @ x on the host, within 1e-5 max|y| (float32 rounding of L and x,
    FMA and summation order), for 6, 32 and 40 modes (40: two mode
    groups); one counted launch per call."""
    _need_cuda()
    vertices, _, av, lap = _plane(n)
    tiles = tw.build_window_tiles(lap, tile_rows=tile_rows, coords=vertices)
    v = av.shape[0]
    op = tw.window_operator(tiles, av, np.ones((40, v)), av, np.zeros((v, 0)), device="cuda")
    rng = np.random.default_rng(5)
    for lanes in (6, 32, 40):
        x = rng.standard_normal((lanes, v)).astype(np.float32)
        xp = torch.from_numpy(np.ascontiguousarray(x[:, tiles.perm])).cuda()
        before = tw.KERNEL_LAUNCHES
        y = tw.window_matvec(op, xp)
        torch.cuda.synchronize()
        assert tw.KERNEL_LAUNCHES == before + 1
        y_plain = tw.window_matvec_plain(op, xp)
        ref = (lap @ x.astype(np.float64).T).T
        scale = np.abs(ref).max()
        got = y.cpu().numpy()[:, tiles.iperm]
        assert np.abs(got - y_plain.cpu().numpy()[:, tiles.iperm]).max() <= 1e-5 * scale
        assert np.abs(got - ref).max() <= 1e-5 * scale


def test_kernel_rejects_float64():
    _need_cuda()
    vertices, _, av, lap = _plane(7)
    tiles = tw.build_window_tiles(lap, tile_rows=64, coords=vertices)
    v = av.shape[0]
    op = tw.window_operator(tiles, av, np.ones((6, v)), av, np.zeros((v, 0)), device="cuda")
    with pytest.raises(TypeError):
        tw.window_matvec(op, torch.zeros((6, v), dtype=torch.float64, device="cuda"))


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
