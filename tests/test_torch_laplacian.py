"""The port's phi-solve (`dots_socp_torch.ops.laplacian`) against the JAX
package: operator leaves, the spectral solve, and the CG solve on its two
paths (plain f64 ELL; f64 refinement around the f32 window-SpMV inner CG,
where JAX runs its Pallas kernel in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_socp_torch.convert import window_from_reference
from dots_socp_torch.ops import laplacian as tl
from dots_socp_torch.ops import mesh_ops as t_mesh
from dots_socp_tpu.geometry.generators import generate_plane_mesh
from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
from dots_socp_tpu.ops import laplacian as jl
from dots_socp_tpu.ops import mesh_ops as j_mesh

T = 5
DT = 1.0 / T


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(7)
    vertices, triangles, _ = generate_plane_mesh(n=7)
    vertices = vertices.copy()
    vertices[:, 2] = 0.03 * rng.standard_normal(vertices.shape[0])
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    av = np.asarray(j_mesh.build_surface_ops(vertices, triangles, dtype=jnp.float64).av)
    return vertices, triangles, lap, av


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cg_operator_leaves_equal_reference(mesh, dtype):
    """Every leaf of the port's CG operator (refinement on, window built)
    equals the JAX operator's built with use_pallas_spmv=True; the port's
    window operator equals the one converted from the JAX dense tiles."""
    vertices, _, lap, av = mesh
    j_dt = jnp.float64 if dtype == "float64" else jnp.float32
    t_dt = torch.float64 if dtype == "float64" else torch.float32
    kw = dict(eps=0.0, deflation_k=8, rtol=1e-6, spmv_tile_rows=64, refine=True, coords=vertices)
    jop = jl.build_cg_operator(T, DT, av, lap, dtype=j_dt, use_pallas_spmv=True, **kw)
    top = tl.build_cg_operator(T, DT, av, lap, dtype=t_dt, **kw)
    assert jop.window is not None and top.window is not None
    for name in tl.CGOperator._fields:
        if name == "window":
            continue
        ref, port = getattr(jop, name), getattr(top, name)
        np.testing.assert_array_equal(_np(port), np.asarray(ref), err_msg=name)
        if np.asarray(ref).dtype.kind == "f":  # indices are int64 in the port
            assert _np(port).dtype == np.asarray(ref).dtype, name
    conv = window_from_reference(jop.window)
    for name in tl.WindowOperator._fields:
        a, b = getattr(top.window, name), getattr(conv, name)
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)


def test_spectral_solve_matches_reference(mesh):
    vertices, _, lap, av = mesh
    jf = jl.build_spectral_factor(T, DT, av, lap, dtype=jnp.float64)
    tf = tl.build_spectral_factor(T, DT, av, lap, dtype=torch.float64)
    for name in tl.SpectralFactor._fields:
        np.testing.assert_allclose(_np(getattr(tf, name)), np.asarray(getattr(jf, name)), rtol=1e-12, atol=1e-12)
    rhs = np.random.default_rng(11).standard_normal((T + 1, av.shape[0]))
    ref = np.asarray(jl.spectral_solve(jf, jnp.asarray(rhs)))
    port = tl.spectral_solve(tf, torch.from_numpy(rhs)).numpy()
    assert np.abs(port - ref).max() <= 1e-12 * np.abs(ref).max()


def test_ell_matvec_matches_reference(mesh):
    vertices, _, lap, av = mesh
    jop = jl.build_cg_operator(T, DT, av, lap, dtype=jnp.float64, deflation_k=0, use_pallas_spmv=False)
    top = tl.build_cg_operator(T, DT, av, lap, dtype=torch.float64, deflation_k=0)
    x = np.random.default_rng(12).standard_normal((T + 1, av.shape[0]))
    ref = np.asarray(jl.ell_matvec(jop, jnp.asarray(x)))
    port = tl.ell_matvec(top, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port, (lap @ x.T).T, rtol=1e-12, atol=1e-12)


def _rhs(av, seed):
    rhs = np.random.default_rng(seed).standard_normal((T + 1, av.shape[0]))
    return rhs - rhs.mean()


def test_cg_solve_f64_matches_reference(mesh):
    """Plain f64 CG (ELL matvec, no refinement) at rtol 1e-10: the same
    inner iteration count, and the mean-removed difference <= 1e-8."""
    vertices, triangles, lap, av = mesh
    jops = j_mesh.build_surface_ops(vertices, triangles, dtype=jnp.float64)
    tops = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64)
    jop = jl.build_cg_operator(T, DT, av, lap, dtype=jnp.float64, deflation_k=8, use_pallas_spmv=False)
    top = tl.build_cg_operator(T, DT, av, lap, dtype=torch.float64, deflation_k=8)
    assert top.window is None  # f64 work dtype: no window operator
    rhs = _rhs(av, 32)
    x0 = np.random.default_rng(33).standard_normal(rhs.shape)
    for start in (None, x0):
        jx, jit = jl.cg_solve(
            jops, jop, jnp.asarray(rhs), x0=None if start is None else jnp.asarray(start),
            max_iters=600, rtol=1e-10, return_iters=True,
        )
        tx, tit = tl.cg_solve(
            tops, top, torch.from_numpy(rhs), x0=None if start is None else torch.from_numpy(start),
            max_iters=600, rtol=1e-10, return_iters=True,
        )
        assert tit == int(jit)
        diff = tx.numpy() - np.asarray(jx)
        assert np.abs(diff - diff.mean()).max() < 1e-8


def test_cg_solve_refined_window_matches_reference(mesh):
    """The refined path: f64 true residual around the f32 inner CG on the
    window SpMV (port: plain version; JAX: Pallas interpret mode). Same
    bound as the reference's own test (test_ops.py:485): 1e-6."""
    vertices, triangles, lap, av = mesh
    jops = j_mesh.build_surface_ops(vertices, triangles, dtype=jnp.float64)
    tops = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64)
    kw = dict(deflation_k=8, spmv_tile_rows=64, refine=True)
    jop = jl.build_cg_operator(T, DT, av, lap, dtype=jnp.float64, use_pallas_spmv=True, **kw)
    top = tl.build_cg_operator(T, DT, av, lap, dtype=torch.float64, **kw)
    rhs = _rhs(av, 34)
    ref = np.asarray(jl.cg_solve(jops, jop, jnp.asarray(rhs), max_iters=600, rtol=1e-8))
    before = tl.CG_COUNTERS.window_matvecs
    port, iters = tl.cg_solve(
        tops, top, torch.from_numpy(rhs), max_iters=600, rtol=1e-8, return_iters=True
    )
    assert port.dtype == torch.float64
    # Every inner matvec went through the window SpMV: one per inner
    # iteration plus one initial residual per refinement pass.
    assert tl.CG_COUNTERS.window_matvecs - before > iters > 0
    diff = port.numpy() - ref
    assert np.abs(diff - diff.mean()).max() < 1e-6
