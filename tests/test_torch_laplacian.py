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


def test_spectral_solve_float32_matches_reference(mesh):
    """The float32 factor and solve against the JAX package's float32 ones
    on the same seeded right-hand side: both round q and the products to
    float32 and sum in other orders, so the bound is float32 rounding of a
    (T+1, V) x (V, V) product chain, 1e-5 of max|z|."""
    vertices, _, lap, av = mesh
    jf = jl.build_spectral_factor(T, DT, av, lap, dtype=jnp.float32)
    tf = tl.build_spectral_factor(T, DT, av, lap, dtype=torch.float32)
    for name in tl.SpectralFactor._fields:
        assert getattr(tf, name).dtype == torch.float32, name
        np.testing.assert_allclose(_np(getattr(tf, name)), np.asarray(getattr(jf, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    rhs = np.random.default_rng(13).standard_normal((T + 1, av.shape[0])).astype(np.float32)
    ref = np.asarray(jl.spectral_solve(jf, jnp.asarray(rhs)))
    port = tl.spectral_solve(tf, torch.from_numpy(rhs)).numpy()
    assert ref.dtype == port.dtype == np.float32
    assert np.abs(port - ref).max() <= 1e-5 * np.abs(ref).max()


def _serial_fma_matmul(a, b):
    """a @ b as the card's SGEMM may sum it: one chain over all of K per
    output, each step a float64 multiply-add rounded to float32."""
    a64, b64 = a.double(), b.double()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for k in range(a.shape[1]):
        acc = (acc + a64[:, k:k + 1] * b64[k:k + 1, :]).float().double()
    return acc.float()


def _serial_fma_blocked(a, b):
    """`blocked_matmul`'s partition of K, each block one serial chain as
    above; the partials summed as the port sums them."""
    k = a.shape[1]
    block = tl.chain_length(k)
    full = k - k % block
    out = torch.stack([_serial_fma_matmul(a[:, i:i + block], b[i:i + block])
                       for i in range(0, full, block)]).sum(0)
    return out + _serial_fma_matmul(a[:, full:], b[full:]) if full < k else out


def test_short_chains_hold_the_host_accuracy(monkeypatch):
    """The fault and its repair, with the card's summation order emulated on
    the CPU. On a pencil with K = 2,392 (plane n45, ntime 7), against the
    float64 solve in the energy norm (`spectral_floor.energy_norm`): one
    serial chain over all of K per output is at least 2x the error of the
    host BLAS product over all of K (the port's CPU path before the chains;
    measured 2.8x), and the same chains over the port's
    blocks of K (13 of 184) are within 1.25x of it (measured 0.8x). The
    port's own solve on the CPU is within 1.25x too."""
    from dots_socp_torch.scripts.spectral_floor import _long_matmul, energy_norm

    rng = np.random.default_rng(7)
    vertices, triangles, _ = generate_plane_mesh(n=45)
    vertices = vertices.copy()
    vertices[:, 2] = 0.03 * rng.standard_normal(vertices.shape[0])
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    av = np.asarray(j_mesh.build_surface_ops(vertices, triangles, dtype=jnp.float64).av)
    assert av.shape[0] >= 2048 and tl.chain_length(av.shape[0]) == 184
    n_time = 7
    pairs = tl.spectral_eigenpairs(n_time, 1.0 / n_time, av, lap, torch.float64)
    energy = energy_norm(pairs)
    f32 = tl.spectral_factor_from_eigh(*pairs, dtype=torch.float32)
    f64 = tl.spectral_factor_from_eigh(*pairs, dtype=torch.float64)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((n_time + 1, av.shape[0])))
    smooth = tl.spectral_solve(f64, g)
    for rhs in (g, smooth / smooth.norm()):
        z64 = tl.spectral_solve(f64, rhs)
        err = {}
        for name, product in (("solver", tl.blocked_matmul), ("host_blas", _long_matmul),
                              ("one_chain", _serial_fma_matmul),
                              ("chains", _serial_fma_blocked)):
            monkeypatch.setattr(tl, "blocked_matmul", product)
            z = tl.spectral_solve(f32, rhs.float()).double()
            err[name] = float(energy(z - z64) / energy(z64))
        monkeypatch.undo()
        assert err["one_chain"] >= 2 * err["host_blas"], err
        assert err["chains"] <= 1.25 * err["host_blas"], err
        assert err["solver"] <= 1.25 * err["host_blas"], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [3 * 16, 3 * 16 + 5, 11], ids=["whole_blocks", "ragged", "one_block"])
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "columns"])
def test_blocked_matmul_sums_the_block_products(dtype, k, transposed):
    """`blocked_matmul` is the sum over K's blocks of per-block products:
    whole blocks, a ragged last block, K under one block; b row-major (the
    first product's q) or a transposed view (the second's q.T), a a view
    into a larger array. float32 within 1e-6 of max|y|, float64 within
    1e-13."""
    block, m, n = 16, 6, 9
    gen = torch.Generator().manual_seed(k)
    a = torch.randn(m + 2, k + 3, generator=gen, dtype=dtype)[2:, 3:]
    b = torch.randn(n, k, generator=gen, dtype=dtype).T if transposed else torch.randn(
        k, n, generator=gen, dtype=dtype)
    full = k - k % block
    parts = [a[:, i:i + block] @ b[i:i + block] for i in range(0, full, block)]
    ref = torch.stack(parts).sum(0) if parts else torch.zeros(m, n, dtype=dtype)
    if full < k:
        ref = ref + a[:, full:] @ b[full:]
    out = tl.blocked_matmul(a, b, block=block)
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    assert out.shape == (m, n) and out.dtype == dtype and out.is_contiguous()
    assert (out - ref).abs().max() <= tol * ref.abs().max()
    assert (out - a @ b).abs().max() <= 10 * tol * ref.abs().max()


@pytest.mark.parametrize("k, length", [(4096, 256), (12288, 256), (4810, 185), (2958, 174),
                                       (4813, 256), (100, 256)])
def test_chain_length_splits_k_evenly_where_it_can(k, length):
    """The sweep's padded meshes (4,096, 12,288), the flagship (plane n64),
    config 3's plane n50; a prime K and one under half a chain take 256."""
    assert tl.chain_length(k) == length


def test_ell_matvec_matches_reference(mesh):
    vertices, _, lap, av = mesh
    jop = jl.build_cg_operator(T, DT, av, lap, dtype=jnp.float64, deflation_k=0, use_pallas_spmv=False)
    top = tl.build_cg_operator(T, DT, av, lap, dtype=torch.float64, deflation_k=0)
    x = np.random.default_rng(12).standard_normal((T + 1, av.shape[0]))
    ref = np.asarray(jl.ell_matvec(jop, jnp.asarray(x)))
    port = tl.ell_matvec(top, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(port, (lap @ x.T).T, rtol=1e-12, atol=1e-12)


def _rhs(av, seed, n_time=T):
    rhs = np.random.default_rng(seed).standard_normal((n_time + 1, av.shape[0]))
    return rhs - rhs.mean()


def test_cg_solve_f64_matches_reference(mesh):
    """Plain f64 CG (no refinement; the port's matvec is the float64 window
    operator's plain version, the JAX package's the ELL gather) at rtol
    1e-10: the same inner iteration count, and the mean-removed difference
    <= 1e-8."""
    vertices, triangles, lap, av = mesh
    jops = j_mesh.build_surface_ops(vertices, triangles, dtype=jnp.float64)
    tops = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64)
    jop = jl.build_cg_operator(T, DT, av, lap, dtype=jnp.float64, deflation_k=8, use_pallas_spmv=False)
    top = tl.build_cg_operator(T, DT, av, lap, dtype=torch.float64, deflation_k=8)
    assert top.window.vals.dtype == torch.float64  # f64 work dtype: B1-f64's operator
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


@pytest.mark.parametrize("n_time", [T, 127], ids=["6_modes", "128_modes"])
def test_cg_solve_refined_window_matches_reference(mesh, n_time):
    """The refined path: f64 true residual around the f32 inner CG on the
    window SpMV (port: plain version; JAX: Pallas interpret mode), at 6
    time modes and at 128 (ntime 127: four mode groups of 32). Same bound
    as the reference's own test (test_ops.py:485): 1e-6."""
    vertices, triangles, lap, av = mesh
    jops = j_mesh.build_surface_ops(vertices, triangles, dtype=jnp.float64)
    tops = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64)
    kw = dict(deflation_k=8, spmv_tile_rows=64, refine=True)
    jop = jl.build_cg_operator(n_time, 1.0 / n_time, av, lap, dtype=jnp.float64,
                               use_pallas_spmv=True, **kw)
    top = tl.build_cg_operator(n_time, 1.0 / n_time, av, lap, dtype=torch.float64, **kw)
    rhs = _rhs(av, 34, n_time)
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
