"""The port's window SpMV (`dots_socp_torch.ops.window_spmv`) against the JAX
package's Pallas window kernel (interpret mode) and the assembled matrix.
The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dots_socp_torch.ops import window_spmv as tw
from dots_socp_tpu.geometry.generators import generate_plane_mesh
from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
from dots_socp_tpu.ops import pallas_spmv as jw


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(7)
    vertices, triangles, _ = generate_plane_mesh(n=7)
    vertices = vertices.copy()
    vertices[:, 2] = 0.03 * rng.standard_normal(vertices.shape[0])
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    return vertices, lap


def _operators(mesh, group):
    vertices, lap = mesh
    ref = jw.build_window_tiles(lap, tile_rows=64, coords=vertices, group=group)
    port = tw.build_window_tiles(lap, tile_rows=64, coords=vertices, group=group)
    assert ref is not None and port is not None
    return ref, port


@pytest.mark.parametrize("group", [1, 2, None])
def test_builder_arrays_equal_reference(mesh, group):
    """perm, iperm, starts, sub_off, W and Ws are exactly the reference
    builder's, and the compressed nonzeros scatter back to exactly its
    dense tiles."""
    ref, port = _operators(mesh, group)
    a_tiles, starts, sub_off, ws, perm, iperm, meta = ref
    np.testing.assert_array_equal(port.starts, starts)
    np.testing.assert_array_equal(port.sub_off, sub_off)
    np.testing.assert_array_equal(port.perm, perm)
    np.testing.assert_array_equal(port.iperm, iperm)
    assert port.ws == ws
    assert {k: port.meta[k] for k in meta} == meta

    g = meta["group"]
    np.testing.assert_array_equal(port.tile_start, np.repeat(starts, g) + sub_off)
    assert port.lcol.shape[0] == a_tiles.shape[0]
    assert port.meta["nnz_width"] == int((a_tiles != 0).sum(axis=1).max())
    dense = np.zeros_like(a_tiles)
    rows = np.repeat(np.arange(port.lcol.shape[0]), port.lcol.shape[1])
    np.add.at(dense, (rows, port.lcol.ravel()), port.vals.ravel())
    np.testing.assert_array_equal(dense, a_tiles)


@pytest.mark.parametrize("group", [1, 2, None])
def test_plain_matvec_matches_pallas_and_assembled(mesh, group):
    """The plain version equals the Pallas kernel (interpret mode) and the
    assembled matrix in f32 at rtol = atol = 2e-5 (the reference test's
    bound), for x of shape (6, V) in permuted order."""
    vertices, lap = mesh
    ref, port = _operators(mesh, group)
    a_tiles, starts, sub_off, ws, perm, iperm, _ = ref
    dummy = jnp.zeros(0)
    jop = jw.WindowOperator(
        a_tiles=jnp.asarray(a_tiles), starts=jnp.asarray(starts),
        sub_off=jnp.asarray(sub_off), ws_marker=jnp.zeros((ws,), dtype=jnp.int8),
        perm=jnp.asarray(perm), iperm=jnp.asarray(iperm),
        av_p=dummy, jacobi_p=dummy, s_p=dummy, defl_q_p=dummy,
    )
    v = vertices.shape[0]
    top = tw.window_operator(
        port, np.ones(v), np.ones((6, v)), np.ones(v), np.zeros((v, 0))
    )

    rng = np.random.default_rng(31)
    x = rng.standard_normal((6, v)).astype(np.float32)
    xp = x[:, perm]
    y_ref = np.asarray(jw.window_matvec(jop, jnp.asarray(xp), interpret=True))
    y_port = tw.window_matvec_plain(top, torch.from_numpy(xp)).numpy()
    np.testing.assert_allclose(y_port, y_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y_port[:, iperm], (lap @ x.T).T, rtol=2e-5, atol=2e-5)

    # The wrapper takes the plain version on a CPU tensor and counts no launch.
    before = tw.KERNEL_LAUNCHES
    y_wrap = tw.window_matvec(top, torch.from_numpy(xp))
    assert tw.KERNEL_LAUNCHES == before
    np.testing.assert_array_equal(y_wrap.numpy(), y_port)
    # A single mode (1-D x) keeps its shape.
    y1 = tw.window_matvec(top, torch.from_numpy(xp[0]))
    np.testing.assert_array_equal(y1.numpy(), y_port[0])


def test_builder_refuses_windows_beyond_shared_memory():
    """A matrix whose every tile spans more columns than one block's shared
    memory holds (W * 32 modes * 4 B > 227 KB) gets no window operator: the
    builder returns None and the CG operator keeps the ELL matvec."""
    from dots_socp_torch.ops.laplacian import build_cg_operator

    v = 4096
    # A random 6-regular-ish graph is an expander: no ordering keeps a
    # 256-row tile's columns within 1,816 consecutive vertices.
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(v), 3)
    off = sp.coo_matrix((np.ones(3 * v), (rows, rng.integers(0, v, 3 * v))), shape=(v, v))
    adj = (off + off.T).tocsr()
    lap = adj - sp.diags(np.asarray(adj.sum(axis=1)).ravel())
    assert tw.build_window_tiles(lap, tile_rows=256, group=1) is None
    op = build_cg_operator(3, 1 / 3, np.ones(v), lap, deflation_k=0)
    assert op.window is None
