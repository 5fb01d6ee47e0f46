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
    """JAX's tiles with its super-windows G pinned to `group`
    (None: its own choice) and the port's, both at TV = 64. The CUDA kernel
    has no super-windows: the port's tiles must not depend on G."""
    vertices, lap = mesh
    ref = jw.build_window_tiles(lap, tile_rows=64, coords=vertices, group=group)
    port = tw.build_window_tiles(lap, tile_rows=64, coords=vertices)
    assert ref is not None and port is not None
    return ref, port


@pytest.mark.parametrize("group", [1, 2, None])
def test_builder_arrays_equal_reference(mesh, group):
    """With TV pinned on both sides: the ordering, perm, iperm, W and every
    tile's window start (the reference's starts[t // G] + sub_off[t]) are
    exactly the reference's, whatever its G, and the compressed
    nonzeros (padded to a multiple of 4 slots) scatter back to exactly its
    dense tiles."""
    ref, port = _operators(mesh, group)
    a_tiles, starts, sub_off, ws, perm, iperm, meta = ref
    np.testing.assert_array_equal(port.perm, perm)
    np.testing.assert_array_equal(port.iperm, iperm)
    for key in ("ordering", "tile_rows", "width"):
        assert port.meta[key] == meta[key], key

    g = meta["group"]
    n_tiles = port.tile_start.shape[0]
    np.testing.assert_array_equal(port.tile_start, (np.repeat(starts, g) + sub_off)[:n_tiles])
    n_rows = n_tiles * 64
    assert not a_tiles[n_rows:].any()  # the reference pads its tiles to a multiple of G
    a_tiles = a_tiles[:n_rows]
    assert port.lcol.shape == port.vals.shape == (n_rows, port.meta["nnz_pad"])
    assert port.meta["nnz_pad"] % 4 == 0 and 0 <= port.meta["nnz_pad"] - port.meta["nnz_width"] < 4
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
    assert tw.build_window_tiles(lap, tile_rows=256) is None
    op = build_cg_operator(3, 1 / 3, np.ones(v), lap, deflation_k=0)
    assert op.window is None


def _widened(lap):
    """`lap` with two more symmetric off-diagonals: rows of 9 nonzeros, a
    row width D that is not the mesh's 7 (DP = 12)."""
    v = lap.shape[0]
    extra = sp.diags([np.full(v - 3, 0.25), np.full(v - 3, 0.25)], [3, -3])
    return (lap + extra).tocsr()


@pytest.mark.parametrize("widen", [False, True], ids=["D7", "D9"])
@pytest.mark.parametrize("lanes", [8, 32, 128])
def test_padded_rows_match_pallas_and_assembled(mesh, lanes, widen):
    """What the CUDA kernel reads (tile starts, (lcol, vals) padded to a
    multiple of 4 slots, modes-major x) through the plain version, for 8, 32
    and 128 modes, at the mesh's row width and at a wider one: against the
    assembled scipy matrix and the Pallas kernel (interpret mode), f32,
    within 1e-5 * max|y|."""
    vertices, lap = mesh
    if widen:
        lap = _widened(lap)
    ref = jw.build_window_tiles(lap, tile_rows=64, coords=vertices, group=1)
    port = tw.build_window_tiles(lap, tile_rows=64, coords=vertices, n_modes=lanes)
    a_tiles, starts, sub_off, ws, perm, iperm, _ = ref
    np.testing.assert_array_equal(port.perm, perm)
    d = port.meta["nnz_width"]
    assert (d == 7) != widen and port.meta["nnz_pad"] == -(-d // 4) * 4 == port.lcol.shape[1]
    assert not port.vals[:, d:].any() and not port.lcol[:, d:].any()

    v = vertices.shape[0]
    top = tw.window_operator(port, np.ones(v), np.ones((1, v)), np.ones(v), np.zeros((v, 0)))
    assert top.nnz_width == d and top.lcol.dtype == torch.int32 and top.lcol.is_contiguous()
    x = np.random.default_rng(lanes).standard_normal((lanes, v)).astype(np.float32)
    xp = np.ascontiguousarray(x[:, perm])
    y_port = tw.window_matvec(top, torch.from_numpy(xp)).numpy()
    y_dense = (lap @ x.astype(np.float64).T).T
    scale = np.abs(y_dense).max()
    assert np.abs(y_port[:, iperm] - y_dense).max() <= 1e-5 * scale

    dummy = jnp.zeros(0)
    jop = jw.WindowOperator(
        a_tiles=jnp.asarray(a_tiles), starts=jnp.asarray(starts),
        sub_off=jnp.asarray(sub_off), ws_marker=jnp.zeros((ws,), dtype=jnp.int8),
        perm=jnp.asarray(perm), iperm=jnp.asarray(iperm),
        av_p=dummy, jacobi_p=dummy, s_p=dummy, defl_q_p=dummy,
    )
    y_ref = np.asarray(jw.window_matvec(jop, jnp.asarray(xp), interpret=True))
    assert np.abs(y_port - y_ref).max() <= 1e-5 * scale


def test_tile_candidates_fill_the_sms():
    """The tile sizes, in the order the builders take them: multiples of 16
    in [64, 512], first the smallest that cuts the rows into one wave over
    the 132 SMs (352 rows for plane n200's 46,431, 176 for one of two
    shards, 96 for one of four), then two waves, and so on down to 64; a
    pinned size is the only candidate, and one the kernel cannot run is
    refused."""
    cands = tw.tile_candidates(46_431)
    assert cands == (352, 176, 128, 96, 80, 64)
    assert all(-(-46_431 // tv) <= 132 * (k + 1) for k, tv in enumerate(cands[:4]))
    assert tw.tile_candidates(23_216)[0] == 176 and tw.tile_candidates(11_608)[0] == 96
    # Four mode groups: four blocks per tile, so larger tiles fill a wave;
    # where one wave would need over 512 rows, the first candidate has more.
    assert tw.tile_candidates(11_608, groups=4)[0] == 352
    assert tw.tile_candidates(46_431, groups=4)[0] == 480
    assert tw.tile_candidates(1000) == (64,)
    assert tw.tile_candidates(1000, tile_rows=96) == (96,)
    for bad in (8, 100, 528):
        with pytest.raises(ValueError):
            tw.tile_candidates(1000, tile_rows=bad)


def test_tile_cost_ranks_as_measured():
    """Shared memory of a block is the mbarrier, the (lcol, vals) block and
    the larger of window and output tile; a block beyond 227 KB does not
    fit; and on the windows of plane n200 (widths as `build_window_tiles`
    finds them) the first candidate that fits is the size timed fastest on
    an H100 (PERF.md): TV=352 for B1, 176 for one of two shards, 96 for one
    of four."""
    assert tw.smem_bytes(352, 760, 8) == 16 + 352 * 64 + 32 * 761 * 4
    assert tw.smem_bytes(64, 8, 8) == 16 + 64 * 64 + 32 * 65 * 4
    assert not tw.fits_block(256, 1816, 7) and tw.fits_block(256, 1680, 7)
    b1 = {64: 472, 96: 504, 128: 536, 176: 584, 256: 664, 352: 760, 512: 920}
    s2 = {64: 480, 96: 512, 128: 544, 176: 592, 256: 672, 512: 928}
    s4 = {64: 472, 96: 504, 128: 536, 256: 664, 512: 920}
    for rows, widths, fastest in ((46_431, b1, 352), (23_216, s2, 176), (11_608, s4, 96)):
        first = next(tv for tv in tw.tile_candidates(rows) if tw.fits_block(tv, widths[tv], 7))
        assert first == fastest


def test_builder_picks_the_cheapest_candidate(mesh, monkeypatch):
    """Unpinned, `build_window_tiles` returns the first of `tile_candidates`
    with the ordering of narrowest window there, which is what pinning that
    size gives, and its arrays cover whole tiles; when the first candidate's
    block does not fit shared memory, the next one is taken."""
    vertices, lap = mesh
    free = tw.build_window_tiles(lap, coords=vertices)
    v = vertices.shape[0]
    tv = tw.tile_candidates(v)[0]
    pinned = tw.build_window_tiles(lap, tile_rows=tv, coords=vertices)
    assert free.meta == pinned.meta and free.meta["tile_rows"] == tv
    for name in ("perm", "tile_start", "lcol", "vals"):
        np.testing.assert_array_equal(getattr(free, name), getattr(pinned, name))
    assert free.lcol.shape[0] == free.tile_start.shape[0] * tv >= v
    assert free.meta["smem_bytes"] == tw.smem_bytes(tv, free.meta["width"], free.meta["nnz_pad"])

    # A path graph of 66,000 vertices: one wave needs 512-row tiles; with
    # room for less than their block, the two-wave size is taken.
    n = 66_000
    path = sp.diags([np.ones(n - 1), -2 * np.ones(n), np.ones(n - 1)], [-1, 0, 1]).tocsr()
    assert tw.tile_candidates(n)[:2] == (512, 256)
    assert tw.build_window_tiles(path).meta["tile_rows"] == 512
    monkeypatch.setattr(tw, "SMEM_BYTES", 50_000)
    assert tw.smem_bytes(512, 520, 4) > 50_000 > tw.smem_bytes(256, 264, 4)
    assert tw.build_window_tiles(path).meta["tile_rows"] == 256


def test_bench_helpers_match_assembled(mesh):
    """The kernel benchmark's CSR form of a window operator (the library
    call's matrix) is the permuted Laplacian, and its bound counts every
    input and output once: x and y per mode, 8 bytes per nonzero (padding
    slots are not charged) and the tile starts; B2's adds the export buffer
    per mode and its int32 window codes once, not per mode."""
    from dots_socp_torch.kernel_timing import operator_csr, shard_bound, window_bound

    vertices, lap = mesh
    v = vertices.shape[0]
    tiles = tw.build_window_tiles(lap, tile_rows=64, coords=vertices)
    top = tw.window_operator(tiles, np.ones(v), np.ones((1, v)), np.ones(v), np.zeros((v, 0)))
    csr = operator_csr(top, v, v)
    p = lap.tocsr()[tiles.perm][:, tiles.perm].astype(np.float32)
    p.eliminate_zeros()
    np.testing.assert_array_equal(csr.to_dense().numpy(), p.toarray())
    bound = window_bound(top, v, 32, v)
    n_tiles = -(-v // 64)
    assert bound["bytes"] == 2 * v * 32 * 4 + p.nnz * 8 + n_tiles * 4
    assert bound["flops"] == 2 * p.nnz * 32 and bound["by"] == "bytes"
    assert bound["ms"] == pytest.approx(bound["bytes"] / 3.35e12 * 1e3)

    # One shard of B2: rows of the same operator, a window of Nw codes and
    # an export buffer of 24 columns.
    from types import SimpleNamespace

    n_window, n_buf = v + 40, 24
    shard = SimpleNamespace(vals=top.vals, tile_rows=64, state_in=torch.zeros(v, dtype=torch.int64),
                            win_codes=torch.zeros(n_window, dtype=torch.int32))
    b2 = shard_bound(shard, 32, n_buf)
    assert b2["bytes"] == bound["bytes"] + n_buf * 32 * 4 + n_window * 4
    assert b2["flops"] == bound["flops"]


@pytest.mark.parametrize("deflation_k", [0, 16])
def test_cg_hands_the_kernel_its_state_contiguous(mesh, deflation_k, monkeypatch):
    """The CUDA kernel reads the CG state modes-major in place and refuses
    anything else, so `cg_solve` must keep every vector it multiplies
    contiguous (T+1, V): no leaf of the window operator and no product of
    the preconditioner may hand its layout on (a column-major `a[:, perm]`
    or `coef @ q.T` would)."""
    from dots_socp_torch.ops import laplacian as tl
    from dots_socp_torch.ops import mesh_ops as t_mesh

    vertices, lap = mesh
    triangles = generate_plane_mesh(n=7)[1]
    area_f, _, _ = triangle_quantities(vertices, triangles)
    from dots_socp_torch.geometry.surface import vertex_areas

    av = vertex_areas(triangles, area_f, vertices.shape[0]) / 3.0
    n_time = 5
    op = tl.build_cg_operator(n_time, 1.0 / n_time, av, lap, dtype=torch.float64,
                              deflation_k=deflation_k, refine=True, coords=vertices)
    assert op.window is not None
    for name in ("jacobi_p", "defl_q_p", "lcol", "vals"):
        assert getattr(op.window, name).is_contiguous(), name
    seen = []

    def spy(wop, x):
        seen.append(x.is_contiguous() and x.dtype == torch.float32)
        return tw.window_matvec(wop, x)

    monkeypatch.setattr(tl, "window_matvec", spy)
    ops = t_mesh.build_surface_ops(vertices, triangles, dtype=torch.float64)
    rhs = np.random.default_rng(9).standard_normal((n_time + 1, av.shape[0]))
    rhs -= rhs.mean()
    tl.cg_solve(ops, op, torch.from_numpy(rhs), max_iters=60, rtol=1e-8)
    assert len(seen) > 10 and all(seen)
