"""The port's per-shard window SpMV (`dots_socp_torch.ops.sharded_window`,
kernel B2's module) against the JAX package: the builder's arrays, the
matvec on four gloo CPU ranks (the plain version; JAX's Pallas kernel in
interpret mode under shard_map), the window permutes, and the refined
sharded CG solve against the unsharded port. The CUDA kernel itself is
tested on the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dots_socp_torch.convert import problem_from_reference
from dots_socp_torch.ops import laplacian as tl
from dots_socp_torch.ops import sharded_window as tsw
from dots_socp_torch.parallel.distributed import SolverMesh
from dots_socp_torch.parallel.mesh import shard_problem
from dots_socp_torch.solver import problem as t_problem
from dots_socp_tpu.ops import sharded_window as jsw
from torch_rank_worker import geometry_inputs, run_ranks

N_TIME = 6
S = 4
PROBLEM_KW = dict(dtype="float32", laplacian_mode="cg", cg_deflation_k=16, cg_rtol=1e-7)


@pytest.fixture(scope="module")
def blocked():
    """The blocked 4-shard plane n=40 problem of tests/test_sharded_window.py
    (JAX side, sharded window forced), its padded Laplacian and the geometry."""
    from dots_socp_tpu.data.loader import load_example
    from dots_socp_tpu.geometry.normalize import normalize_geometry
    from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
    from dots_socp_tpu.ops.laplacian import build_cg_operator
    from dots_socp_tpu.solver.problem import build_problem

    _, geometry, _ = load_example(example_name="plane", kwargs_generating_mesh={"n": 40})
    geometry, _ = normalize_geometry(geometry)
    config, data, extras = build_problem(
        N_TIME, geometry, phi_refine=True, space_partitions=S, mesh_axes=(1, S), **PROBLEM_KW
    )
    tri = np.asarray(geometry["triangles"])
    _, angles, _ = triangle_quantities(np.asarray(geometry["vertices"]), tri)
    lap_p = cotan_laplacian(extras["vertex_slot"][tri], angles, config.n_vertices)
    op = build_cg_operator(
        N_TIME, config.stepsize_time, np.asarray(data.ops.av, np.float64), lap_p,
        deflation_k=16, rtol=1e-7, use_pallas_spmv=True, shard_parts=S, refine=True,
        spmv_tile_rows=128,
    )
    assert op.swindow is not None
    return geometry, config, data._replace(cg_op=op), extras, lap_p


def _builder_inputs(config, data):
    av = np.asarray(data.ops.av, np.float64)
    rng = np.random.default_rng(4)
    return dict(
        v_chunk=config.n_vertices // S, n_parts=S, av=av,
        jacobi=rng.random((N_TIME + 1, av.shape[0])), s_vec=1.0 / np.sqrt(av),
        defl_q=rng.standard_normal((av.shape[0], 5)), real=(av > 0).astype(np.float64),
    )


@pytest.mark.parametrize("tile_rows", [64, 128])
def test_builder_arrays_equal_reference(blocked, tile_rows):
    """(c) With a forced TV: the compressed nonzeros scattered back to dense
    equal JAX's a_tiles; tile starts, exp_codes, win_codes, state_in,
    state_out and the window-layout copies are equal."""
    _, config, data, _, lap_p = blocked
    kw = _builder_inputs(config, data)
    ref, _ = jsw.build_sharded_window(lap_p, tile_rows=tile_rows, **kw)
    port, meta = tsw.build_sharded_window(lap_p, tile_rows=tile_rows, **kw)
    assert port.tile_rows == meta["tile_rows"] == tile_rows
    n_rows = port.lcol.shape[1]
    n_tiles = n_rows // tile_rows
    a_tiles = np.asarray(ref.a_tiles)
    assert port.width == a_tiles.shape[2]
    g = ref.sub_off.shape[1] // ref.starts.shape[1]
    ref_start = np.repeat(np.asarray(ref.starts), g, axis=1) + np.asarray(ref.sub_off)
    np.testing.assert_array_equal(port.tile_start, ref_start[:, :n_tiles])
    dense = np.zeros((S, n_rows, port.width), np.float32)
    for s in range(S):
        rows = np.repeat(np.arange(n_rows), port.lcol.shape[2])
        np.add.at(dense[s], (rows, port.lcol[s].ravel()), port.vals[s].ravel())
    np.testing.assert_array_equal(dense, a_tiles[:, :n_rows])
    assert not a_tiles[:, n_rows:].any()
    for name in ("exp_codes", "win_codes", "state_in", "state_out",
                 "av_p", "jacobi_p", "s_p", "defl_q_p", "real_p"):
        np.testing.assert_array_equal(getattr(port, name), np.asarray(getattr(ref, name)), err_msg=name)


def test_problem_from_reference_gives_each_rank_its_shard(blocked):
    """convert.problem_from_reference of JAX's sharded problem, cut to each
    rank's shard, equals the port's own problem cut the same way (same TV):
    halo tables, window operator, ops, f64 ops and the CG leaves."""
    geometry, config, data, _, lap_p = blocked
    _, ref_data = problem_from_reference(config, jax.tree.map(np.asarray, data))
    pc, pd, _ = t_problem.build_problem(
        N_TIME, geometry, phi_refine="on", space_partitions=S, mesh_axes=(1, S),
        device="cpu", **PROBLEM_KW,
    )
    op = tl.build_cg_operator(
        N_TIME, pc.stepsize_time, pd.ops.av.double().numpy(), lap_p, deflation_k=16,
        rtol=1e-7, refine=True, shard_parts=S, spmv_tile_rows=128,
    )
    pd = pd._replace(cg_op=op)
    for rank in range(S):
        mesh = SolverMesh(space=S, rank=rank, device=torch.device("cpu"))
        _, a = problem_from_reference(config, jax.tree.map(np.asarray, data), mesh=mesh)
        b = shard_problem(mesh, pd)
        assert a.mesh is b.mesh is mesh
        for part in ("ops", "ops_hi", "halo"):
            for name, x, y in zip(getattr(a, part)._fields, getattr(a, part), getattr(b, part)):
                np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f"{part}.{name}")
        sa, sb = a.cg_op.swindow, b.cg_op.swindow
        for name in tsw.ShardedWindow._fields:
            x, y = getattr(sa, name), getattr(sb, name)
            if name == "tile_start":  # JAX pads the tiles to a multiple of G
                x = x[: y.shape[0]]
            if name in ("lcol", "vals"):
                x = x[: y.shape[0]]
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)
        for name in ("jacobi", "defl_q", "s", "av_unit", "real_mask", "ell_w_hi", "av_hi"):
            np.testing.assert_allclose(
                getattr(a.cg_op, name).numpy(), getattr(b.cg_op, name).numpy(),
                rtol=1e-6 if name == "defl_q" else 0, err_msg=name,
            )
    assert ref_data.cg_op.swindow.tile_start.shape[0] == S


@pytest.fixture(scope="module")
def window_ranks(blocked, tmp_path_factory):
    """Four gloo CPU ranks: B2's matvec (plain version) through the window
    permutes, the permute round trip, and the refined sharded cg_solve."""
    geometry, config, _, extras, _ = blocked
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N_TIME + 1, config.n_vertices)).astype(np.float32)
    v_real = np.asarray(geometry["vertices"]).shape[0]
    rhs_real = rng.standard_normal((N_TIME + 1, v_real))
    rhs_real -= rhs_real.mean(axis=1, keepdims=True)
    rhs = np.zeros((N_TIME + 1, config.n_vertices), np.float32)
    rhs[:, extras["vertex_slot"]] = rhs_real
    ranks = run_ranks(
        tmp_path_factory.mktemp("window"), "window", S,
        dict(geometry_inputs(geometry), n_time=N_TIME, x=x, rhs=rhs),
    )
    return x, rhs_real, ranks


def test_sharded_matvec_matches_reference_and_dense(blocked, window_ranks):
    """(d) The assembled shards' L x against the dense L x and against JAX's
    sharded_window_matvec (interpret mode): f32, relative 1e-5 of max|y|.
    The permute round trip is exact."""
    _, _, data, _, lap_p = blocked
    x, _, ranks = window_ranks
    y = np.concatenate([r["y"] for r in ranks], axis=-1)
    y_dense = x.astype(np.float64) @ lap_p.toarray().T
    scale = np.abs(y_dense).max()
    assert np.abs(y - y_dense).max() <= 1e-5 * scale

    from dots_socp_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(S, time_axis=1)
    sw = data.cg_op.swindow
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "space")))

    @jax.jit
    def mv(x, sw):
        xw = jsw.window_permute(sw, (1, S), x)
        return jsw.window_permute(sw, (1, S), jsw.sharded_window_matvec(sw, (1, S), xw), inverse=True)

    y_ref = np.asarray(mv(xd, sw))
    assert np.abs(y - y_ref).max() <= 1e-5 * scale
    np.testing.assert_array_equal(np.concatenate([r["round_trip"] for r in ranks], axis=-1), x)


def test_sharded_refined_cg_matches_unsharded(blocked, window_ranks):
    """(e) The refined CG on four shards (f32 inner CG on B2's plain
    version, f64 true residual through the halo incidence form) against the
    unsharded port's refined CG: relative 1e-5, the bound of
    tests/test_sharded_window.py. Every inner matvec of every rank went
    through the sharded window."""
    geometry, _, _, extras, _ = blocked
    _, rhs_real, ranks = window_ranks
    cfg_u, data_u, ex_u = t_problem.build_problem(
        N_TIME, geometry, phi_refine="on", device="cpu", **PROBLEM_KW
    )
    rhs_u = np.zeros((N_TIME + 1, cfg_u.n_vertices), np.float32)
    rhs_u[:, ex_u["vertex_slot"]] = rhs_real
    x_u = tl.cg_solve(data_u.ops, data_u.cg_op, torch.from_numpy(rhs_u), max_iters=2000)
    x_u = x_u.numpy()[:, ex_u["vertex_slot"]]
    x_s = np.concatenate([r["cg_x"] for r in ranks], axis=-1)[:, extras["vertex_slot"]]
    assert x_s.dtype == np.float64
    assert np.abs(x_u - x_s).max() <= 1e-5 * np.abs(x_u).max()
    for r in ranks:
        assert r["cg_window_matvecs"] > r["cg_iters"] > 0
        assert r["cg_b2_launches"] == 0  # CPU tensors: the plain version
        # The kernel reads the state in place: every matvec got contiguous tensors.
        assert r["cg_spied_matvecs"] == r["cg_window_matvecs"] and r["cg_strided_matvecs"] == 0


def _fused_kernel_numpy(sw, x_local, buf):
    """What kernel B2 computes on one shard, step by step in numpy: window
    position p holds x_local[:, c] for c = win_codes[p] < v_chunk, buf[:, c -
    v_chunk] below v_chunk + S * Wb, else 0; each row sums vals * window at
    tile_start[row // TV] + lcol over its DP slots, in float32."""
    v_chunk, n_buf = x_local.shape[1], buf.shape[1]
    codes = np.asarray(sw.win_codes)
    assert codes.dtype == np.int32
    window = np.zeros((x_local.shape[0], codes.shape[0]), np.float32)
    own = codes < v_chunk
    remote = ~own & (codes < v_chunk + n_buf)
    window[:, own] = x_local[:, codes[own]]
    window[:, remote] = buf[:, codes[remote] - v_chunk]
    start = np.repeat(np.asarray(sw.tile_start), sw.tile_rows)[:v_chunk].astype(np.int64)
    cols = start[:, None] + np.asarray(sw.lcol)[:v_chunk]
    assert cols.max() < codes.shape[0]
    y = np.zeros((x_local.shape[0], v_chunk), np.float32)
    for k in range(cols.shape[1]):  # slot order, as one thread sums a row
        y += np.asarray(sw.vals)[:v_chunk, k] * window[:, cols[:, k]]
    return y


@pytest.mark.parametrize("widen", [False, True], ids=["D7", "D9"])
@pytest.mark.parametrize("lanes", [8, 32, 128])
def test_fused_window_codes_match_reference_and_dense(blocked, lanes, widen):
    """What kernel B2 reads (int32 window codes, tile starts, (lcol, vals)
    padded to a multiple of 4 slots, the shard's state and the export
    buffer), for 8, 32 and 128 modes, at the mesh's row width and at a wider
    one: the kernel's arithmetic written out in numpy, and the port's
    `shard_spmv` on CPU tensors, against the assembled scipy matrix and
    JAX's sharded_window_matvec (interpret mode), f32, within 1e-5 * max|y|."""
    import scipy.sparse as sp
    from dots_socp_tpu.parallel.mesh import make_mesh

    _, config, data, _, lap_p = blocked
    lap = lap_p.tocsr()
    if widen:
        v = lap.shape[0]
        lap = (lap + sp.diags([np.full(v - 3, 0.25), np.full(v - 3, 0.25)], [3, -3])).tocsr()
    kw = _builder_inputs(config, data)
    ref, _ = jsw.build_sharded_window(lap, tile_rows=128, **kw)
    host, meta = tsw.build_sharded_window(lap, tile_rows=128, n_modes=lanes, **kw)
    assert (meta["nnz_width"] == 7) != widen
    assert meta["nnz_pad"] == -(-meta["nnz_width"] // 4) * 4 == host.lcol.shape[2]
    sw_all = tsw.sharded_window_to_torch(host)
    assert sw_all.win_codes.dtype == torch.int32 and sw_all.nnz_width == meta["nnz_width"]

    v_chunk = config.n_vertices // S
    x = np.random.default_rng(lanes).standard_normal((lanes, S * v_chunk)).astype(np.float32)
    shards = [tsw.shard_of(sw_all, s) for s in range(S)]
    xs = [tsw.window_permute(sw, torch.from_numpy(x[:, s * v_chunk:(s + 1) * v_chunk]))
          for s, sw in enumerate(shards)]
    buf = torch.cat([xl[..., sw.exp_codes] for sw, xl in zip(shards, xs)], dim=-1)
    y_kernel, y_port = [], []
    for sw, xl in zip(shards, xs):
        before = tsw.KERNEL_LAUNCHES
        y = tsw.shard_spmv(sw, xl, buf)
        assert tsw.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
        y_port.append(tsw.window_permute(sw, y, inverse=True).numpy())
        y_np = _fused_kernel_numpy(sw, xl.numpy(), buf.numpy())
        y_kernel.append(y_np[:, sw.state_out.numpy()])
    y_port, y_kernel = np.concatenate(y_port, axis=-1), np.concatenate(y_kernel, axis=-1)
    y_dense = (lap @ x.astype(np.float64).T).T
    scale = np.abs(y_dense).max()
    assert np.abs(y_port - y_dense).max() <= 1e-5 * scale
    assert np.abs(y_kernel - y_dense).max() <= 1e-5 * scale

    mesh = make_mesh(S, time_axis=1)
    sw_ref = jax.tree.map(jnp.asarray, ref)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "space")))

    @jax.jit
    def mv(x, sw):
        xw = jsw.window_permute(sw, (1, S), x)
        return jsw.window_permute(sw, (1, S), jsw.sharded_window_matvec(sw, (1, S), xw), inverse=True)

    y_ref = np.asarray(mv(xd, sw_ref))
    assert np.abs(y_port - y_ref).max() <= 1e-5 * scale
    assert np.abs(y_kernel - y_ref).max() <= 1e-5 * scale


def test_sharded_builder_picks_the_cheapest_candidate(blocked):
    """Unpinned, `build_sharded_window` returns the first of
    `tile_candidates` for one shard's rows, which is what pinning that size
    gives: the same TV and W on every shard, with whole tiles."""
    from dots_socp_torch.ops.window_spmv import fits_block, tile_candidates

    _, config, data, _, lap_p = blocked
    kw = _builder_inputs(config, data)
    free, meta = tsw.build_sharded_window(lap_p, **kw)
    v_chunk = config.n_vertices // S
    tv = tile_candidates(v_chunk)[0]
    same, pinned = tsw.build_sharded_window(lap_p, tile_rows=tv, **kw)
    assert meta == pinned and meta["tile_rows"] == tv
    assert fits_block(tv, meta["width"], meta["nnz_width"])
    for a, b in zip(free, same):
        np.testing.assert_array_equal(a, b)
    assert free.tile_rows == tv
    assert free.lcol.shape[:2] == (S, free.tile_start.shape[1] * tv)
    assert free.tile_start.shape[1] * tv >= v_chunk
