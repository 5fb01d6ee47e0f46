"""The port's space-sharded layer (`dots_socp_torch.parallel`) against the
JAX package: the blocked partition, the halo gathers and reductions on four
gloo CPU ranks, and 30 iterations of the sharded solver (CG path on two
ranks, spectral path on two and four) against the single-device port and
JAX's sharded solver.

The ranks are subprocesses running `tests/torch_rank_worker.py` (no jax),
meeting through a file:// rendezvous in the test's tmp_path; the JAX side
runs here, on the 8-device CPU mesh of conftest.py."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from dots_socp_torch.parallel import distributed as tpd
from dots_socp_torch.parallel import partition as tpart
from dots_socp_tpu.parallel import partition as jpart
from torch_rank_worker import ONE_THREAD_ENV, geometry_inputs, one_thread, run_ranks

REPO = Path(__file__).resolve().parents[1]
N_TIME = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


@pytest.mark.parametrize("n_parts", [2, 4])
def test_partition_matches_reference(plane_geometry, n_parts):
    """(a) The numpy copy of the blocked layout equals JAX's, array for array."""
    tri, v = plane_geometry["triangles"], plane_geometry["vertices"].shape[0]
    ref = jpart.blocked_layout(tri, v, n_parts)
    port = tpart.blocked_layout(tri, v, n_parts)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)


def test_parse_mesh_shape():
    assert tpd.parse_mesh_shape("1x4") == (1, 4)
    assert tpd.parse_mesh_shape("8") == (1, 8)
    assert tpd.parse_mesh_shape(" 1X8 ") == (1, 8)
    assert tpd.parse_mesh_shape("2x4") == (2, 4)
    for bad in ("0x4", "2x4x2", "-1"):
        with pytest.raises(ValueError):
            tpd.parse_mesh_shape(bad)


def test_make_solver_mesh_rejects_time_axis_and_oversubscription(tmp_path):
    """A mesh (with or without a time axis) needs a process group; a mesh
    wider than the process group is refused, as the JAX package refuses more
    devices than it has, and so is one narrower than it."""
    with pytest.raises(RuntimeError, match="torchrun"):
        tpd.make_solver_mesh("2x1", device="cpu")
    assert tpd.initialize_distributed(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", num_processes=1, process_id=0
    )
    try:
        for wide in ("1x4", "2x1", "2x2"):
            with pytest.raises(ValueError, match="devices"):
                tpd.make_solver_mesh(wide, device="cpu")
        mesh = tpd.make_solver_mesh("1", device="cpu")
        assert (mesh.space, mesh.rank, mesh.device.type, mesh.backend) == (1, 0, "cpu", "gloo")
        assert (mesh.time, mesh.time_rank, mesh.world_rank, mesh.time_group) == (1, 0, 0, None)
    finally:
        dist.destroy_process_group()


def test_halo_ops_match_reference(plane_geometry, tmp_path):
    """(b) halo_gather / halo_reduce on four gloo ranks against JAX's under
    shard_map, f64, on the plane n=12 in four blocked shards: within 1e-12."""
    from dots_socp_tpu.parallel.halo import halo_gather, halo_reduce
    from dots_socp_tpu.parallel.mesh import make_mesh, shard_problem
    from dots_socp_tpu.solver.problem import build_problem

    config, data, _ = build_problem(
        N_TIME, plane_geometry, dtype="float64", space_partitions=4, mesh_axes=(1, 4)
    )
    rng = np.random.default_rng(21)
    values = rng.standard_normal((N_TIME + 1, config.n_vertices))
    corners = rng.standard_normal((N_TIME + 1, config.n_triangles, 3))
    ranks = run_ranks(
        tmp_path, "halo", 4,
        dict(geometry_inputs(plane_geometry), n_time=N_TIME, values=values, corners=corners),
    )

    mesh = make_mesh(4, time_axis=1)
    data = shard_problem(mesh, data)
    v_sh = jax.device_put(values, NamedSharding(mesh, P(None, "space")))
    c_sh = jax.device_put(corners, NamedSharding(mesh, P(None, "space", None)))
    ref_g = np.asarray(jax.jit(lambda v, h: halo_gather((1, 4), h, v, (None,)))(v_sh, data.halo))
    ref_r = np.asarray(
        jax.jit(lambda c, h, m: halo_reduce((1, 4), h, m, c, (None,)))(c_sh, data.halo, data.ops.inc_mask)
    )
    got_g = np.concatenate([r["gathered"] for r in ranks], axis=1)
    got_r = np.concatenate([r["reduced"] for r in ranks], axis=1)
    np.testing.assert_allclose(got_g, ref_g, rtol=0, atol=1e-12 * np.abs(ref_g).max())
    np.testing.assert_allclose(got_r, ref_r, rtol=0, atol=1e-12 * np.abs(ref_r).max())


SOLVE_KW = dict(
    nit=30, tol=1e-12, time_limit=300, precision="float64",
    # The CG path (the spectral one follows below); a fixed tight inner
    # tolerance makes each phi-solve exact to rounding on both layouts.
    laplacian_mode="cg", cg_rtol=1e-14,
)


@pytest.fixture(scope="module")
def sharded_solve(plane_geometry, tmp_path_factory):
    """The port's solver on a 1x2 mesh of gloo CPU ranks: every rank's
    recovered solution and run history."""
    inputs = dict(geometry_inputs(plane_geometry), n_time=N_TIME, kw_device="cpu",
                  **{f"kw_{k}": v for k, v in SOLVE_KW.items()})
    return run_ranks(tmp_path_factory.mktemp("solve"), "solve", 2, inputs)


def _assert_solutions_close(got, ref):
    for key in ("mu", "E", "phi"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-9, atol=1e-12, err_msg=key)


def test_sharded_solver_matches_single_device(plane_geometry, sharded_solve):
    """(f) 30 iterations on the 1x2 mesh reproduce the single-device port
    (rtol 1e-9, atol 1e-12, the bound of tests/test_parallel.py), with the
    same validation points; both ranks return the same whole solution."""
    from dots_socp_torch.solver import solver_socp

    single, history = solver_socp(N_TIME, plane_geometry, device="cpu", **SOLVE_KW)
    rank0, rank1 = sharded_solve
    for key in ("mu", "E", "phi"):
        np.testing.assert_array_equal(rank0[key], rank1[key])
    _assert_solutions_close(rank0, single)
    np.testing.assert_array_equal(rank0["kkt_iteration"], history.kkt_iteration)
    np.testing.assert_allclose(rank0["kkt_errors"], history.kkt_errors, rtol=1e-9, atol=1e-13)


def test_sharded_solver_matches_reference(plane_geometry, sharded_solve):
    """(f) The same 30 iterations against JAX's sharded solver_socp on a
    1x2 mesh of the same cg-mode problem."""
    from dots_socp_tpu.parallel.mesh import make_mesh
    from dots_socp_tpu.solver import solver_socp

    ref, _ = solver_socp(N_TIME, plane_geometry, mesh=make_mesh(2, time_axis=1), **SOLVE_KW)
    _assert_solutions_close(sharded_solve[0], ref)


SPECTRAL_KW = dict(nit=30, tol=1e-12, time_limit=300, precision="float64")  # auto -> spectral


@pytest.fixture(scope="module", params=[2, 4], ids=["1x2", "1x4"])
def sharded_spectral(request, plane_geometry, tmp_path_factory):
    """The port's solver on a 1xS mesh of gloo CPU ranks on the spectral
    path (the dense factor cut by rows, one all-reduce per phi-solve)."""
    inputs = dict(geometry_inputs(plane_geometry), n_time=N_TIME, kw_device="cpu",
                  **{f"kw_{k}": v for k, v in SPECTRAL_KW.items()})
    world = request.param
    return world, run_ranks(tmp_path_factory.mktemp(f"spectral{world}"), "solve", world, inputs)


def test_sharded_spectral_matches_single_device(plane_geometry, sharded_spectral):
    """30 iterations of the sharded spectral path reproduce the single-device
    port (rtol 1e-9, atol 1e-12, the bound of tests/test_parallel.py:20-28),
    with the same validation points; every rank returns the same solution."""
    from dots_socp_torch.solver import solver_socp

    _, ranks = sharded_spectral
    single, history = solver_socp(N_TIME, plane_geometry, device="cpu", **SPECTRAL_KW)
    for other in ranks[1:]:
        for key in ("mu", "E", "phi"):
            np.testing.assert_array_equal(ranks[0][key], other[key])
    _assert_solutions_close(ranks[0], single)
    np.testing.assert_array_equal(ranks[0]["kkt_iteration"], history.kkt_iteration)
    np.testing.assert_allclose(ranks[0]["kkt_errors"], history.kkt_errors, rtol=1e-9, atol=1e-13)


def test_sharded_spectral_matches_reference(plane_geometry, sharded_spectral):
    """The same 30 iterations against JAX's sharded solver_socp on a mesh of
    the same shape, which takes its spectral path too."""
    from dots_socp_tpu.parallel.mesh import make_mesh
    from dots_socp_tpu.solver import solver_socp

    world, ranks = sharded_spectral
    ref, _ = solver_socp(N_TIME, plane_geometry, mesh=make_mesh(world, time_axis=1), **SPECTRAL_KW)
    _assert_solutions_close(ranks[0], ref)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_converted_spectral_factor_equals_reference_shards(plane_geometry, n_parts):
    """convert.py turns JAX's blocked spectral problem into one rank's
    shard: s and the rows of q equal the block JAX places on that device
    (`parallel/mesh.py:103-112`), u_time and invfac stay whole; and the
    port's own build_problem + shard_problem gives the same factor."""
    from dots_socp_torch.convert import problem_from_reference
    from dots_socp_torch.parallel.mesh import shard_problem as t_shard_problem
    from dots_socp_torch.solver.problem import build_problem as t_build_problem
    from dots_socp_tpu.parallel.mesh import make_mesh, shard_problem
    from dots_socp_tpu.solver.problem import build_problem

    kw = dict(dtype="float64", space_partitions=n_parts, mesh_axes=(1, n_parts))
    config, data, _ = build_problem(N_TIME, plane_geometry, **kw)
    assert data.spectral is not None and data.halo is not None
    sharded = shard_problem(make_mesh(n_parts, time_axis=1), data)
    chunk = config.n_vertices // n_parts
    q_blocks = {sh.index[0].start // chunk: np.asarray(sh.data)
                for sh in sharded.spectral.q.addressable_shards}
    s_blocks = {sh.index[0].start // chunk: np.asarray(sh.data)
                for sh in sharded.spectral.s.addressable_shards}
    assert sorted(q_blocks) == list(range(n_parts))
    _, whole, _ = t_build_problem(N_TIME, plane_geometry, device="cpu", **kw)
    host = jax.tree.map(np.asarray, data)
    for rank in range(n_parts):
        mesh = tpd.SolverMesh(space=n_parts, rank=rank, device=torch.device("cpu"))
        _, converted = problem_from_reference(config, host, mesh=mesh)
        built = t_shard_problem(mesh, whole)
        for factor in (converted.spectral, built.spectral):
            assert factor.q.shape == (chunk, config.n_vertices)
            np.testing.assert_array_equal(factor.q.numpy(), q_blocks[rank])
            np.testing.assert_array_equal(factor.s.numpy(), s_blocks[rank])
            np.testing.assert_array_equal(factor.u_time.numpy(), np.asarray(data.spectral.u_time))
            np.testing.assert_array_equal(factor.invfac.numpy(), np.asarray(data.spectral.invfac))


def test_cli_sharded_solve_with_explicit_flags(tmp_path):
    """The CLI on a 1x2 mesh with --num_processes / --process_id /
    --coordinator_address (two gloo CPU processes): both exit 0, only rank 0
    logs the run, and its transport cost matches the single-device CLI's to
    1e-3 relative. The CLI has no inner-tolerance flag, so both runs use the
    adaptive CG tolerance (0.05 x the KKT error, ~5e-3 at the start): the
    halo and ELL matvecs round differently and their CG solves stop at
    different points inside it (measured 2.6e-4). Test (f) above holds the
    sharded solver to 1e-9 at a fixed tight tolerance."""
    import re
    import socket

    from dots_socp_torch import cli

    argv = ["--example", "plane", "--n_space", "10", "--ntime", "4", "--nit", "20",
            "--tol", "1e-3", "--precision", "float64", "--device", "cpu",
            "--laplacian_mode", "cg"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD_ENV)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "dots_socp_torch.cli", *argv, "--mesh_shape", "1x2",
             "--dist_backend", "gloo", "--num_processes", "2", "--process_id", str(r),
             "--coordinator_address", f"127.0.0.1:{port}"],
            env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "backend gloo, rank 1" in logs[1] and "Transportation cost" not in logs[1]
    cost = float(re.search(r"Transportation cost: ([0-9.e+-]+)", logs[0]).group(1))
    _, _, history = cli.main(argv)
    assert abs(cost - history.history["Transportation cost"][-1]) <= 1e-3 * abs(cost)
