"""The mesh's "time" axis of the port (`--mesh_shape TxS`, T > 1) against the
whole-array functions, the single-device port and the JAX package.

The ranks are gloo CPU subprocesses of `tests/torch_rank_worker.py` (no
jax), one per (time, space) shard, world rank = t * S + s; the JAX side runs
here on conftest's 8-device CPU mesh with `make_mesh(n, time_axis=2)`.
Problem: the conftest plane (n=12), n_time=6 (two blocks of 3 staggered
slices), float64 unless stated."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_socp_torch.ops import norms as t_norms
from dots_socp_torch.ops import time_stencils as t_ts
from dots_socp_torch.parallel import distributed as tpd
from dots_socp_torch.parallel.mesh import STAGGERED_FIELDS
from dots_socp_torch.solver import solver_socp as t_solver
from dots_socp_torch.solver.state import SolverState
from torch_rank_worker import ONE_THREAD_ENV, geometry_inputs, one_thread, run_ranks

REPO = Path(__file__).resolve().parents[1]
N_TIME = 6
MESHES = {"2x2": 4, "2x1": 2}  # --mesh_shape -> ranks


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


# ---- (a), (b), (g): stencils, norms, state round trip, indivisible n_time --

V, F = 10, 12  # synthetic sizes, both even: two space blocks


def _seeded_arrays():
    rng = np.random.default_rng(5)
    arrays = dict(
        stag=rng.standard_normal((N_TIME, V)),
        cent=rng.standard_normal((N_TIME + 1, V)),
        cone=rng.standard_normal((N_TIME, 2, F, 3, 3)),
        cent_f=rng.standard_normal((N_TIME + 1, F, 3)),
        av=rng.uniform(0.5, 1.5, V),
        area_f=rng.uniform(0.5, 1.5, F),
    )
    shapes = dict(phi=(N_TIME + 1, V), A=(N_TIME, V), B=(N_TIME + 1, F, 3), lambda_c=(N_TIME, V),
                  z_fst=(N_TIME, V), z_mid=(N_TIME, 2, F, 3, 3), z_end=(N_TIME, V),
                  mu=(N_TIME, V), E=(N_TIME + 1, F, 3), beta_fst=(N_TIME, V),
                  beta_mid=(N_TIME, 2, F, 3, 3), beta_end=(N_TIME, V), dt_phi=(N_TIME, V),
                  dx_phi=(N_TIME + 1, F, 3), boundary=(N_TIME + 1, V))
    for name in SolverState._fields:
        arrays[f"st_{name}"] = rng.standard_normal(shapes.get(name, ()))
    return arrays


@pytest.fixture(scope="module")
def timeaxis_ranks(plane_geometry, tmp_path_factory):
    """Task `timeaxis` on a 2x2 mesh: every rank's sharded stencils and
    norms of the seeded arrays, its shard and the gathered state, and the
    error of n_time=5."""
    arrays = _seeded_arrays()
    inputs = dict(geometry_inputs(plane_geometry), n_time=N_TIME, **arrays)
    return arrays, run_ranks(tmp_path_factory.mktemp("timeaxis"), "timeaxis", 4, inputs,
                             mesh_shape="2x2")


def _space(a, s, axis=-1):
    """Space block `s` of two along `axis`."""
    n = a.shape[axis] // 2
    return np.take(a, range(s * n, (s + 1) * n), axis=axis)


def _time(a, t):
    n = a.shape[0] // 2
    return a[t * n:(t + 1) * n]


WHOLE_STENCILS = {
    # name -> (whole-array function of the seeded arrays, space axis, staggered result)
    "div_time": (lambda a: t_ts.div_time(1.0 / N_TIME, torch.from_numpy(a["stag"])), -1, False),
    "time_center_adjoint": (lambda a: t_ts.time_center_adjoint(torch.from_numpy(a["stag"])), -1, False),
    "decouple_space_adjoint": (
        lambda a: t_ts.decouple_space_adjoint(torch.from_numpy(a["cone"]), 1.7), 1, False),
    "grad_time": (lambda a: t_ts.grad_time(1.0 / N_TIME, torch.from_numpy(a["cent"])), -1, True),
    "decouple_space": (lambda a: t_ts.decouple_space(torch.from_numpy(a["cent_f"]), 1.7), 2, True),
}


@pytest.mark.parametrize("name", list(WHOLE_STENCILS))
def test_sharded_stencil_equals_whole_array(timeaxis_ranks, name):
    """(a) Each time-sharded stencil on rank (t, s) is the whole-array
    function's block: a T -> T+1 map (gather over time, then the stencil)
    gives every time-rank the same whole result, a T+1 -> T map its own time
    block; f64, exact."""
    arrays, ranks = timeaxis_ranks
    fn, axis, staggered = WHOLE_STENCILS[name]
    whole = fn(arrays).numpy()
    for rank, out in enumerate(ranks):
        t, s = divmod(rank, 2)
        want = _space(whole, s, axis)
        np.testing.assert_array_equal(out[name], _time(want, t) if staggered else want)


WHOLE_NORMS = {
    "nst": lambda a: t_norms.norm_sq_vertex(
        torch.from_numpy(a["av"]), torch.from_numpy(a["stag"]), N_TIME),
    "nsc": lambda a: t_norms.norm_sq_vertex(
        torch.from_numpy(a["av"]), torch.from_numpy(a["cent"]), N_TIME + 1),
    "nss": lambda a: t_norms.norm_sq_triangle(
        torch.from_numpy(a["area_f"]), torch.from_numpy(a["cent_f"]), N_TIME + 1),
    "nsd": lambda a: t_norms.norm_sq_decouple(
        torch.from_numpy(a["area_f"]), torch.from_numpy(a["cone"]), N_TIME),
}


@pytest.mark.parametrize("name", list(WHOLE_NORMS))
def test_sharded_norm_equals_whole_array(timeaxis_ranks, name):
    """(a) The staggered norms (nst, nsd) sum over space and time, the
    centered ones (nsc, nss; whole on every time-rank) over space only: each
    equals the whole-array norm to 1e-14 relative on every rank. A centered
    norm summed over time too would be twice it."""
    arrays, ranks = timeaxis_ranks
    whole = float(WHOLE_NORMS[name](arrays))
    for out in ranks:
        assert abs(float(out[name]) - whole) <= 1e-14 * whole


def test_state_shards_and_gathers_back_exactly(timeaxis_ranks):
    """(b) shard_state on a 2x2 mesh keeps block (t, s) of a staggered field
    and space block s of every time slice of a centered one; gather_state
    gives every rank the whole state back, exact."""
    arrays, ranks = timeaxis_ranks
    assert {"A", "z_mid", "mu", "dt_phi"} <= STAGGERED_FIELDS
    assert not {"phi", "B", "E", "dx_phi", "boundary"} & STAGGERED_FIELDS
    for rank, out in enumerate(ranks):
        t, s = divmod(rank, 2)
        np.testing.assert_array_equal(out["shard_A"], _time(_space(arrays["st_A"], s), t))
        np.testing.assert_array_equal(
            out["shard_z_mid"], _time(_space(arrays["st_z_mid"], s, axis=2), t))
        np.testing.assert_array_equal(out["shard_phi"], _space(arrays["st_phi"], s))
        np.testing.assert_array_equal(out["shard_B"], _space(arrays["st_B"], s, axis=1))
        for name in SolverState._fields:
            np.testing.assert_array_equal(out[f"st_{name}"], arrays[f"st_{name}"], err_msg=name)


def test_indivisible_n_time_raises_on_every_rank(timeaxis_ranks):
    """(g) n_time=5 on a 2-way time axis: a ValueError naming both numbers,
    on every rank, before any collective (no rank hangs)."""
    _, ranks = timeaxis_ranks
    for out in ranks:
        message = str(out["indivisible"])
        assert "n_time=5" in message and "time axis 2" in message, message
    mesh = tpd.SolverMesh(space=1, rank=0, device=torch.device("cpu"), time=2, time_rank=1)
    assert mesh.time_block(6) == slice(3, 6) and mesh.world_rank == 1
    with pytest.raises(ValueError, match="n_time=5.*time axis 2"):
        mesh.time_block(5)


# ---- (c): the spectral solve on 2x2 and 2x1 --------------------------------

SPECTRAL_KW = dict(nit=30, tol=1e-12, time_limit=300, precision="float64")  # auto -> spectral


def _solve_inputs(geometry, **kw):
    return dict(geometry_inputs(geometry), n_time=N_TIME, kw_device="cpu",
                **{f"kw_{k}": v for k, v in kw.items()})


@pytest.fixture(scope="module", params=list(MESHES))
def spectral_solve(request, plane_geometry, tmp_path_factory):
    """The port's solver_socp on a 2x2 / 2x1 mesh of gloo CPU ranks, 30
    iterations, spectral path; it leaves its forced snapshot behind."""
    shape = request.param
    tmp = tmp_path_factory.mktemp(f"spectral{shape}")
    snap = tmp / "mesh.npz"
    ranks = run_ranks(tmp, "solve", MESHES[shape],
                      _solve_inputs(plane_geometry, snapshot_path=str(snap), **SPECTRAL_KW),
                      mesh_shape=shape)
    return shape, ranks, snap


def _assert_solutions_close(got, ref):
    for key in ("mu", "E", "phi"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-9, atol=1e-12, err_msg=key)


def test_time_sharded_solver_matches_single_device(plane_geometry, spectral_solve):
    """(c) 30 iterations on the mesh reproduce the single-device port (rtol
    1e-9, atol 1e-12), with the same validation points and KKT tables to
    1e-12 (a centered norm counted once per time shard would double rows 2
    and 5); every rank returns the same whole solution, bit for bit."""
    _, ranks, _ = spectral_solve
    single, history = t_solver(N_TIME, plane_geometry, device="cpu", **SPECTRAL_KW)
    for other in ranks[1:]:
        for key in ("mu", "E", "phi"):
            np.testing.assert_array_equal(ranks[0][key], other[key])
    _assert_solutions_close(ranks[0], single)
    np.testing.assert_array_equal(ranks[0]["kkt_iteration"], history.kkt_iteration)
    np.testing.assert_allclose(ranks[0]["kkt_errors"], history.kkt_errors, rtol=1e-12, atol=1e-12)


def test_time_sharded_solver_matches_reference(plane_geometry, spectral_solve):
    """(c) The same 30 iterations against JAX's solver_socp on
    `make_mesh(n, time_axis=2)` (tests/test_parallel.py:14-28's bound)."""
    from dots_socp_tpu.parallel.mesh import make_mesh
    from dots_socp_tpu.solver import solver_socp

    shape, ranks, _ = spectral_solve
    ref, _ = solver_socp(N_TIME, plane_geometry, mesh=make_mesh(MESHES[shape], time_axis=2),
                         **SPECTRAL_KW)
    _assert_solutions_close(ranks[0], ref)


# ---- (f): snapshots across mesh shapes ------------------------------------

def _assert_same_trajectory(resumed, full):
    for key in ("mu", "phi"):
        np.testing.assert_allclose(resumed[key], full[key], rtol=1e-8, atol=1e-12, err_msg=key)


def test_mesh_snapshot_resumes_on_fewer_ranks(plane_geometry, spectral_solve, tmp_path):
    """(f) The snapshot a 2x2 mesh wrote at iteration 29 (world rank 0 writes
    the state gathered over space and time) resumes on a 1x2 mesh, and a
    2x1 mesh's on one device, to the uninterrupted single-device 45
    iterations (rtol 1e-8, atol 1e-12). A snapshot holds the vertex layout
    of its space axis (blocked and padded for 2 shards, plain for 1), so it
    moves between meshes with the same space axis."""
    shape, _, snap = spectral_solve
    kw = dict(SPECTRAL_KW, nit=45)
    full, _ = t_solver(N_TIME, plane_geometry, device="cpu", **kw)
    if shape == "2x1":
        resumed, history = t_solver(N_TIME, plane_geometry, device="cpu", snapshot_path=str(snap), **kw)
        its = history.kkt_iteration
    else:
        copy = tmp_path / "copy.npz"
        copy.write_bytes(snap.read_bytes())
        resumed, other = run_ranks(tmp_path, "solve", 2,
                                   _solve_inputs(plane_geometry, snapshot_path=str(copy), **kw))
        np.testing.assert_array_equal(resumed["phi"], other["phi"])
        its = resumed["kkt_iteration"]
    _assert_same_trajectory(resumed, full)
    assert np.nanmin(its) >= 30 and np.nanmax(its) == 44


@pytest.mark.parametrize("shape", list(MESHES))
def test_mesh_resumes_a_snapshot_of_fewer_ranks(plane_geometry, tmp_path, shape):
    """(f) The reverse: a 1x2 mesh's snapshot (20 iterations) resumes on 2x2,
    and a single device's on 2x1 (every rank reads the file and keeps its
    time and space block), to the uninterrupted 45 iterations."""
    kw = dict(SPECTRAL_KW, nit=45)
    full, _ = t_solver(N_TIME, plane_geometry, device="cpu", **kw)
    snap = tmp_path / "first.npz"
    first = dict(SPECTRAL_KW, nit=20, snapshot_path=str(snap))
    if shape == "2x1":
        t_solver(N_TIME, plane_geometry, device="cpu", **first)
    else:
        (tmp_path / "first").mkdir()
        run_ranks(tmp_path / "first", "solve", 2, _solve_inputs(plane_geometry, **first))
    ranks = run_ranks(tmp_path, "solve", MESHES[shape],
                      _solve_inputs(plane_geometry, snapshot_path=str(snap), **kw),
                      mesh_shape=shape)
    for other in ranks[1:]:
        np.testing.assert_array_equal(ranks[0]["phi"], other["phi"])
    _assert_same_trajectory(ranks[0], full)
    its = ranks[0]["kkt_iteration"]
    assert np.nanmin(its) >= 20 and np.nanmax(its) == 44


# ---- (d): the CG path with kernel B2's plain version on 2x2 ----------------

CHUNK_KW = dict(dtype="float64", laplacian_mode="cg", cg_deflation_k=16, cg_rtol=1e-12,
                phi_refine="on")
CHUNK_ITERATIONS = 10


def _reference_swindow_chunk(geometry):
    """JAX: the blocked 2-shard problem with the sharded window operator
    forced (auto builds it on a TPU backend only), on `make_mesh(4,
    time_axis=2)`: the state after CHUNK_ITERATIONS iterations (the Pallas
    kernel in interpret mode) and its KKT table."""
    from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
    from dots_socp_tpu.ops.laplacian import build_cg_operator
    from dots_socp_tpu.ops.mesh_ops import grad_space
    from dots_socp_tpu.ops.time_stencils import decouple_space_adjoint, grad_time
    from dots_socp_tpu.parallel.mesh import make_mesh, shard_problem, shard_state
    from dots_socp_tpu.solver.kkt import compute_kkt
    from dots_socp_tpu.solver.problem import build_problem
    from dots_socp_tpu.solver.scaling import apply_z_scale
    from dots_socp_tpu.solver.state import init_state
    from dots_socp_tpu.solver.step import run_chunk

    kw = dict(CHUNK_KW, phi_refine=True)
    config, data, extras = build_problem(N_TIME, geometry, space_partitions=2, mesh_axes=(2, 2), **kw)
    tri = np.asarray(geometry["triangles"])
    _, angles, _ = triangle_quantities(np.asarray(geometry["vertices"]), tri)
    lap_p = cotan_laplacian(extras["vertex_slot"][tri], angles, config.n_vertices)
    op = build_cg_operator(
        N_TIME, config.stepsize_time, np.asarray(data.ops.av, np.float64), lap_p,
        dtype=jnp.float64, deflation_k=16, rtol=1e-12, use_pallas_spmv=True, shard_parts=2,
        refine=True,
    )
    assert op.swindow is not None
    data = data._replace(cg_op=op)
    dt = config.stepsize_time
    state = init_state(
        N_TIME, config.n_vertices, config.n_triangles, extras["mu0_padded"],
        extras["mu1_padded"], dt, grad_time_fn=lambda p: grad_time(dt, p),
        grad_space_fn=lambda p: grad_space(data.ops, p),
        decouple_adjoint_fn=decouple_space_adjoint,
        norm_constant_d=extras["norm_constant_d"], dtype=config.jnp_dtype,
        phi_dtype=config.phi_dtype,
    )
    mesh = make_mesh(4, time_axis=2)
    data = shard_problem(mesh, data)
    state = shard_state(mesh, apply_z_scale(state, 2.0))
    state = run_chunk(config, data, state, np.int32(CHUNK_ITERATIONS))
    return jax.tree.map(np.asarray, state), np.asarray(compute_kkt(config, data, state))


def test_time_sharded_cg_path_matches_reference_swindow(plane_geometry, tmp_path):
    """(d) 10 iterations of the CG path on a 2x2 mesh: f64 state, f64
    refinement to cg_rtol=1e-12 around the f32 inner CG whose matvec is
    kernel B2's plain version (B2 ran in every inner matvec, in every
    rank), against JAX's sharded-window solve on a (2, 2) mesh. Every state
    field within 1e-8 of its largest entry, the KKT tables at rtol 1e-8:
    the bound of tests/test_torch_solver.py's f64 runs. The two inner CGs
    sum in another order; the f64 refinement hides that below 1e-12."""
    inputs = dict(geometry_inputs(plane_geometry), n_time=N_TIME, iterations=CHUNK_ITERATIONS,
                  **{f"kw_{k}": v for k, v in CHUNK_KW.items()})
    ranks = run_ranks(tmp_path, "chunk", 4, inputs, mesh_shape="2x2")
    ref_state, ref_kkt = _reference_swindow_chunk(plane_geometry)
    for out in ranks:
        assert out["window_matvecs"] > 0
        for name in SolverState._fields:
            np.testing.assert_array_equal(out[f"st_{name}"], ranks[0][f"st_{name}"], err_msg=name)
    for name in SolverState._fields:
        got, ref = ranks[0][f"st_{name}"], np.asarray(getattr(ref_state, name), dtype=np.float64)
        assert np.abs(got - ref).max() <= 1e-8 * max(np.abs(ref).max(), 1e-300), name
    np.testing.assert_allclose(ranks[0]["kkt"], ref_kkt, rtol=1e-8, atol=1e-14)


# ---- (e): the CLI on a 2x2 mesh --------------------------------------------

def _free_port(lo=None, hi=None):
    """A free TCP port: the system's choice, or one of [lo, hi] found by
    trying (the range of the SLURM rule lies outside the system's)."""
    with socket.socket() as sock:
        if lo is None:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]
    for port in np.random.default_rng(os.getpid()).permutation(np.arange(lo, hi + 1))[:64]:
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", int(port)))
            except OSError:
                continue
            return int(port)
    raise RuntimeError(f"no free port in [{lo}, {hi}]")


def _run_processes(commands, envs, cwd, timeout=300):
    procs = [subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(commands, envs)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:  # a hung rank fails the test, and is stopped
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def test_cli_time_sharded_solve(tmp_path):
    """(e) The CLI with --mesh_shape 2x2 in four gloo CPU processes (explicit
    rendezvous flags): all exit 0, only world rank 0 logs the run, and its
    transport cost matches the single-process CLI's to 1e-9 relative on the
    spectral path in float64."""
    import re

    from dots_socp_torch import cli

    argv = ["--example", "plane", "--n_space", "10", "--ntime", "4", "--nit", "20",
            "--tol", "1e-3", "--precision", "float64", "--device", "cpu"]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD_ENV)
    logs = _run_processes(
        [[sys.executable, "-m", "dots_socp_torch.cli", *argv, "--mesh_shape", "2x2",
          "--dist_backend", "gloo", "--num_processes", "4", "--process_id", str(r),
          "--coordinator_address", f"127.0.0.1:{port}"] for r in range(4)],
        [env] * 4, tmp_path)
    for rank in (1, 2, 3):
        assert f"mesh 2x2: torch.distributed backend gloo, rank {rank}" in logs[rank]
        assert "Transportation cost" not in logs[rank]
    cost = float(re.search(r"Transportation cost: ([0-9.e+-]+)", logs[0]).group(1))
    _, _, history = cli.main(argv)
    single = history.history["Transportation cost"][-1]
    assert abs(cost - single) <= 1e-6 * abs(single)  # the log prints 7 digits


# ---- (h): rendezvous from the cluster's environment -----------------------

RENDEZVOUS = (
    "import torch, torch.distributed as dist\n"
    "from dots_socp_torch.parallel import distributed as pd\n"
    "assert pd.initialize_distributed('gloo')\n"
    "mesh = pd.make_solver_mesh('2x1', device='cpu')\n"
    "from dots_socp_torch.ops.collectives import time_sum, time_all_gather\n"
    "x = torch.tensor([float(mesh.time_rank + 1)])\n"
    "print('RESULT', mesh.world_rank, mesh.time_rank, time_sum(x, mesh).item(),\n"
    "      time_all_gather(x, mesh).tolist())\n"
    "dist.destroy_process_group()\n"
)


@pytest.mark.parametrize("cluster", ["slurm", "openmpi"])
def test_rendezvous_from_cluster_environment(tmp_path, cluster):
    """(h) Two processes with neither flags nor torchrun's variables find
    rank, world size and address in a (fake) SLURM or Open MPI environment,
    make a 2x1 mesh and run both time collectives."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("SLURM_", "OMPI_")) and k not in
            ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "COORDINATOR_ADDRESS")}
    base.update(PYTHONPATH=str(REPO), **ONE_THREAD_ENV)
    if cluster == "slurm":
        port = _free_port(61440, 65535)  # the port SLURM_JOB_ID maps to
        envs = [dict(base, SLURM_PROCID=str(r), SLURM_NTASKS="2", SLURM_LOCALID=str(r),
                     SLURM_JOB_ID=str(port - 61440 + 4096 * 7), SLURM_JOB_NODELIST="localhost")
                for r in range(2)]
    else:
        envs = [dict(base, OMPI_COMM_WORLD_RANK=str(r), OMPI_COMM_WORLD_SIZE="2",
                     OMPI_COMM_WORLD_LOCAL_RANK=str(r),
                     COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}") for r in range(2)]
        envs[1]["COORDINATOR_ADDRESS"] = envs[0]["COORDINATOR_ADDRESS"]
    logs = _run_processes([[sys.executable, "-c", RENDEZVOUS]] * 2, envs, tmp_path, timeout=120)
    for rank, log in enumerate(logs):
        assert f"RESULT {rank} {rank} 3.0 [1.0, 2.0]" in log, log[-2000:]


def test_cluster_environment_parsing():
    """`cluster_environment` on hand-made environments: SLURM's node-list
    forms, COORDINATOR_ADDRESS taking precedence, Open MPI needing it, and
    None outside a cluster (then `initialize_distributed` starts nothing)."""
    slurm = {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_JOB_ID": "4097"}
    for nodelist, host in (("node[03-05,9],gpu1", "node03"), ("a1,b2", "a1"), ("gpu[7]", "gpu7"),
                           ("single", "single")):
        got = tpd.cluster_environment(dict(slurm, SLURM_JOB_NODELIST=nodelist))
        assert got == (3, 8, f"{host}:61441")
    step = dict(slurm, SLURM_JOB_NODELIST="job[1-9]", SLURM_STEP_NODELIST="step[4-5]")
    assert tpd.cluster_environment(step)[2] == "step4:61441"
    assert tpd.cluster_environment(dict(step, COORDINATOR_ADDRESS="h:1"))[2] == "h:1"
    with pytest.raises(ValueError, match="node list"):
        tpd.cluster_environment(slurm)
    ompi = {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2"}
    assert tpd.cluster_environment(dict(ompi, COORDINATOR_ADDRESS="h:2")) == (1, 2, "h:2")
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        tpd.cluster_environment(ompi)
    with pytest.raises(ValueError, match="neither SLURM nor Open MPI"):
        tpd.cluster_environment({"COORDINATOR_ADDRESS": "h:3"})
    assert tpd.cluster_environment({}) is None


def test_card_per_rank_check_counts_this_nodes_ranks():
    """The nccl check of one card per rank counts the ranks of this node, as
    torchrun, SLURM or Open MPI gives them, not the world: a 2x4 mesh on two
    4-card nodes passes under `srun` and `mpirun`; more ranks than cards on
    one node raises; a launcher that says nothing leaves it to NCCL; gloo
    shares cards."""
    lws = tpd._local_world_size
    assert lws({"LOCAL_WORLD_SIZE": "4", "SLURM_NTASKS_PER_NODE": "8"}) == 4
    assert lws({"SLURM_NTASKS_PER_NODE": "4", "SLURM_NTASKS": "8"}) == 4
    assert lws({"OMPI_COMM_WORLD_LOCAL_SIZE": "4", "OMPI_COMM_WORLD_SIZE": "8"}) == 4
    assert lws({"SLURM_STEP_TASKS_PER_NODE": "4(x2)", "SLURM_NODEID": "1"}) == 4
    assert lws({"SLURM_TASKS_PER_NODE": "2,3(x2),1", "SLURM_NODEID": "2"}) == 3
    assert lws({"SLURM_TASKS_PER_NODE": "2,3(x2),1", "SLURM_NODEID": "3"}) == 1
    assert lws({"SLURM_STEP_TASKS_PER_NODE": "5", "SLURM_TASKS_PER_NODE": "9"}) == 5
    assert lws({"SLURM_NTASKS": "8", "SLURM_PROCID": "5"}) is None
    for env in ({"SLURM_NTASKS": "8", "SLURM_NTASKS_PER_NODE": "4"},
                {"SLURM_NTASKS": "8", "SLURM_STEP_TASKS_PER_NODE": "4(x2)", "SLURM_NODEID": "1"},
                {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_LOCAL_SIZE": "4"},
                {"WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "4"}, {}):
        tpd._check_card_per_rank("nccl", 4, env)
    for env in ({"LOCAL_WORLD_SIZE": "8"}, {"SLURM_NTASKS_PER_NODE": "8"},
                {"OMPI_COMM_WORLD_LOCAL_SIZE": "5"}):
        with pytest.raises(ValueError, match=r"one card per rank: \d ranks on this node, 4 cards"):
            tpd._check_card_per_rank("nccl", 4, env)
        tpd._check_card_per_rank("gloo", 4, env)
