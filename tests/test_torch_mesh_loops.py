"""The JAX package's device-resident loops on a mesh: the blocked, latched
CG (`ops/laplacian.py::_BlockedCG`) and the iteration, table and adaptive
segments over a `graphs.Workspace` on every rank, held against the host
loops inside `graphs.eager()` and against the JAX package's GSPMD solve.

The ranks are gloo CPU processes of `tests/torch_rank_worker.py` (no jax;
over gloo the segments run op by op, the same code a CUDA graph holds over
nccl); the JAX side runs here, on the 8-device CPU mesh of conftest.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dots_socp_torch.ops import collectives, graphs
from dots_socp_torch.parallel.distributed import SolverMesh
from torch_rank_worker import (
    MESH_CG_BLOCKS,
    ONE_THREAD_ENV,
    geometry_inputs,
    one_thread,
    run_ranks,
)

REPO = Path(__file__).resolve().parents[1]
N_TIME = 6
CG_CASES = [f"{layout}_{kind}" for layout in ("window", "halo") for kind in ("refined", "plain")]
BLOCK_MODES = [f"b{k}" for k in MESH_CG_BLOCKS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def _counts(out, prefix):
    """The `COUNTS.snapshot()` a rank wrote under `prefix` (`_counted`)."""
    counts = {"calls": {}, "bytes": {}}
    for key, value in out.items():
        for kind in counts:
            head = f"{prefix}_{kind}_"
            if key.startswith(head):
                counts[kind][key[len(head):]] = int(value)
    return counts


# ---- cg_solve on a 1x2 mesh: blocked loops against the host loop ----------

@pytest.fixture(scope="module")
def mesh_cg(tmp_path_factory):
    """Every rank's `mesh_cg` outputs on plane n16, ntime 6, from a seeded
    right-hand side and warm start (zero on the padding slots)."""
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.solver.problem import build_problem

    geometry = load_geometry("plane", 16)
    config, _, extras = build_problem(
        N_TIME, geometry, dtype="float32", laplacian_mode="cg", cg_deflation_k=8,
        space_partitions=2, mesh_axes=(1, 2), device="cpu")
    rng = np.random.default_rng(13)
    slots = extras["vertex_slot"]
    rhs = np.zeros((N_TIME + 1, config.n_vertices), np.float32)
    x0 = np.zeros_like(rhs)
    real = rng.standard_normal((N_TIME + 1, slots.size))
    rhs[:, slots] = real - real.mean(axis=1, keepdims=True)
    x0[:, slots] = 0.1 * rng.standard_normal((N_TIME + 1, slots.size))
    inputs = dict(geometry_inputs(geometry), n_time=N_TIME, rhs=rhs, x0=x0)
    return run_ranks(tmp_path_factory.mktemp("mesh_cg"), "mesh_cg", 2, inputs)


@pytest.mark.parametrize("mode", BLOCK_MODES)
@pytest.mark.parametrize("case", CG_CASES)
def test_blocked_cg_on_mesh_equals_host_loop(mesh_cg, case, mode):
    """On every rank, the blocked loops give the host loop's x bit for bit
    and its inner iteration count, at every block length, on the window
    layout (kernel B2's plain version) and the halo layout, refined (f64
    residual, f32 passes) and not. The window layout's matvecs went through
    B2's wrapper."""
    for out in mesh_cg:
        np.testing.assert_array_equal(out[f"{case}_{mode}_x"], out[f"{case}_eager_x"])
        assert int(out[f"{case}_{mode}_iters"]) == int(out[f"{case}_eager_iters"]) > 0
        matvecs = int(out[f"{case}_{mode}_window_matvecs"])
        assert (matvecs > 0) == case.startswith("window")


@pytest.mark.parametrize("mode", BLOCK_MODES)
@pytest.mark.parametrize("case", CG_CASES)
def test_blocked_cg_reads_the_same_flags_on_every_rank(mesh_cg, case, mode):
    """The flags [live, it, gate] after every block are the same on both
    ranks, though no collective of their own makes them so (they come from
    all-reduced sums). The host reads one flag per block and one per
    refinement check after a pass, where the host loop reads one per inner
    iteration: each pass (its blocks up to the one whose flag falls) runs
    ceil(its iterations / block) blocks."""
    rank0, rank1 = mesh_cg
    np.testing.assert_array_equal(rank0[f"{case}_{mode}_flags"], rank1[f"{case}_{mode}_flags"])
    block = int(mode[1:])
    for out in mesh_cg:
        flags = out[f"{case}_{mode}_flags"]
        ends = np.flatnonzero(flags[:, 0] == 0)
        assert ends.size and ends[-1] == flags.shape[0] - 1
        starts = np.concatenate([[0], ends[:-1] + 1])
        per_pass = [int(flags[e, 1]) for e in ends]
        assert [e - s + 1 for s, e in zip(starts, ends)] == [-(-n // block) for n in per_pass]
        assert sum(per_pass) == int(out[f"{case}_eager_iters"])
        checks = int(out[f"{case}_{mode}_flag_reads"]) - flags.shape[0]
        assert checks == (len(per_pass) if case.endswith("refined") else 0)
        assert int(out[f"{case}_eager_flag_reads"]) > sum(per_pass)


@pytest.mark.parametrize("mode", BLOCK_MODES)
@pytest.mark.parametrize("case", CG_CASES)
def test_blocked_cg_collectives_account_for_the_host_loop(mesh_cg, case, mode):
    """`COUNTS` per solve: the blocked loops make the host loop's
    collectives, calls and bytes, less its flag all-reduces (`space_any`,
    one 4-byte MAX per flag read) and plus one latched iteration's
    collectives (measured alone) for each no-op iteration of their last
    blocks."""
    for out in mesh_cg:
        eager, blocked = _counts(out, f"{case}_eager"), _counts(out, f"{case}_{mode}")
        step = _counts(out, f"{case}_step")
        latched = out[f"{case}_{mode}_flags"].shape[0] * int(mode[1:])
        noop = latched - int(out[f"{case}_{mode}_iters"])
        reads = int(out[f"{case}_eager_flag_reads"])
        assert noop >= 0 and step["calls"]["space_all_reduce"] > 0
        for kind, per_read in (("calls", 1), ("bytes", 4)):
            expect = dict(eager[kind])
            expect["space_all_reduce"] -= reads * per_read
            for key, n in step[kind].items():
                expect[key] = expect.get(key, 0) + noop * n
            assert blocked[kind] == expect, kind


# ---- whole solves: the graphed loops against graphs.eager() ---------------

F64_CG = dict(nit=30, tol=1e-12, time_limit=300, precision="float64",
              laplacian_mode="cg", cg_rtol=1e-14)
F32_WINDOW = dict(nit=30, tol=1e-12, time_limit=300, precision="float32",
                  laplacian_mode="cg", cg_rtol=1e-5)
SOLVES = {"1x2-f64": ("1x2", F64_CG), "2x1-f64": ("2x1", F64_CG),
          "1x2-f32-window": ("1x2", F32_WINDOW)}


@pytest.fixture(scope="module", params=list(SOLVES))
def loops(request, plane_geometry, tmp_path_factory):
    """`loops` on every rank: the solve through the graphed loops and inside
    `graphs.eager()`, 30 iterations of plane n12 at ntime 6."""
    shape, kw = SOLVES[request.param]
    inputs = dict(geometry_inputs(plane_geometry), n_time=N_TIME, kw_device="cpu",
                  **{f"kw_{k}": v for k, v in kw.items()})
    ranks = run_ranks(tmp_path_factory.mktemp(request.param), "loops", 2, inputs,
                      mesh_shape=shape)
    return request.param, ranks


def test_mesh_loops_equal_eager(loops):
    """phi, mu and E bit-equal to the host loops', on every rank and the
    same on both; the same validation points and KKT history bit for bit;
    the same inner CG iterations."""
    _, ranks = loops
    for out in ranks:
        for key in ("phi", "mu", "E", "kkt_iteration", "kkt_errors", "inner", "solves"):
            np.testing.assert_array_equal(out[f"loops_{key}"], out[f"eager_{key}"], err_msg=key)
        assert int(out["loops_inner"]) > 0
    for key in ("phi", "mu", "E", "kkt_iteration"):
        np.testing.assert_array_equal(ranks[0][f"loops_{key}"], ranks[1][f"loops_{key}"])


def test_mesh_loops_read_the_host_per_block_pass_and_validation(loops):
    """Host reads per solve: one per validation and one per segment (its
    records, `graphs.HOST_READS`), and one per CG block and later
    refinement pass, not one per inner iteration as the host loops read.
    Over gloo nothing is captured: every segment ran op by op."""
    name, ranks = loops
    for out in ranks:
        assert not out["capturable"]
        assert int(out["loops_captures"]) == 0 and int(out["loops_uncaptured_runs"]) > 0
        validations, segments = int(out["loops_runs_validate"]), int(out["loops_runs_segments"])
        assert validations > 0 and segments > 0
        assert int(out["loops_host_reads"]) == validations + segments
        assert int(out["eager_host_reads"]) == validations + segments
        blocks, finishes = int(out["loops_runs_block"]), int(out["loops_runs_finish"])
        flag_reads = int(out["loops_flag_reads"])
        assert blocks <= flag_reads <= blocks + finishes
        assert (finishes > 0) == name.endswith("window")
        assert flag_reads < int(out["loops_inner"]) < int(out["eager_flag_reads"])


def test_mesh_loops_keep_the_collectives_outside_the_cg(loops):
    """The collectives outside the CG's loops (the time axis's gathers and
    sums, world rank 0's broadcasts) are the host loops', call for call and
    byte for byte; the space collectives differ by the CG's accounting
    (above)."""
    _, ranks = loops
    for out in ranks:
        eager, new = _counts(out, "eager"), _counts(out, "loops")
        for kind in ("calls", "bytes"):
            keep = {k: v for k, v in eager[kind].items() if not k.startswith("space_")}
            assert {k: v for k, v in new[kind].items() if not k.startswith("space_")} == keep
        assert "world_broadcast" in eager["calls"]


@pytest.mark.parametrize("name", ["1x2-f64", "2x1-f64"])
def test_mesh_loops_match_reference(plane_geometry, tmp_path, name):
    """The graphed loops' 30 iterations against JAX's GSPMD solver_socp on a
    mesh of the same shape (`make_mesh(2, time_axis=T)`), at the bound of
    tests/test_torch_parallel.py and tests/test_torch_timeaxis.py (rtol
    1e-9, atol 1e-12)."""
    from dots_socp_tpu.parallel.mesh import make_mesh
    from dots_socp_tpu.solver import solver_socp

    shape, kw = SOLVES[name]
    inputs = dict(geometry_inputs(plane_geometry), n_time=N_TIME, kw_device="cpu",
                  **{f"kw_{k}": v for k, v in kw.items()})
    ranks = run_ranks(tmp_path, "solve", 2, inputs, mesh_shape=shape)
    ref, _ = solver_socp(N_TIME, plane_geometry,
                         mesh=make_mesh(2, time_axis=int(shape.split("x")[0])), **kw)
    for key in ("mu", "E", "phi"):
        np.testing.assert_allclose(ranks[0][key], ref[key], rtol=1e-9, atol=1e-12, err_msg=key)


# ---- host-side collectives stay between segments ---------------------------

@pytest.mark.parametrize("call", [
    lambda: collectives.space_any(torch.ones(2, dtype=torch.bool), None),
    lambda: collectives.rank0_decides(True, None),
    lambda: collectives.object_from_rank0(lambda: 1, None),
], ids=["space_any", "rank0_decides", "object_from_rank0"])
def test_host_side_collective_raises_inside_a_segment(call):
    """A call that reads the host raises inside a segment (a capture could
    not hold it, a replay would not repeat it), in the graphed workspace and
    inside `graphs.eager()` alike, and runs between segments."""
    call()
    ws = graphs.Workspace("cpu")
    ws.load("x", torch.zeros(2))
    for ctx in (graphs.eager, graphs.uncaptured):
        with ctx(), pytest.raises(RuntimeError, match="reads the host"):
            ws.run("segment", lambda b: {"x": b["x"] + float(call())})
    call()


def test_workspace_on_a_gloo_mesh_does_not_capture():
    """A workspace on a mesh that cannot capture (gloo) runs its segments op
    by op on any device; one with no mesh captures on the card only."""
    gloo = SolverMesh(space=2, rank=0, device=torch.device("cpu"))
    assert not gloo.capturable
    assert not graphs.Workspace("cpu").captures
    assert not graphs.Workspace("cpu", mesh=gloo).captures
    assert not graphs.will_capture("cpu") and not graphs.will_capture("cpu", gloo)
    assert graphs.mesh_key(None) is None
    assert graphs.mesh_key(gloo) != graphs.mesh_key(dataclasses.replace(gloo, rank=1))


def test_counters_replay_dicts_key_by_key():
    """A registered counter may be a dict of counts (`COUNTS`): a capture's
    ticks and their replay combine key by key, a key one side lacks
    counting 0."""
    import operator

    before = {"calls": {"a": 1}, "bytes": {"a": 4}}
    after = {"calls": {"a": 3, "b": 1}, "bytes": {"a": 12, "b": 8}}
    ticks = graphs._combine(after, before, operator.sub)
    assert ticks == {"calls": {"a": 2, "b": 1}, "bytes": {"a": 8, "b": 8}}
    assert graphs._combine(after, ticks, operator.add) == {
        "calls": {"a": 5, "b": 2}, "bytes": {"a": 20, "b": 16}}
    assert graphs._combine(5, 3, operator.sub) == 2


def test_cli_mesh_says_its_segments_ran_uncaptured(tmp_path):
    """The CLI on a 1x2 gloo CPU mesh: rank 0's log says that the segments
    ran uncaptured, op by op, and why."""
    import socket

    argv = ["--example", "plane", "--n_space", "10", "--ntime", "4", "--nit", "5",
            "--tol", "1e-3", "--precision", "float32", "--device", "cpu",
            "--laplacian_mode", "cg", "--mesh_shape", "1x2", "--dist_backend", "gloo",
            "--num_processes", "2"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD_ENV)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "dots_socp_torch.cli", *argv, "--process_id", str(r),
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
    line = "Mesh 1x2 over gloo: segments run uncaptured, op by op (gloo cannot be captured)"
    assert line in logs[0] and line not in logs[1]
