"""One rank of a sharded run of the port, for the CPU tests.

    python tests/torch_rank_worker.py TASK IN_NPZ OUT_DIR RANK WORLD INIT_METHOD \
        [DEVICE [MESH_SHAPE [BACKEND]]]

Brings up torch.distributed (BACKEND, default gloo; `INIT_METHOD` such as
file:///tmp/x), makes the MESH_SHAPE mesh (default 1xWORLD) on DEVICE
(default cpu; nccl takes a card per rank), runs
TASK on this rank's shard and writes OUT_DIR/rank{RANK}.npz. The inputs (a geometry and
seeded arrays in blocked order) come from IN_NPZ, made by the test with
numpy. This module imports no jax: the JAX side of each comparison runs in
the pytest process.

Tasks:
  halo   -- halo_gather / halo_reduce of the given fields
  window -- kernel B2's matvec through the window permutes, the permute
            round trip, and a refined sharded cg_solve
  solve  -- solver_socp on the mesh; every rank writes the solution
  resume -- solver_socp to `first_nit` iterations with a snapshot, then a
            second call that resumes from it to `nit`
  refused -- solver_socp as `solve`, expected to raise a ValueError before
            any collective; its message (or "no error")
  timeaxis -- on a mesh with a time axis: the sharded time stencils and
            norms of seeded arrays, shard_state -> gather_state of a seeded
            state, and the error of an n_time the time axis does not divide
  chunk  -- `iterations` calls of `step.iteration` from the solver's initial
            state on the mesh's shards; the gathered state and KKT table
  mesh_cg -- `cg_solve` through the blocked loops at each of MESH_CG_BLOCKS
            and through the host loop inside `graphs.eager()`, on the
            window (B2) and halo layouts, refined and not: x, count, flag
            reads, the flags after every block, the collectives counted,
            and those of one latched inner iteration
  loops  -- `solve` through the graphed loops (the workspace's segments)
            and inside `graphs.eager()`: both solutions and run histories,
            and the host reads, segment runs and collectives of each

`run_ranks` starts the ranks for a test and collects their outputs.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from dots_socp_torch.ops import laplacian as tl
from dots_socp_torch.ops import sharded_window as tsw
from dots_socp_torch.parallel import distributed as pd
from dots_socp_torch.parallel.halo import halo_gather, halo_reduce
from dots_socp_torch.parallel.mesh import shard_problem
from dots_socp_torch.solver.problem import build_problem, initial_state

REPO = Path(__file__).resolve().parents[1]


#: Environment of a subprocess that should compute on one thread.
ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def one_thread():
    """PyTorch's intra-op pool and the BLAS's pool cut to one thread inside.
    Several pytest workers, each with pools as wide as the machine, slow
    each other down by an order of magnitude; the small problems of the
    tests gain nothing from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # then only PyTorch's pool is cut
        threadpool_limits = None
    try:
        with threadpool_limits(limits=1) if threadpool_limits else contextlib.nullcontext():
            yield
    finally:
        torch.set_num_threads(before)


def geometry_inputs(geometry):
    """The geometry's arrays under the worker's geo_ keys."""
    return {f"geo_{k}": np.asarray(v) for k, v in geometry.items() if v is not None}


def run_ranks(tmp_path, task, world, inputs, device="cpu", timeout=300, mesh_shape=None,
              backend="gloo"):
    """Run `task` on `world` ranks over `backend` (a 1 x world mesh, or
    `mesh_shape` "TxS" with T * S = world); each rank's outputs, in rank order.
    One thread per rank: several CPU ranks with PyTorch's default thread
    pools slow each other down by an order of magnitude."""
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD_ENV)
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__)), task, str(tmp_path / "in.npz"), str(tmp_path),
             str(r), str(world), init, device, mesh_shape or f"1x{world}", backend],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:  # a hung rank fails the test, and is stopped
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _geometry(inp):
    return {k[4:]: v for k, v in inp.items() if k.startswith("geo_")}


def _block(a, mesh, axis=-1):
    """This rank's block of a blocked-order array along `axis`."""
    a = np.asarray(a)
    n = a.shape[axis] // mesh.space
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(mesh.rank * n, (mesh.rank + 1) * n)
    return torch.from_numpy(np.ascontiguousarray(a[tuple(idx)])).to(mesh.device)


def _problem(inp, mesh, **kw):
    config, data, extras = build_problem(
        int(inp["n_time"]), _geometry(inp), space_partitions=mesh.space,
        mesh_axes=(mesh.time, mesh.space), device="cpu", mesh=mesh, **kw,
    )
    return config, shard_problem(mesh, data), extras


def task_halo(inp, mesh):
    _, data, _ = _problem(inp, mesh, dtype="float64", laplacian_mode="cg",
                          cg_deflation_k=0, phi_refine="off")
    return {
        "gathered": halo_gather(mesh, data.halo, _block(inp["values"], mesh)),
        "reduced": halo_reduce(mesh, data.halo, data.ops.inc_mask,
                               _block(inp["corners"], mesh, axis=1)),
    }


def task_window(inp, mesh):
    _, data, _ = _problem(inp, mesh, dtype="float32", laplacian_mode="cg",
                          cg_deflation_k=16, cg_rtol=1e-7, phi_refine="on")
    sw = data.cg_op.swindow
    x = _block(inp["x"], mesh)
    xw = tsw.window_permute(sw, x)
    y = tsw.window_permute(sw, tsw.sharded_window_matvec(sw, mesh, xw), inverse=True)
    before, launches = tl.CG_COUNTERS.window_matvecs, tsw.KERNEL_LAUNCHES
    # Kernel B2 reads the CG state and the export buffer in place: count the
    # matvecs that are handed anything but contiguous tensors.
    strided = []
    spmv = tsw.shard_spmv

    def spy(sw_, x_, buf_):
        strided.append(not (x_.is_contiguous() and buf_.is_contiguous()))
        return spmv(sw_, x_, buf_)

    tsw.shard_spmv = spy
    try:
        sol, iters = tl.cg_solve(
            data.ops, data.cg_op, _block(inp["rhs"], mesh), max_iters=2000,
            halo=data.halo, mesh=mesh, ops_hi=data.ops_hi, return_iters=True,
        )
    finally:
        tsw.shard_spmv = spmv
    return {
        "y": y,
        "round_trip": tsw.window_permute(sw, xw, inverse=True),
        "cg_x": sol,
        "cg_iters": torch.tensor(iters),
        "cg_window_matvecs": torch.tensor(tl.CG_COUNTERS.window_matvecs - before),
        "cg_b2_launches": torch.tensor(tsw.KERNEL_LAUNCHES - launches),
        "cg_strided_matvecs": torch.tensor(sum(strided)),
        "cg_spied_matvecs": torch.tensor(len(strided)),
    }


def task_solve(inp, mesh, **over):
    from dots_socp_torch.solver import solver_socp

    kw = {k[3:]: v.item() for k, v in inp.items() if k.startswith("kw_")}
    kw.update(over)
    solution, history = solver_socp(int(inp["n_time"]), _geometry(inp), mesh=mesh, **kw)
    return {
        "mu": solution["mu"], "E": solution["E"], "phi": solution["phi"],
        "kkt_iteration": history.kkt_iteration, "kkt_errors": history.kkt_errors,
    }


def task_resume(inp, mesh):
    task_solve(inp, mesh, nit=int(inp["first_nit"]))
    return task_solve(inp, mesh, nit=int(inp["nit"]))


def task_refused(inp, mesh):
    try:
        task_solve(inp, mesh)
    except ValueError as err:
        return {"error": str(err)}
    return {"error": "no error"}


def _time_block(a, mesh):
    return a[mesh.time_block(a.shape[0])]


def task_timeaxis(inp, mesh):
    """Arrays come whole; this rank cuts its (time, space) block of each."""
    from dots_socp_torch.ops import norms, time_stencils as ts
    from dots_socp_torch.parallel.mesh import gather_state, shard_state
    from dots_socp_torch.solver import solver_socp
    from dots_socp_torch.solver.state import SolverState

    dt = 1.0 / int(inp["n_time"])
    stag = _time_block(_block(inp["stag"], mesh), mesh)  # (T_loc, V_loc)
    cone = _time_block(_block(inp["cone"], mesh, axis=2), mesh)  # (T_loc, 2, F_loc, 3, 3)
    cent = _block(inp["cent"], mesh)  # (T+1, V_loc)
    cent_f = _block(inp["cent_f"], mesh, axis=1)  # (T+1, F_loc, 3)
    av, area_f = _block(inp["av"], mesh), _block(inp["area_f"], mesh)
    n_time = int(inp["n_time"])
    out = {
        "div_time": ts.div_time(dt, stag, mesh),
        "time_center_adjoint": ts.time_center_adjoint(stag, mesh),
        "decouple_space_adjoint": ts.decouple_space_adjoint(cone, 1.7, mesh),
        "grad_time": ts.grad_time(dt, cent, mesh),
        "decouple_space": ts.decouple_space(cent_f, 1.7, mesh),
        "nst": norms.norm_sq_vertex(av, stag, n_time, mesh, staggered=True),
        "nsc": norms.norm_sq_vertex(av, cent, n_time + 1, mesh),
        "nss": norms.norm_sq_triangle(area_f, cent_f, n_time + 1, mesh),
        "nsd": norms.norm_sq_decouple(area_f, cone, n_time, mesh),
    }
    whole = SolverState(**{f: torch.from_numpy(inp[f"st_{f}"]) for f in SolverState._fields})
    shard = shard_state(mesh, whole)
    out.update({f"shard_{f}": getattr(shard, f) for f in ("A", "phi", "z_mid", "B")})
    out.update({f"st_{f}": x for f, x in zip(SolverState._fields, gather_state(mesh, shard))})
    try:
        solver_socp(n_time - 1, _geometry(inp), mesh=mesh, nit=1)
        out["indivisible"] = "no error"
    except ValueError as err:
        out["indivisible"] = str(err)
    return out


def task_chunk(inp, mesh):
    from dots_socp_torch.parallel.mesh import gather_state, shard_state
    from dots_socp_torch.solver.kkt import kkt_table
    from dots_socp_torch.solver.scaling import apply_z_scale
    from dots_socp_torch.solver.step import run_chunk

    kw = {k[3:]: v.item() for k, v in inp.items() if k.startswith("kw_")}
    n_time = int(inp["n_time"])
    config, whole, extras = build_problem(
        n_time, _geometry(inp), space_partitions=mesh.space,
        mesh_axes=(mesh.time, mesh.space), device="cpu", mesh=mesh, **kw,
    )
    state = initial_state(config, whole, extras, norm_constant_d=extras["norm_constant_d"])
    data = shard_problem(mesh, whole)
    state = apply_z_scale(shard_state(mesh, state), 2.0, mesh)
    before, launches = tl.CG_COUNTERS.window_matvecs, tsw.KERNEL_LAUNCHES
    state = run_chunk(config, data, state, int(inp["iterations"]))
    out = {
        "kkt": kkt_table(config, data, state),
        "window_matvecs": torch.tensor(tl.CG_COUNTERS.window_matvecs - before),
        "b2_launches": torch.tensor(tsw.KERNEL_LAUNCHES - launches),
    }
    out.update({f"st_{f}": x for f, x in zip(state._fields, gather_state(mesh, state))})
    return out


#: Block lengths of the latched CG that `mesh_cg` runs.
MESH_CG_BLOCKS = (1, 3, 8)


def _counted(prefix, counts):
    """`ops.collectives.COUNTS.snapshot()` as flat output keys."""
    return {f"{prefix}_{kind}_{key}": torch.tensor(n)
            for kind, per_key in counts.items() for key, n in per_key.items()}


@contextlib.contextmanager
def _segment_spy(on_run):
    """`on_run(workspace, name)` after every `graphs.Workspace.run`."""
    from dots_socp_torch.ops import graphs

    real_run = graphs.Workspace.run

    def run(self, name, fn):
        real_run(self, name, fn)
        on_run(self, name)

    graphs.Workspace.run = run
    try:
        yield
    finally:
        graphs.Workspace.run = real_run


def task_mesh_cg(inp, mesh):
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.ops.collectives import COUNTS

    rhs, x0 = _block(inp["rhs"], mesh), _block(inp["x0"], mesh)
    flags = []

    def log_flags(ws, name):
        if name == "block":
            flags.append(ws.bufs["flags"].tolist())

    out = {}
    for refine in ("on", "off"):
        _, data, _ = _problem(inp, mesh, dtype="float32", laplacian_mode="cg",
                              cg_deflation_k=8, cg_rtol=1e-5, phi_refine=refine)
        for layout in ("window", "halo"):
            d = data
            if layout == "halo":
                d = data._replace(cg_op=data.cg_op._replace(swindow=None))
            case = f"{layout}_{'refined' if refine == 'on' else 'plain'}"
            cg = tl._CGSystem(d.ops, d.cg_op, rhs.dtype, d.halo, mesh, d.ops_hi)
            x, r, p, rz, rr = cg.pcg_start(rhs, x0)
            it = torch.zeros((), dtype=torch.int64)
            live = torch.ones((), dtype=torch.bool)
            thresh = cg.row_thresh(rhs, 1e-5)
            COUNTS.reset()
            cg.gated_step(x, r, p, rz, rr, it, live, thresh, 2000)
            out.update(_counted(f"{case}_step", COUNTS.snapshot()))
            for mode in ("eager",) + tuple(f"b{k}" for k in MESH_CG_BLOCKS):
                COUNTS.reset()
                tl.CG_COUNTERS.reset()
                flags.clear()
                graphs.release()
                if mode != "eager":
                    tl.CG_BLOCK = int(mode[1:])
                with graphs.eager() if mode == "eager" else _segment_spy(log_flags):
                    sol, iters = tl.cg_solve(d.ops, d.cg_op, rhs, x0=x0, max_iters=2000,
                                             halo=d.halo, mesh=mesh, ops_hi=d.ops_hi,
                                             return_iters=True)
                out.update(_counted(f"{case}_{mode}", COUNTS.snapshot()))
                out.update({
                    f"{case}_{mode}_x": sol,
                    f"{case}_{mode}_iters": torch.tensor(iters),
                    f"{case}_{mode}_flag_reads": torch.tensor(tl.CG_COUNTERS.flag_reads),
                    f"{case}_{mode}_window_matvecs": torch.tensor(tl.CG_COUNTERS.window_matvecs),
                    f"{case}_{mode}_flags": torch.tensor(flags, dtype=torch.int64).reshape(-1, 3),
                })
    graphs.release()
    return out


def task_loops(inp, mesh):
    import collections

    from dots_socp_torch.ops import graphs
    from dots_socp_torch.ops.collectives import COUNTS
    from dots_socp_torch.solver import socp

    runs = collections.Counter()
    segment = socp.run_chunk_adaptive

    def counted_segment(*args, **kwargs):
        runs["segments"] += 1
        return segment(*args, **kwargs)

    out = {"capturable": torch.tensor(mesh.capturable)}
    socp.run_chunk_adaptive = counted_segment
    try:
        for mode in ("loops", "eager"):
            runs.clear()
            COUNTS.reset()
            tl.CG_COUNTERS.reset()
            tsw.KERNEL_LAUNCHES = 0
            reads, stats = graphs.HOST_READS, graphs.STATS.snapshot()
            with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                with _segment_spy(lambda ws, name: runs.update([name])):
                    res = task_solve(inp, mesh)
            stats = graphs.STATS.since(stats)
            out.update({f"{mode}_{k}": v for k, v in res.items()})
            out.update(_counted(mode, COUNTS.snapshot()))
            out.update({f"{mode}_{k}": torch.tensor(v) for k, v in {
                "host_reads": graphs.HOST_READS - reads,
                "flag_reads": tl.CG_COUNTERS.flag_reads,
                "inner": tl.CG_COUNTERS.iterations,
                "solves": tl.CG_COUNTERS.solves,
                "b2_launches": tsw.KERNEL_LAUNCHES,
                "window_matvecs": tl.CG_COUNTERS.window_matvecs,
                "captures": stats["captures"],
                "uncaptured_runs": stats["uncaptured_runs"],
                **{f"runs_{k}": runs[k] for k in ("segments", "block", "finish", "validate")},
            }.items()})
    finally:
        socp.run_chunk_adaptive = segment
    return out


def main(argv):
    task, in_npz, out_dir, rank, world, init_method = argv[:6]
    device = argv[6] if len(argv) > 6 else "cpu"
    mesh_shape = argv[7] if len(argv) > 7 else f"1x{world}"
    backend = argv[8] if len(argv) > 8 else "gloo"
    pd.initialize_distributed(
        backend, init_method=init_method, num_processes=int(world), process_id=int(rank)
    )
    try:
        mesh = pd.make_solver_mesh(mesh_shape, device=device)
        with np.load(in_npz) as f:
            inp = {k: f[k] for k in f.files}
        out = TASKS[task](inp, mesh)
        host = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in out.items()}
        np.savez(f"{out_dir}/rank{rank}.npz", **host)
    finally:
        torch.distributed.destroy_process_group()


TASKS = {"halo": task_halo, "window": task_window, "solve": task_solve, "resume": task_resume,
         "refused": task_refused,
         "timeaxis": task_timeaxis, "chunk": task_chunk, "mesh_cg": task_mesh_cg,
         "loops": task_loops}

if __name__ == "__main__":
    main(sys.argv[1:])
