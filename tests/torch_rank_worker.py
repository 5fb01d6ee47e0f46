"""One rank of a space-sharded run of the port, for the CPU tests.

    python tests/torch_rank_worker.py TASK IN_NPZ OUT_DIR RANK WORLD INIT_METHOD [DEVICE]

Brings up torch.distributed (gloo, `INIT_METHOD` such as file:///tmp/x),
makes the (1, WORLD) mesh on DEVICE (default cpu), runs TASK on this
rank's shard and writes OUT_DIR/rank{RANK}.npz. The inputs (a geometry and
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
from dots_socp_torch.solver.problem import build_problem

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


def run_ranks(tmp_path, task, world, inputs, device="cpu", timeout=300):
    """Run `task` on `world` gloo ranks; each rank's outputs, in rank order.
    One thread per rank: several CPU ranks with PyTorch's default thread
    pools slow each other down by an order of magnitude."""
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD_ENV)
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__)), task, str(tmp_path / "in.npz"), str(tmp_path),
             str(r), str(world), init, device],
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
        mesh_axes=(1, mesh.space), device="cpu", mesh=mesh, **kw,
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


def main(argv):
    task, in_npz, out_dir, rank, world, init_method = argv[:6]
    device = argv[6] if len(argv) > 6 else "cpu"
    pd.initialize_distributed(
        "gloo", init_method=init_method, num_processes=int(world), process_id=int(rank)
    )
    try:
        mesh = pd.make_solver_mesh(f"1x{world}", device=device)
        with np.load(in_npz) as f:
            inp = {k: f[k] for k in f.files}
        out = TASKS[task](inp, mesh)
        host = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in out.items()}
        np.savez(f"{out_dir}/rank{rank}.npz", **host)
    finally:
        torch.distributed.destroy_process_group()


TASKS = {"halo": task_halo, "window": task_window, "solve": task_solve, "resume": task_resume}

if __name__ == "__main__":
    main(sys.argv[1:])
