"""What the port's measurement drivers share: the plane problem as the main
path builds it, the device and its synchronisation, timed windows, and the
JSON line each driver ends in.

Every time here is taken by the host clock around a window that ends in a
device synchronisation (`timed`), so it is what the caller pays on either
device; on the card `event_ms` adds the device's own time of the same
window (CUDA events). A driver names the device it ran on in its last line
(`device_fields`): the card's name and power limit, or "cpu".
"""

from __future__ import annotations

import json
import time

import torch

from dots_socp_torch.ops import resolve_device


def add_device_arg(parser):
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; asking for cuda without a card fails; cpu runs "
        "the kernels' plain versions)")


def plane_problem(n_space, n_time, dtype, device, mesh=None, **build_kw):
    """(config, data, state): the plane problem at resolution `n_space` and
    its initial state, built by `solver.problem.{build_problem,
    initial_state}` with the port's defaults (no vertex padding), cut to
    `mesh`'s shard when one is given (as `solver_socp` builds them). The
    counterpart of the JAX package's `__graft_entry__._build`."""
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.parallel.mesh import shard_problem, shard_state
    from dots_socp_torch.solver.problem import build_problem, initial_state

    space = mesh.space if mesh is not None else 1
    config, data, extras = build_problem(
        n_time,
        load_geometry("plane", n_space),
        dtype=dtype,
        space_partitions=space,
        mesh_axes=(mesh.time, space) if mesh is not None else None,
        # A space-sharded problem is built whole on the host, then cut.
        device="cpu" if space > 1 else device,
        mesh=mesh,
        **build_kw,
    )
    state = initial_state(config, data, extras)
    if mesh is not None:
        data, state = shard_problem(mesh, data), shard_state(mesh, state)
    return config, data, state


def settled_cg_state(n_space, n_time, device, settle=20, inner=10, rtol=1e-12, dtype="float32",
                     **build_kw):
    """(cg, state): plane `n_space`'s single-device CG system (`dtype`:
    float32 with refinement, or float64 without;
    `ops.laplacian._CGSystem`) and an inner PCG state as a settled phi
    solve has it: `settle` iALM iterations, then the phi solve's first
    inner system (the refinement's first correction, when the problem
    refines; else the solve itself, warm-started at phi) and `inner`
    iterations of it on the torch route. `state` holds x, r, p, rz, rr,
    it, live (the latch) and thresh, in the CG's vertex order; `rtol` sets
    thresh (the default leaves every row active); `build_kw` go to
    `build_problem` (e.g. pad_multiple)."""
    from dots_socp_torch.ops.laplacian import _CGSystem
    from dots_socp_torch.solver.step import laplacian_rhs, run_chunk

    config, data, state = plane_problem(n_space, n_time, dtype, device, laplacian_mode="cg",
                                        **build_kw)
    state = run_chunk(config, data, state, settle)
    rhs = laplacian_rhs(config, data, state)
    op = data.cg_op
    cg = _CGSystem(data.ops, op, rhs.dtype)
    if cg.use_refine:
        ut, f64 = op.u_time_hi, torch.float64
        b64 = cg.deflate(-(ut.T @ rhs.to(f64)))
        b = cg.deflate(b64 - cg.matvec_hi(cg.deflate(ut.T @ state.phi.to(f64)))).to(cg.work)
        x = torch.zeros_like(b)
    else:
        b = cg.deflate(-(op.u_time.T @ rhs))
        x = op.u_time.T @ state.phi.to(b.dtype)
    thresh = cg.row_thresh(b, torch.tensor(rtol, dtype=b.dtype, device=b.device))
    x, r, p, rz, rr = cg.pcg_start(b, x)
    it = torch.zeros((), dtype=torch.int64, device=b.device)
    live = torch.ones((), dtype=torch.bool, device=b.device)
    out = (x, r, p, rz, rr, it, live)
    for _ in range(inner):
        out = cg.gated_step(*out, thresh, 2**31 - 1)
    return cg, dict(zip(("x", "r", "p", "rz", "rr", "it", "live"), out), thresh=thresh)


def settled_ialm_state(n_space, n_time, dtype, device, settle=15, congestion=None,
                       scale_z=None):
    """(config, data, state, phi): plane `n_space`'s problem (`dtype`; the
    automatic phi solve: spectral up to 16,384 vertices, else the CG, with
    refinement in float32), its state after `settle` iALM iterations from
    the host (`graphs.eager()`), with `congestion` and `scale_z` put in its
    scalars where given, and the phi solve of the next iteration: the
    inputs of the step after phi (`solver.step._after_phi`, kernel K6)."""
    from dots_socp_torch.ops import graphs
    from dots_socp_torch.solver.step import run_chunk, solve_laplacian

    config, data, state = plane_problem(n_space, n_time, dtype, device, cg_rtol=5e-4)
    with graphs.eager():
        state = run_chunk(config, data, state, settle)
        for name, value in (("congestion", congestion), ("scale_z", scale_z)):
            if value is not None:
                state = state._replace(**{name: torch.full_like(getattr(state, name), value)})
        phi = solve_laplacian(config, data, state)
    return config, data, state, phi


def on_card(device) -> bool:
    return resolve_device(device).type == "cuda"


def sync(device):
    if on_card(device):
        torch.cuda.synchronize()


def timed(fn, device):
    """(fn(), host seconds): the window starts after a device
    synchronisation and ends in one, so queued work is neither inside it
    nor left out."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def event_ms(fn, device):
    """Device milliseconds of `fn`'s window between two CUDA events (idle
    gaps between its kernels included); None off the card."""
    if not on_card(device):
        return None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return float(start.elapsed_time(end))


def normalized(y):
    """y scaled to unit norm (summed in float64): keeps a chain of dependent
    applications bounded without changing what each one computes."""
    return y * torch.rsqrt((y * y).sum(dtype=torch.float64).to(y.dtype) + 1e-30)


def device_fields(device) -> dict:
    """The device a result was measured on: the card's name and power limit
    as nvidia-smi prints them, or the CPU."""
    if on_card(device):
        from dots_socp_torch.kernel_timing import nvidia_smi_line

        return {"device": "cuda", "card": nvidia_smi_line()}
    return {"device": "cpu", "card": None}


def print_result(result: dict):
    print(json.dumps(result), flush=True)
    return result
