"""Times of the port's hand-written kernels on one NVIDIA GPU: B1 and
B1-f64, B2, K4 and K4-f64, and K6, one measuring function per kernel
family with the dtype as its argument. This is where a kernel is timed; its
correctness is held in tests/test_torch_cuda.py.

    python -m dots_socp_torch.bench_kernels [--n_space N] [--skip_b2] [--sweep] [--out FILE]

At plane n200 (V=46,431; --n_space picks another resolution, e.g. 410 for
V=194,814), with the operators and settled states the main path's
`build_problem` makes:

  b1  -- B1 (float32) and B1-f64 (float64) at B1_MODES modes (ntime 31, 32
         and 127): the wrapper, its plain PyTorch version, the library call
         (torch.sparse.mm of the CSR form of the same operator with the
         vertex-major x, in the operator's dtype) and the port's ELL gather
         matvec (`ell_us`, the float64 CG's route before B1-f64)
  b2  -- B2 on every shard of B2_SHARDS blocked shards (unless --skip_b2):
         the wrapper, which gathers its window from the shard's state and
         the export buffer, its plain version and the library call on the
         window vector
  k4  -- K4 and K4-f64 at K4_MODES modes, from the settled inner state:
         the call with the deflation GEMMs between its launches (`kernel`;
         `k4_us` its launches alone there and inside the whole iteration,
         `by_stage` each launch), its plain
         version, and the whole inner iteration on K4's route, as a no-op
         (live false) and on the torch route (`_CGSystem.gated_step`);
         the walks' split plan; the launches the timing counted
  k6  -- K6 at plane n64 float32 (spectral, float32 phi), at --n_space
         float32 (CG, float64 phi) and float64, on a state settled by 15 host
         iterations: its three launches (`kernel`; `k6_us` the three alone,
         without the torch ops of its scalars, `by_stage` each) beside the
         torch route (`plain`, `solver/step.py::_after_phi`)

Each timed entry, per call:

  device_us  -- summed durations of the GPU kernels of one call
                (torch.profiler, 50+ warm calls; `events` says how many of
                them the profiler recorded and in how many sessions, and its
                `launches_per_call`), with `by_kernel` naming every launch
  call_us    -- median latency of one call, host launch overhead included
                (CUDA events, synchronised between calls)

beside each kernel's `bound`: the least time the card could take, each
input and output moved once at 3.35 TB/s against its flops at the FP32 or
FP64 rate (the larger wins; `by` says which).

With --sweep the window kernels are also timed at every tile size of
SWEEP_TILE_ROWS and of `tile_candidates` (the rule of ops/window_spmv.py
rests on this). The shapes beyond --n_space's are K4's in
`python -m dots_socp_torch.scripts.k4_sweep`.

One JSON object is printed (and written to --out), then the card's name and
power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from dots_socp_torch.kernel_timing import (
    N_TIME,
    cg_step_bound,
    device_ms,
    ell_laplacian,
    f64_launches,
    ialm_step_bound,
    launch_times_us,
    library_ms,
    median_call_ms,
    nvidia_smi_line,
    reset_counts,
    shard_bound,
    shard_inputs,
    window_bound,
)
from dots_socp_torch.ops import sharded_window as swm
from dots_socp_torch.ops import window_spmv
from dots_socp_torch.ops.laplacian import ell_matvec

DTYPES = ("float32", "float64")
B1_MODES = (32, 33, 128)
B2_SHARDS = ((2, 32), (4, 32), (2, 33))  # (shards, modes)
K4_MODES = (32, 128)
SWEEP_TILE_ROWS = (64, 96, 128, 176, 256, 352, 512)
MAX_ITERS = 2**31 - 1


def _timed(fn):
    ms, by_name, events = device_ms(fn)
    return {"device_us": ms * 1e3, "call_us": median_call_ms(fn) * 1e3,
            "by_kernel": {k[:70]: round(t * 1e3, 3) for k, t in by_name.items()},
            "events": events}


def _us_of(timed, name):
    """Device µs of the launches in `timed` whose kernel names hold `name`."""
    return sum(t for k, t in timed["by_kernel"].items() if name in k)


def _meta(op, n_rows):
    return {"tile_rows": op.tile_rows, "width": op.width, "nnz_pad": int(op.lcol.shape[-1]),
            "tiles": -(-n_rows // op.tile_rows)}


def _cg_op(geometry, n_time, dtype="float32", shards=1):
    """The CG operator the main path's `build_problem` makes for `geometry`
    at `n_time` (with `shards` > 1, blocked in that many space shards, on
    the host); no deflation vectors (the tiles do not depend on them)."""
    from dots_socp_torch.solver.problem import build_problem

    kw = {"device": "cuda"} if shards == 1 else {
        "space_partitions": shards, "mesh_axes": (1, shards), "device": "cpu"}
    _, data, _ = build_problem(n_time, geometry, dtype=dtype, cg_deflation_k=0,
                               laplacian_mode="cg", **kw)
    return data.cg_op


def measure_b1(wop, cg_op=None, lanes=N_TIME + 1, with_plain=True):
    """B1, or B1-f64 on a float64 operator: the wrapper, the plain version,
    the library call and (with `cg_op`) the ELL gather, each on the same x."""
    v = wop.perm.shape[0]
    x = torch.randn(lanes, v, dtype=wop.vals.dtype, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    out = {"shape": [lanes, v], "dtype": str(wop.vals.dtype), "meta": _meta(wop, v),
           "bound": window_bound(wop, v, lanes, v),
           "kernel": _timed(lambda: window_spmv.window_matvec(wop, x))}
    if with_plain:
        out["plain"] = _timed(lambda: window_spmv.window_matvec_plain(wop, x))
        ms, events = library_ms(wop, x, v)
        out["library"] = {"device_us": ms * 1e3, "events": events}
        if cg_op is not None:
            out["ell_us"] = device_ms(lambda: ell_matvec(cg_op, x))[0] * 1e3
    return out


def measure_b2(sw_all, n_shards, lanes=N_TIME + 1, with_plain=True):
    """B2 on every shard: the wrapper, which gathers its window from the
    shard's state and the export buffer, the plain version and the library
    call on the window vector."""
    _, shards, xs, buf = shard_inputs(sw_all, n_shards, lanes)
    per_shard = []
    for sw, xl in zip(shards, xs):
        v_chunk = sw.state_in.shape[-1]
        xw = swm.window_vector(sw, xl, buf)
        out = {"rows": v_chunk, "Nw": int(xw.shape[-1]), "Wb": int(sw.exp_codes.shape[-1]),
               "bound": shard_bound(sw, lanes, buf.shape[-1]),
               "kernel": _timed(lambda: swm.shard_spmv(sw, xl, buf))}
        if with_plain:
            out["plain"] = _timed(lambda: swm.sharded_window_matvec_plain(sw, xw))
            ms, events = library_ms(sw, xw, v_chunk)
            out["library"] = {"device_us": ms * 1e3, "events": events}
        per_shard.append(out)
    return {"shards": n_shards, "shape": [lanes, n_shards * shards[0].state_in.shape[-1]],
            "meta": _meta(shards[0], shards[0].state_in.shape[-1]), "per_shard": per_shard}


def measure_k4(n_space, lanes, dtype):
    """K4 (float32) or K4-f64 (float64) at `lanes` modes on plane
    `n_space`'s settled inner state, every row live (threshold 0): each
    form timed on its own copy of the state, which advances as it is timed."""
    from dots_socp_torch.ops import cg_step as k4
    from dots_socp_torch.scripts.common import settled_cg_state
    from dots_socp_torch.scripts.k4_sweep import stage_bounds_us

    cg, st = settled_cg_state(n_space, lanes - 1, "cuda", dtype=dtype)
    if not (cg.fused and cg.use_window and cg.work == getattr(torch, dtype)):
        raise RuntimeError(f"bench_kernels: the {dtype} CG is not on K4's route")
    names = ("x", "r", "p", "rz", "rr", "it", "live")
    rows, n = st["x"].shape
    k = cg.leaves.defl_q.shape[-1]
    size = st["x"].element_size()
    zero = torch.zeros_like(st["thresh"])
    lap = window_spmv.window_matvec(cg.wop, st["p"])

    on_k, on_p, on_stages, on_it, on_noop, on_torch = (
        [st[key].clone() for key in names] for _ in range(6))
    on_noop[-1].fill_(False)
    reset_counts()
    kernel = _timed(lambda: k4.cg_step(lap, *on_k, zero, MAX_ITERS, cg.leaves))
    by_stage = launch_times_us(lambda: k4.cg_step(lap, *on_stages, zero, MAX_ITERS, cg.leaves),
                               "cg_step_", k4.STAGES)
    plain = _timed(lambda: k4.cg_step_plain(lap, *on_p, zero, MAX_ITERS, cg.leaves))
    iteration = _timed(lambda: cg.fused_step(*on_it, zero, MAX_ITERS))
    noop = _timed(lambda: cg.fused_step(*on_noop, zero, MAX_ITERS))
    torch_route = _timed(lambda: cg.gated_step(*on_torch, zero, MAX_ITERS))
    launches = dict(zip(("b1_f64", "k4_f64", "b1", "k4"), f64_launches()))
    sms, threads = k4._card(torch.device("cuda"))
    plan = k4.split_plan(k4.row_sum_config(rows, n, sms, threads), rows, sms, elem_bytes=size)
    return {"shape": [rows, n], "deflation_rank": k, "dtype": dtype,
            "plan": {key: getattr(plan, key) for key in ("lanes", "depth", "cluster", "blocks",
                                                        "threads")},
            "bound": cg_step_bound(rows, n, k, value_bytes=size),
            "iteration_bound": cg_step_bound(rows, n, k, cg.wop, value_bytes=size),
            "stage_bound_us": {key: us * size / 4 for key, us in stage_bounds_us(rows, n).items()},
            "kernel": kernel,
            "k4_us": {"call": _us_of(kernel, "cg_step_"), "iteration": _us_of(iteration, "cg_step_")},
            "by_stage": None if by_stage is None else dict(zip(k4.STAGE_NAMES, by_stage)),
            "plain": plain, "iteration": iteration, "iteration_noop": noop,
            "torch_route": torch_route, "launches": launches}


def measure_k6(n_space, precision):
    """K6 on plane `n_space` (`precision`) from a settled state: the fused
    step and the torch route, each timed on its own copy of the state, which
    advances as it is timed."""
    from dots_socp_torch.ops import ialm_step as k6
    from dots_socp_torch.scripts.common import settled_ialm_state
    from dots_socp_torch.solver import step

    config, data, state, phi = settled_ialm_state(n_space, N_TIME, precision, "cuda")

    def copy():
        return state._replace(**{name: getattr(state, name).clone() for name in k6.OUTPUTS})

    fused, on_stages, plain = copy(), copy(), copy()
    kernel = _timed(lambda: step._after_phi(config, data, fused, phi, fused=True))
    by_stage = launch_times_us(lambda: step._after_phi(config, data, on_stages, phi, fused=True),
                               "ialm_", k6.LAUNCHES)
    T, V = state.A.shape
    F, D = data.ops.tri.shape[0], data.ops.inc_table.shape[-1]
    return {"shape": {"T": T, "V": V, "F": F, "D": D}, "work": str(state.A.dtype),
            "phi": str(phi.dtype),
            "bound": ialm_step_bound(T, V, F, D, state.A.element_size(), phi.element_size()),
            "kernel": kernel, "k6_us": _us_of(kernel, "ialm_"),
            "by_stage": None if by_stage is None else dict(zip(k6.STAGE_NAMES, by_stage)),
            "plain": _timed(lambda: step._after_phi(config, data, plain, phi))}


def sweep(geometry):
    """B1 and B2 at every tile size of the grid and of the builders' rule."""
    lap = ell_laplacian(_cg_op(geometry, N_TIME))
    v = lap.shape[0]
    coords = np.asarray(geometry["vertices"])
    coords = coords if coords.shape[0] == v else None
    ones = np.ones(v)
    out = {"b1_sweep": [], "b2_sweep": []}
    for tv in sorted(set(SWEEP_TILE_ROWS + window_spmv.tile_candidates(v))):
        tiles = window_spmv.build_window_tiles(lap, coords=coords, tile_rows=tv)
        op = window_spmv.window_operator(tiles, ones, np.ones((1, v)), ones, np.zeros((v, 0)),
                                         "cuda")
        m = measure_b1(op, with_plain=False)
        out["b1_sweep"].append({"meta": tiles.meta, "device_us": m["kernel"]["device_us"]})
    for s in sorted({s for s, _ in B2_SHARDS}):
        lap_b = ell_laplacian(_cg_op(geometry, N_TIME, shards=s))
        v_pad = lap_b.shape[0]
        for tv in sorted(set(SWEEP_TILE_ROWS + window_spmv.tile_candidates(v_pad // s))):
            built = swm.build_sharded_window(
                lap_b, v_pad // s, s, av=np.ones(v_pad), jacobi=np.ones((1, v_pad)),
                s_vec=np.ones(v_pad), defl_q=np.zeros((v_pad, 0)), real=np.ones(v_pad),
                tile_rows=tv)
            m = measure_b2(swm.sharded_window_to_torch(built[0], "cpu"), s, with_plain=False)
            out["b2_sweep"].append({
                "shards": s, "meta": built[1],
                "device_us": [p["kernel"]["device_us"] for p in m["per_shard"]]})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true", help="also time every tile size")
    ap.add_argument("--out", default=None, help="write the result to this JSON file")
    ap.add_argument("--n_space", type=int, default=200,
                    help="resolution of the plane mesh (default 200: V=46,431)")
    ap.add_argument("--skip_b2", action="store_true", help="time no B2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs an NVIDIA GPU")
    if args.sweep and args.skip_b2:
        ap.error("--sweep times B2 too: drop --skip_b2")
    from dots_socp_torch import cli

    geometry = cli.load_geometry("plane", args.n_space)
    out = {"card": nvidia_smi_line(), "n_space": args.n_space, "b1": {}, "k4": {}}
    for dtype in DTYPES:
        out["b1"][dtype] = {}
        for lanes in B1_MODES:
            cg_op = _cg_op(geometry, lanes - 1, dtype)
            out["b1"][dtype][str(lanes)] = measure_b1(cg_op.window, cg_op, lanes)
            del cg_op
    out["b2"] = [] if args.skip_b2 else [
        measure_b2(_cg_op(geometry, lanes - 1, shards=s).swindow, s, lanes)
        for s, lanes in B2_SHARDS]
    for dtype in DTYPES:
        out["k4"][dtype] = {str(lanes): measure_k4(args.n_space, lanes, dtype)
                            for lanes in K4_MODES}
    out["k6"] = {"n64": measure_k6(64, "float32"),
                 f"n{args.n_space}": measure_k6(args.n_space, "float32"),
                 f"n{args.n_space}_f64": measure_k6(args.n_space, "float64")}
    if args.sweep:
        out.update(sweep(geometry))
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(nvidia_smi_line())


if __name__ == "__main__":
    main()
