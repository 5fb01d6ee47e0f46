"""Times of the port's hand-written kernels, B1 and B2, B1-f64 and K4-f64,
and K6, on one NVIDIA GPU.

    python -m dots_socp_torch.bench_kernels [--n_space N] [--skip_b2] [--sweep] [--out FILE]

At plane n200 (V=46,431; --n_space picks another resolution, e.g. 410 for
V=194,814), 32 modes, float32, with the tiles the main path's
`build_problem` makes: kernel B1 on one device, and (unless --skip_b2)
kernel B2 on every shard of 2 and of 4 blocked shards. For each, per call:

  device_us  -- summed durations of the GPU kernels of one call
                (torch.profiler, 50+ warm calls; `events` says how many of
                them the profiler recorded and in how many sessions), for
                the wrapper (`kernel`, with `by_kernel` naming every
                launch), for the plain PyTorch version (`plain`), for the
                library call (`library`: torch.sparse.mm of the CSR form of
                the same operator with the vertex-major x, FP32) and for
                the port's ELL gather matvec (`ell`, B1 only)
  call_us    -- median latency of one call, host launch overhead included
                (CUDA events, synchronised between calls)
  bound      -- the least time the card could take: each input and output
                moved once at 3.35 TB/s against 2 flops per nonzero and mode
                at 67 TFLOP/s (the larger wins; `by` says which)

Then the float64 kernels at 32 and 128 modes (ntime 31 and
127), with the tiles and the settled state the float64 main path makes
(`b1_f64`, `k4_f64`): B1-f64 beside its bound at 8 bytes a value, its plain
version, the library call in float64 and the float64 ELL gather; K4-f64 as
one whole inner iteration of the float64 CG on its route (`kernel`: B1-f64,
K4-f64's five launches and the deflation GEMMs; `k4_us`: K4-f64's launches
alone) beside the torch route's (`plain`, `_CGSystem.gated_step`) and K4's
bound at 8 bytes a value.

Then kernel K6, the iALM step after phi (`k6`), at plane n64 float32
(spectral, float32 phi), at --n_space float32 (CG, float64 phi) and float64,
on a state settled by 15 host iterations: its three launches (`kernel`,
with `by_kernel`; `k6_us` the three alone, without the torch ops of its
scalars) beside the torch route (`plain`, `solver/step.py::_after_phi`)
and `ialm_step_bound`, and whether one step of each gives the same bits
(`bit_equal`).

With --sweep the kernels are also timed at every tile size of
SWEEP_TILE_ROWS and of `tile_candidates` (the rule of ops/window_spmv.py
rests on this), and B1 at 128 modes.

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
    ialm_step_bound,
    library_ms,
    median_call_ms,
    nvidia_smi_line,
    shard_bound,
    shard_inputs,
    window_bound,
)
from dots_socp_torch.ops import sharded_window as swm
from dots_socp_torch.ops import window_spmv
from dots_socp_torch.ops.laplacian import ell_matvec

SHARD_COUNTS = (2, 4)
F64_MODES = (32, 128)
SWEEP_TILE_ROWS = (64, 96, 128, 176, 256, 352, 512)


def _timed(fn):
    ms, by_name, events = device_ms(fn)
    return {"device_us": ms * 1e3, "call_us": median_call_ms(fn) * 1e3,
            "by_kernel": {k[:70]: round(t * 1e3, 3) for k, t in by_name.items()},
            "events": events}


def _meta(op, n_rows):
    return {"tile_rows": op.tile_rows, "width": op.width, "nnz_pad": int(op.lcol.shape[-1]),
            "tiles": -(-n_rows // op.tile_rows)}


def measure_b1(wop, cg_op, lanes=N_TIME + 1, with_plain=True):
    """B1 on one operator: the wrapper, the plain version, the library call
    and the ELL matvec, each on the same x."""
    v = wop.perm.shape[0]
    dtype = np.float64 if wop.vals.dtype == torch.float64 else np.float32
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((lanes, v)).astype(dtype)
    ).cuda()
    out = {"shape": [lanes, v], "meta": _meta(wop, v),
           "bound": window_bound(wop, v, lanes, v),
           "kernel": _timed(lambda: window_spmv.window_matvec(wop, x))}
    if with_plain:
        out["plain"] = _timed(lambda: window_spmv.window_matvec_plain(wop, x))
        ms, events = library_ms(wop, x, v)
        out["library"] = {"device_us": ms * 1e3, "events": events}
        if cg_op is not None:
            out["ell_us"] = device_ms(lambda: ell_matvec(cg_op, x))[0] * 1e3
    return out


def measure_b2(sw_all, n_shards, with_plain=True):
    """B2 on every shard: the wrapper, which gathers its window from the
    shard's state and the export buffer, the plain version and the library
    call on the window vector."""
    _, shards, xs, buf = shard_inputs(sw_all, n_shards)
    per_shard = []
    for sw, xl in zip(shards, xs):
        v_chunk = sw.state_in.shape[-1]
        xw = swm.window_vector(sw, xl, buf)
        out = {"rows": v_chunk, "Nw": int(xw.shape[-1]), "Wb": int(sw.exp_codes.shape[-1]),
               "bound": shard_bound(sw, xl.shape[0], buf.shape[-1]),
               "kernel": _timed(lambda: swm.shard_spmv(sw, xl, buf))}
        if with_plain:
            out["plain"] = _timed(lambda: swm.sharded_window_matvec_plain(sw, xw))
            ms, events = library_ms(sw, xw, v_chunk)
            out["library"] = {"device_us": ms * 1e3, "events": events}
        per_shard.append(out)
    return {"shards": n_shards, "meta": _meta(shards[0], shards[0].state_in.shape[-1]),
            "per_shard": per_shard}


def measure_f64(n_space, lanes):
    """B1-f64 and K4-f64 at `lanes` modes on plane `n_space`'s float64 CG
    path: B1-f64 on the main path's operator (`measure_b1`), and whole
    inner iterations from a settled float64 state (live, every row active)
    on K4-f64's route and on the torch route."""
    from dots_socp_torch.ops import cg_step as k4
    from dots_socp_torch.scripts.common import settled_cg_state

    cg, st = settled_cg_state(n_space, lanes - 1, "cuda", settle=5, inner=0, rtol=1e-30,
                              dtype="float64")
    if not (cg.fused and cg.work == torch.float64):
        raise RuntimeError("bench_kernels: the float64 CG is not on K4-f64's route")
    names = ("x", "r", "p", "rz", "rr", "it", "live")
    fused = tuple(st[k].clone() for k in names)
    plain = tuple(st[k].clone() for k in names)
    n, k = cg.op.s.shape[0], cg.leaves.defl_q.shape[-1]
    kernel = _timed(lambda: cg.fused_step(*fused, st["thresh"], 2**31 - 1))
    k4_us = sum(t for name, t in kernel["by_kernel"].items() if "cg_step_f64" in name)

    def torch_route():
        nonlocal plain
        plain = cg.gated_step(*plain, st["thresh"], 2**31 - 1)

    return {"b1_f64": measure_b1(cg.wop, cg.op, lanes=lanes),
            "k4_f64": {"shape": [lanes, n], "k": k,
                       "bound": cg_step_bound(lanes, n, k, value_bytes=8),
                       "kernel": kernel, "k4_us": k4_us, "plain": _timed(torch_route)}}


def measure_k6(n_space, precision):
    """K6 on plane `n_space` (`precision`) from a settled state: one step
    against the torch route's bits, then each timed on its own copy of the
    state, which advances as it is timed."""
    from dots_socp_torch.ops import ialm_step as k6
    from dots_socp_torch.scripts.common import settled_ialm_state
    from dots_socp_torch.solver import step

    config, data, state, phi = settled_ialm_state(n_space, N_TIME, precision, "cuda")

    def copy():
        return state._replace(**{name: getattr(state, name).clone() for name in k6.OUTPUTS})

    fused, plain = copy(), copy()
    ref = step._after_phi(config, data, state, phi)
    step._after_phi(config, data, fused, phi, fused=True)
    bit_equal = all(torch.equal(getattr(fused, k), getattr(ref, k)) for k in k6.OUTPUTS)
    kernel = _timed(lambda: step._after_phi(config, data, fused, phi, fused=True))
    T, V = state.A.shape
    F, D = data.ops.tri.shape[0], data.ops.inc_table.shape[-1]
    return {"shape": {"T": T, "V": V, "F": F, "D": D}, "work": str(state.A.dtype),
            "phi": str(phi.dtype), "bit_equal": bit_equal,
            "bound": ialm_step_bound(T, V, F, D, state.A.element_size(), phi.element_size()),
            "kernel": kernel,
            "k6_us": sum(t for name, t in kernel["by_kernel"].items() if "ialm_" in name),
            "plain": _timed(lambda: step._after_phi(config, data, plain, phi))}


def _problems(n_space=200, shard_counts=SHARD_COUNTS):
    """(geometry, unsharded problem data, {S: blocked problem data}) of plane
    `n_space` as the main path builds them; no deflation vectors (the tiles
    do not depend on them)."""
    from dots_socp_torch import cli
    from dots_socp_torch.solver.problem import build_problem

    geometry = cli.load_geometry("plane", n_space)
    _, data, _ = build_problem(N_TIME, geometry, dtype="float32", device="cuda", cg_deflation_k=0,
                               laplacian_mode="cg")
    blocked = {}
    for s in shard_counts:
        _, d, _ = build_problem(N_TIME, geometry, dtype="float32", space_partitions=s,
                                mesh_axes=(1, s), cg_deflation_k=0, device="cpu",
                                laplacian_mode="cg")
        blocked[s] = d
    return geometry, data, blocked


def sweep(geometry, data, blocked):
    """The kernels at every tile size of the grid and of the builders' rule,
    and B1 at 128 modes with the tiles the rule picks for them."""
    lap = ell_laplacian(data.cg_op)
    v = lap.shape[0]
    coords = np.asarray(geometry["vertices"])
    coords = coords if coords.shape[0] == v else None
    ones = np.ones(v)

    def b1_operator(**kw):
        tiles = window_spmv.build_window_tiles(lap, coords=coords, **kw)
        op = window_spmv.window_operator(tiles, ones, np.ones((1, v)), ones, np.zeros((v, 0)), "cuda")
        return tiles, op

    out = {"b1_sweep": [], "b2_sweep": []}
    for tv in sorted(set(SWEEP_TILE_ROWS + window_spmv.tile_candidates(v))):
        tiles, op = b1_operator(tile_rows=tv)
        m = measure_b1(op, None, with_plain=False)
        out["b1_sweep"].append({"meta": tiles.meta, "device_us": m["kernel"]["device_us"]})
    tiles, op = b1_operator(n_modes=128)
    out["b1_128_modes"] = {**measure_b1(op, None, lanes=128, with_plain=False), "tiles": tiles.meta}
    for s in SHARD_COUNTS:
        lap_b = ell_laplacian(blocked[s].cg_op)
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
    ap.add_argument("--sweep", action="store_true",
                    help="also time every tile size, and B1 at 128 modes")
    ap.add_argument("--out", default=None, help="write the result to this JSON file")
    ap.add_argument("--n_space", type=int, default=200,
                    help="resolution of the plane mesh (default 200: V=46,431)")
    ap.add_argument("--skip_b2", action="store_true", help="time B1 only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs an NVIDIA GPU")
    if args.sweep and args.skip_b2:
        ap.error("--sweep times B2 too: drop --skip_b2")
    shard_counts = () if args.skip_b2 else SHARD_COUNTS
    geometry, data, blocked = _problems(args.n_space, shard_counts)
    out = {"card": nvidia_smi_line(), "n_space": args.n_space,
           "b1": measure_b1(data.cg_op.window, data.cg_op),
           "b2": [measure_b2(blocked[s].cg_op.swindow, s) for s in shard_counts]}
    out["f64"] = {str(lanes): measure_f64(args.n_space, lanes) for lanes in F64_MODES}
    out["k6"] = {"n64": measure_k6(64, "float32"),
                 f"n{args.n_space}": measure_k6(args.n_space, "float32"),
                 f"n{args.n_space}_f64": measure_k6(args.n_space, "float64")}
    if args.sweep:
        out.update(sweep(geometry, data, blocked))
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(nvidia_smi_line())


if __name__ == "__main__":
    main()
