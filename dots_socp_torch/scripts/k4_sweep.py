"""Kernel K4's walk split on the card: for each state shape, every split
plan (`ops.cg_step.split_plan`'s lane rows per block, load depth and hand-over) timed
stage by stage and per call, each checked bit for bit against the plain
version on the same seeded random state, beside each stage's byte bound.

    python -m dots_socp_torch.scripts.k4_sweep [--shapes 32x46431 ...] [--plans default]

The shapes default to the main path's: plane n200 at 32 and 128 modes, n290
and n410 (32 modes). `--plans default` times only the plan the kernel picks
by itself. The script imports only `dots_socp_torch.ops.cg_step` and
`dots_socp_torch.kernel_timing` of the package, so a checkout of another
commit can be timed with it (`PYTHONPATH=<checkout> python
dots_socp_torch/scripts/k4_sweep.py --plans default`: a package without
`split_plan` is timed at its one plan). Ends in one JSON line: per shape the
bound, the default plan and every plan's µs by stage and per call.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from dots_socp_torch import kernel_timing
from dots_socp_torch.ops import cg_step

SHAPES = ((32, 46_431), (128, 46_431), (32, 97_485), (32, 194_814))
DEFLATION_K = 181  # plane n200's deflation rank
TRACE_KEYS = ("den", "alpha", "step", "x", "r1", "r", "sr", "z", "rr", "rz", "beta", "p")


def random_cg_state(rows, n, device, k=DEFLATION_K, seed=0):
    """(lap, state, thresh, leaves): a seeded random K4 input of shape
    (rows, n) on `device`, float32: the last row null, three padding
    vertices, every row active, deflation rank `k`."""
    gen = torch.Generator(device=device).manual_seed(seed + rows + n)

    def rand(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    q = rand(n, k)
    real = torch.ones(n, device=device)
    real[-3:] = 0.0
    null = torch.zeros(rows, device=device)
    null[-1] = 1.0
    leaves = cg_step.CGStepLeaves(
        shifts=-rand(rows).abs(), av=rand(n).abs() + 0.1, jacobi=rand(rows, n).abs(),
        s=rand(n).abs() + 0.1, real=real, null=null, n_real=real.sum(), defl_q=q,
        defl_qt=q.t().contiguous(), defl_winv=rand(rows, k))
    state = (rand(rows, n), rand(rows, n), rand(rows, n), rand(rows, 1).abs(),
             rand(rows, 1).abs() + 1.0, torch.zeros((), dtype=torch.int64, device=device),
             torch.ones((), dtype=torch.bool, device=device))
    thresh = torch.full((rows, 1), 1e-3, device=device)
    return rand(rows, n), state, thresh, leaves


def stage_bounds_us(rows, n, null_rows=1):
    """Each launch's least time on the card (µs; each array it must read or
    write moved once, at HBM_BYTES_PER_S), keyed by `cg_step.STAGE_NAMES`:
    den reads p and lap; the update reads p, lap, x and r and writes x, r
    and s r; the null rows' stage reads their mean terms and r and writes r
    and s r; the preconditioner reads r, the Jacobi rows and G and writes
    z; the direction reads z and p and writes p (vertex vectors aside)."""
    arrays = {"den": 2 * rows, "update": 7 * rows, "null_rows": 4 * null_rows,
              "precond": 4 * rows, "direction": 3 * rows}
    return {name: a * n * 4 / kernel_timing.HBM_BYTES_PER_S * 1e6 for name, a in arrays.items()}


def plans(rows, n, default_only=False):
    """[(lanes, depth, cluster)] to time: Nones for the kernel's own
    choice, then every split `split_plan` accepts for this shape (a cluster
    hand-over only where the lane rows of a row span blocks)."""
    out = [(None, None, None)]
    if default_only or not hasattr(cg_step, "split_plan"):
        return out
    red = cg_step.row_sum_config(rows, n)
    for cluster in (False, True):
        for depth in sorted(cg_step.WALK_THREADS):
            lanes = 1
            while lanes <= red[1]:
                try:
                    plan = cg_step.split_plan(red, rows, lanes=lanes, depth=depth,
                                              cluster=cluster)
                    if plan.cluster == cluster:
                        out.append((lanes, depth, cluster))
                except ValueError:
                    pass
                lanes *= 2
    return out


def _plan_ctx(lanes, depth, cluster):
    if lanes is None and depth is None and cluster is None:
        return contextlib.nullcontext()
    return cg_step.walk_plan(lanes, depth, cluster)


def time_plan(inputs, lanes=None, depth=None, cluster=None, reps=kernel_timing.REPS, call=True):
    """One plan on one input: bit-equality of every stage's outputs to the
    plain version's, µs per launch in launch order (over `reps` calls), and
    µs per call of K4's launches and (`call`) of the whole call with its
    GEMMs."""
    lap, state, thresh, leaves = inputs
    with _plan_ctx(lanes, depth, cluster):
        trace_k, trace_p = {}, {}
        cg_step.cg_step(lap, *(t.clone() for t in state), thresh, 600, leaves, trace=trace_k)
        cg_step.cg_step_plain(lap, *(t.clone() for t in state), thresh, 600, leaves,
                              trace=trace_p)
        torch.cuda.synchronize()
        null = leaves.null > 0
        bits = all(torch.equal(trace_k[key], trace_p[key]) for key in TRACE_KEYS)
        bits = bits and torch.equal(trace_k["mean"][null], trace_p["mean"][null])
        run = tuple(t.clone() for t in state)
        by_stage = kernel_timing.launch_times_us(
            lambda: cg_step.cg_step(lap, *run, thresh, 2**31 - 1, leaves), "cg_step_",
            cg_step.STAGES, reps=reps)
        call_ms = None
        if call:
            call_ms, _, _ = kernel_timing.device_ms(
                lambda: cg_step.cg_step(lap, *run, thresh, 2**31 - 1, leaves), reps)
    return {"bit_equal": bool(bits), "us_by_stage": by_stage,
            "us": None if by_stage is None else sum(by_stage),
            "call_us": None if call_ms is None else call_ms * 1e3}


def default_plan(rows, n):
    """(lanes, depth, cluster, blocks, threads) the kernel takes by itself, or None
    (a package without `split_plan`)."""
    if not hasattr(cg_step, "split_plan"):
        return None
    sms, threads_per_sm = cg_step._card(torch.device("cuda"))
    red = cg_step.row_sum_config(rows, n, sms, threads_per_sm)
    p = cg_step.split_plan(red, rows, sms)
    return {"lanes": p.lanes, "depth": p.depth, "cluster": p.cluster, "blocks": p.blocks,
            "threads": p.threads}


def sweep(shapes=SHAPES, default_only=False):
    out = []
    for rows, n in shapes:
        inputs = random_cg_state(rows, n, "cuda")
        bound = kernel_timing.cg_step_bound(rows, n, DEFLATION_K)
        stage_names = getattr(cg_step, "STAGE_NAMES", None)
        entry = {"shape": [rows, n], "geometry": list(cg_step.row_sum_config(rows, n)),
                 "bound_us": bound["ms"] * 1e3, "stage_bound_us": stage_bounds_us(rows, n),
                 "stages": list(stage_names) if stage_names else cg_step.STAGES,
                 "default": default_plan(rows, n), "plans": []}
        for lanes, depth, cluster in plans(rows, n, default_only):
            entry["plans"].append({"lanes": lanes, "depth": depth, "cluster": cluster,
                                   **time_plan(inputs, lanes, depth, cluster)})
        out.append(entry)
        del inputs
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="*", default=[f"{r}x{n}" for r, n in SHAPES],
                    help="state shapes ROWSxN (default: the main path's four)")
    ap.add_argument("--plans", choices=("all", "default"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k4_sweep times the kernel on the card: CUDA is not available")
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes]
    result = sweep(shapes, args.plans == "default")
    print(json.dumps({"k4_sweep": result, "card": kernel_timing.nvidia_smi_line(),
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
