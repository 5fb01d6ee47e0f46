"""The fixed cost of one refined phi solve at large V, piece by piece
(counterpart of the repository's `scripts/refine_cost_bench.py`).

    python -m dots_socp_torch.scripts.refine_cost_bench --n_space 410 \
        --ntime 31 [--chain 20] [--device cpu]

Each piece runs as a chain of --chain dependent applications (each output
scaled to unit norm, summed in float64, before the next), timed by the host
clock around a window closed by a device synchronisation, best of 3 after
one untimed chain, per application:

  matvec_hi_f64  the refinement's float64 true-residual matvec (ELL gather
                 with the shifts), once per refinement pass
  u64_transform  the float64 time-eigenbasis transforms, per solve
  deflate64      the float64 projection of the singular row
  window_f32     one float32 inner matvec: kernel B1 on the card
  ell_f32        one float32 ELL gather matvec (the B1-less inner matvec)

The JAX script's `matvec_df` (a double-float ELL matvec) has no
counterpart: the card has native FP64 and the port has no double-float
module, so the key is left out, as the JAX script leaves it out when its
module is missing. On the card `device_event_ms` adds each chain's
CUDA-event time per application. The CG path is forced so that a small
--n_space takes it too (at the default the automatic choice is the same).
One JSON line last.
"""

import argparse
import sys
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])


def main(argv=None):
    from dots_socp_torch.scripts.common import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_space", type=int, default=410)
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--chain", type=int, default=20)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from dots_socp_torch.ops.laplacian import ell_matvec
    from dots_socp_torch.ops.window_spmv import window_matvec
    from dots_socp_torch.scripts.common import (
        device_fields, event_ms, normalized, plane_problem, print_result, timed)

    device = args.device
    config, data, _ = plane_problem(args.n_space, args.ntime, "float32", device,
                                    laplacian_mode="cg")
    op = data.cg_op
    if op.ell_w_hi is None:
        raise RuntimeError("the problem built no refinement leaves")
    f64 = torch.float64
    rhs = torch.ones((args.ntime + 1, config.n_vertices), dtype=torch.float32,
                     device=op.ell_w.device)
    x64 = rhs.to(f64) * 0.5

    def chain(body, x):
        for _ in range(args.chain):
            x = normalized(body(x))
        return x

    results, events = {}, {}

    def time_piece(name, body, x):
        chain(body, x)
        best = min(timed(lambda: chain(body, x), device)[1] for _ in range(3))
        results[f"{name}_ms"] = best / args.chain * 1e3
        ms = event_ms(lambda: chain(body, x), device)
        events[name] = None if ms is None else ms / args.chain
        print(f"  {name:13s}: {results[f'{name}_ms']:8.3f} ms/apply", flush=True)

    def mv_hi(x):
        lap = ell_matvec(op, x, weights=op.ell_w_hi)
        return -(lap + op.shifts_hi[:, None] * op.av_hi[None, :] * x)

    time_piece("matvec_hi_f64", mv_hi, x64)
    ut = op.u_time_hi
    time_piece("u64_transform", lambda x: ut @ (ut.T @ x), x64)
    null64, real64 = op.null_row.to(f64), op.real_mask.to(f64)
    n_real = real64.sum()

    def defl(x):
        mean = (x * real64[None, :]).sum(dim=1, keepdim=True) / n_real
        x = x - null64[:, None] * mean
        return torch.where(null64[:, None] > 0, x * real64[None, :], x)

    time_piece("deflate64", defl, x64)
    chained_matvecs = 0
    wop = op.window
    if wop is not None:
        def b1(y):
            nonlocal chained_matvecs
            chained_matvecs += 1
            return window_matvec(wop, y)

        time_piece("window_f32", b1, rhs[:, wop.perm].contiguous())
    time_piece("ell_f32", lambda x: ell_matvec(op, x), rhs)
    return print_result({
        "metric": f"refine fixed-cost decomposition (plane n{args.n_space}, "
                  f"V={config.n_vertices_real}, T={args.ntime})",
        **results,
        "device_event_ms": events if events["deflate64"] is not None else None,
        "n_vertices": config.n_vertices_real,
        "chain": args.chain,
        "chained_matvecs": chained_matvecs,
        **device_fields(device),
    })


if __name__ == "__main__":
    main()
