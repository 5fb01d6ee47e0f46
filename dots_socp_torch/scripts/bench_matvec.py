"""Race the Laplacian matvecs of the port on one input (counterpart of the
repository's `scripts/bench_matvec.py`).

    python -m dots_socp_torch.scripts.bench_matvec --n_space 200 --n_time 31 \
        [--iters 50] [--dtype float32] [--tile_rows 0] [--skip a,b] [--device cpu]

Variants, each computing L_space @ x for one seeded x of shape (T+1, V) on
the generated plane mesh (not normalised, as in the JAX script):

  graddiv -- matrix-free div(area * grad x) through the triangle incidence
             (`ops/mesh_ops.py::laplacian_apply`)
  ell     -- the padded-ELL neighbour gather (`ops/laplacian.py::ell_matvec`)
  window  -- kernel B1 on the card (its plain version on the CPU), in the
             permuted vertex order the CG runs in: x is permuted once per
             chain and the result back once, as `cg_solve` amortises it
  library -- torch.sparse.mm of the same operator as CSR, vertex-major x
             (in place of the JAX script's `banded`, which the port does not
             have; `--skip banded` is accepted and changes nothing)

`variants` is the time of one matvec in µs: on the card the device time of
its kernels per call over --iters calls (torch.profiler,
`kernel_timing.device_ms`); on the CPU the host clock over a chain of
--iters dependent applications (each output scaled to unit norm before the
next), closed by a synchronisation, per application. `chain_us` is that
chain's host time on either device. The window and library variants run in
float32 (the kernel's only dtype) whatever --dtype is. `max_disagreement`
is the largest |y - y_graddiv| over the variants, one application each.
`group` is 1 and `super_width` null: the port's tiles have a window each,
no super-windows. One JSON line last.
"""

import argparse
import sys
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

def build(n_space, n_time, dtype, tile_rows, device):
    """(variants, x0, window operator): {name: (matvec, pre, post, x dtype)}
    on the plane n_space mesh and the seeded x0 (rng 0, (T+1, V))."""
    import numpy as np
    import torch

    from dots_socp_torch.geometry.generators import generate_plane_mesh
    from dots_socp_torch.geometry.surface import cotan_laplacian, triangle_quantities
    from dots_socp_torch.kernel_timing import operator_csr
    from dots_socp_torch.ops import resolve_device
    from dots_socp_torch.ops.laplacian import build_cg_operator, ell_matvec
    from dots_socp_torch.ops.mesh_ops import build_surface_ops, laplacian_apply

    device = resolve_device(device)
    tdtype = torch.float64 if dtype == "float64" else torch.float32
    vertices, triangles, _ = generate_plane_mesh(n=n_space)
    v = vertices.shape[0]
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, v)
    ops = build_surface_ops(vertices, triangles, dtype=tdtype, device=device)
    cg_op = build_cg_operator(
        n_time, 1.0 / n_time, ops.av.cpu().numpy(), lap, dtype=tdtype, deflation_k=0,
        spmv_tile_rows=tile_rows or None, coords=vertices, refine=tdtype == torch.float64,
        device=device)
    wop = cg_op.window
    x0 = torch.as_tensor(np.random.default_rng(0).standard_normal((n_time + 1, v)),
                         dtype=tdtype, device=device)
    identity = lambda y: y
    variants = {
        "graddiv": (lambda y: laplacian_apply(ops, y), identity, identity, tdtype),
        "ell": (lambda y: ell_matvec(cg_op, y), identity, identity, tdtype),
    }
    if wop is not None:
        csr = operator_csr(wop, v, v)
        variants["window"] = (lambda y: b1(wop, y), lambda y: y[:, wop.perm],
                              lambda y: y[:, wop.iperm], torch.float32)
        variants["library"] = (lambda y: torch.sparse.mm(csr, y.t().contiguous()).t(),
                               lambda y: y[:, wop.perm], lambda y: y[:, wop.iperm],
                               torch.float32)
    return variants, x0, wop


def b1(wop, y):
    """Kernel B1 (its plain version on the CPU), counted in `b1.calls`."""
    from dots_socp_torch.ops.window_spmv import window_matvec

    b1.calls += 1
    return window_matvec(wop, y)


b1.calls = 0


def apply_once(variants, x0, skip=()):
    """{name: one application of each variant to x0, in natural vertex
    order, as float64 numpy}."""
    return {name: post(mv(pre(x0.to(xdtype)).contiguous())).double().cpu().numpy()
            for name, (mv, pre, post, xdtype) in variants.items() if name not in skip}


def main(argv=None):
    from dots_socp_torch.scripts.common import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_space", type=int, default=200)
    ap.add_argument("--n_time", type=int, default=31)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--tile_rows", type=int, default=0,
                    help="window tile rows; 0 = the choice of build_window_tiles")
    ap.add_argument("--skip", default="", help="comma-separated variants")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from dots_socp_torch.kernel_timing import device_ms, library_ms
    from dots_socp_torch.scripts.common import (
        device_fields, normalized, on_card, print_result, timed)

    skip = set(filter(None, args.skip.split(",")))
    variants, x0, wop = build(args.n_space, args.n_time, args.dtype, args.tile_rows, args.device)
    calls_before = b1.calls
    results, chain_us = {}, {}
    for name, (mv, pre, post, xdtype) in variants.items():
        if name in skip:
            continue
        x = pre(x0.to(xdtype)).contiguous()

        def chain():
            y = x
            for _ in range(args.iters):
                y = normalized(mv(y))
            return post(y)

        chain()
        chain_us[name] = timed(chain, args.device)[1] / args.iters * 1e6
        if on_card(args.device) and name == "library":
            # torch.sparse.mm alone, on the vertex-major x it takes
            results[name] = library_ms(wop, x, x.shape[-1])[0] * 1e3
        elif on_card(args.device):
            results[name] = device_ms(lambda: mv(x), args.iters)[0] * 1e3
        else:
            results[name] = chain_us[name]
    outs = apply_once(variants, x0, skip)
    ref = outs["graddiv"] if "graddiv" in outs else next(iter(outs.values()))
    agree = max((float(np.abs(o - ref).max()) for o in outs.values()), default=0.0)
    return print_result({
        "metric": f"Laplacian SpMV time (V={x0.shape[-1]}, T={args.n_time}, {args.dtype}, "
                  f"{'device time per call' if on_card(args.device) else 'host clock'})",
        "unit": "us/matvec",
        "variants": results,
        "chain_us": chain_us,
        "max_disagreement": agree,
        "max_abs_y": float(np.abs(ref).max()),
        "window_width": wop.width if wop is not None else None,
        "tile_rows": wop.tile_rows if wop is not None else args.tile_rows,
        "group": 1 if wop is not None else None,
        "super_width": None,
        "chained_matvecs": b1.calls - calls_before,
        **device_fields(args.device),
    })


if __name__ == "__main__":
    main()
