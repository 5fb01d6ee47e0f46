"""The float32 error of the dense spectral phi solve, on the card and on the
host, each held against the float64 solve of the same right-hand sides.

    python -m dots_socp_torch.scripts.spectral_floor [--examples knots_3 hills] \
        [--n_space N] [--ntime 31] [--pad_multiple 4096] [--rhs 4] [--seed 0] \
        [--device cpu]

For each example the mesh is loaded, normalised and padded as the sweep
(`replication.sweep --pad_multiple 4096`) hands it to the solver. Its
eigenpairs are taken once in float64 on the host (`spectral_eigenpairs`),
and one factor is cast to each of (float32, --device), (float32, cpu) and
(float64, --device), as `build_spectral_factor` casts it. `spectral_solve`
then runs on right-hand sides of shape (T+1, V) of two kinds, --rhs of
each: `gaussian` (seeded standard normal) and `smooth` (the float64 solve of
a gaussian one, scaled to unit norm: as smooth as phi itself). Each answer
z is held against the host's float64 answer z64, and the largest over the
right-hand sides of a kind is printed:

  rel_l2      ||z - z64|| / ||z64||
  rel_energy  the same in the pencil's eigen-coefficients weighted by
              |lam_t - w| (an energy norm: it weighs the fine modes that
              the gradients of the KKT residuals see)

`repeat_equal` says whether a second float32 solve on --device gave the
same bits. One JSON line per example, then a summary line.
"""

import argparse
import sys
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])


def padded_pencil(example, n_space, pad_multiple):
    """(av, L, n_vertices): the vertex areas and cotan Laplacian of
    `example` over the padded vertex range, as `build_problem` makes them
    (dummy vertices carry the mean area and empty Laplacian rows)."""
    import numpy as np

    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.geometry.surface import cotan_laplacian, triangle_quantities, vertex_areas

    geometry = load_geometry(example, n_space)
    vertices = np.asarray(geometry["vertices"], dtype=np.float64)
    triangles = np.asarray(geometry["triangles"])
    n = vertices.shape[0]
    v_pad = -(-n // pad_multiple) * pad_multiple
    area_f, angles, _ = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, n) / 3.0
    av = np.concatenate([av, np.full(v_pad - n, av.mean())])
    return av, cotan_laplacian(triangles, angles, v_pad), n


def main(argv=None):
    from dots_socp_torch.scripts.common import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--examples", nargs="+", default=["knots_3", "hills"])
    ap.add_argument("--n_space", type=int, default=None,
                    help="resolution of a generated example (plane); default its own")
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--pad_multiple", type=int, default=4096)
    ap.add_argument("--rhs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dots_socp_torch.ops import resolve_device
    from dots_socp_torch.ops.laplacian import (
        spectral_eigenpairs, spectral_factor_from_eigh, spectral_solve)
    from dots_socp_torch.scripts.common import device_fields, print_result

    device = resolve_device(args.device)
    f32, f64 = torch.float32, torch.float64
    rows = []
    for example in args.examples:
        av, lap, n_vertices = padded_pencil(example, args.n_space, args.pad_multiple)
        pairs = spectral_eigenpairs(args.ntime, 1.0 / args.ntime, av, lap, f64)
        lam_t, u_time, s, w, q = pairs
        u64 = torch.as_tensor(u_time, dtype=f64)
        s64 = torch.as_tensor(s, dtype=f64)
        q64 = torch.as_tensor(q, dtype=f64)
        weight = (torch.as_tensor(lam_t)[:, None] - torch.as_tensor(w)[None, :]).abs()

        def energy(z):
            coef = ((u64.T @ z) / s64[None, :]) @ q64
            return torch.sqrt((coef * coef * weight).sum())

        factors = {
            "f32_device": spectral_factor_from_eigh(*pairs, dtype=f32, device=device),
            "f32_cpu": spectral_factor_from_eigh(*pairs, dtype=f32, device="cpu"),
            "f64_device": spectral_factor_from_eigh(*pairs, dtype=f64, device=device),
        }
        host64 = spectral_factor_from_eigh(*pairs, dtype=f64, device="cpu")
        gen = np.random.default_rng(args.seed)
        rel_l2 = {kind: dict.fromkeys(factors, 0.0) for kind in ("gaussian", "smooth")}
        rel_energy = {kind: dict.fromkeys(factors, 0.0) for kind in ("gaussian", "smooth")}
        repeat_equal = True
        for _ in range(args.rhs):
            g = torch.as_tensor(gen.standard_normal((args.ntime + 1, lap.shape[0])))
            smooth = spectral_solve(host64, g)
            for kind, rhs in (("gaussian", g), ("smooth", smooth / smooth.norm())):
                z64 = spectral_solve(host64, rhs)
                for name, factor in factors.items():
                    z = spectral_solve(factor, rhs.to(factor.q.dtype).to(factor.q.device))
                    if name == "f32_device":
                        again = spectral_solve(factor, rhs.to(f32).to(device))
                        repeat_equal &= bool(torch.equal(z, again))
                    err = z.cpu().to(f64) - z64
                    rel_l2[kind][name] = max(rel_l2[kind][name], float(err.norm() / z64.norm()))
                    rel_energy[kind][name] = max(
                        rel_energy[kind][name], float(energy(err) / energy(z64)))
        row = {
            "example": example, "vertices": n_vertices, "v_pad": int(lap.shape[0]),
            "n_time": args.ntime, "rhs": args.rhs, "seed": args.seed,
            "rel_l2": rel_l2, "rel_energy": rel_energy, "repeat_equal": repeat_equal,
            "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            **device_fields(device),
        }
        rows.append(print_result(row))
    return print_result({
        "examples": args.examples,
        "device_over_cpu_f32": {
            r["example"]: {kind: errs["f32_device"] / errs["f32_cpu"]
                           for kind, errs in r["rel_l2"].items()}
            for r in rows
        },
        **device_fields(device),
    })


if __name__ == "__main__":
    main()
