"""The float32 error of the dense spectral phi solve, on the card and on the
host, each held against the float64 solve of the same right-hand sides;
and the `make main` sweep's rows with the solve's two long products
computed other ways.

    python -m dots_socp_torch.scripts.spectral_floor [--examples knots_3 hills] \
        [--n_space N] [--ntime 31] [--pad_multiple 4096] [--rhs 4] [--seed 0] \
        [--variants long block_128 block_512 block_1024 f64] \
        [--rows knots_3@0.00 hills@0.00 ...] [--row_variants long solver f64] \
        [--outdir output/spectral_floor] [--device cpu]

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
same bits. Under `variants` the two float32 factors solve again with the
two long (V, V) x (V, T+1) products of `spectral_solve` (`blocked_matmul`)
replaced, each on --device and on the host:

  solver    as the solver computes them (chains of `chain_length(K)`, at
            most SPECTRAL_BLOCK_K)
  long      one library GEMM over all of K each, as the port computed
            them before the chains
  block_N   summed in chains of N
  f64       in float64 (the float32 operands cast up, the product cast
            back down), everything else float32

`device_over_cpu` is the device's error over the host's under the same
variant. `solve_us` is the time of one float32 solve on --device under the
solver and each variant: the host clock around TIMED_CALLS calls closed by
a synchronisation (what the iteration pays, host dispatch included), taken
TIMED_ROUNDS times, the variants in turns within each round. One JSON line
per example; the summary adds, where `long` ran,
`energy_device_over_host_blas`: the device's solver error over the host's
`long` one (the host BLAS over all of K, what the port's CPU runs had
before the chains), in the energy norm. Each --rows entry
(EXAMPLE@CONGESTION, a row of `scripts.records` R1: the sweep's flags, tol
1e-4) then runs the public solve once under each --row_variants, all in one
fresh factor cache, and prints the records driver's verdict on it. A
summary line ends the run.
"""

import argparse
import contextlib
import functools
import sys
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

KINDS = ("gaussian", "smooth")
TIMED_CALLS, TIMED_ROUNDS = 50, 3


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


def _f64_matmul(a, b):
    return (a.double() @ b.double()).to(a.dtype)


def _long_matmul(a, b):
    """a @ b as the port computed it before the chains: one library GEMM
    over all of K of the (T+1, V) operand by the (V, V) factor."""
    return (b.T.contiguous() @ a.T).T


def variant_product(name):
    """The product that stands in for `laplacian.blocked_matmul` under the
    variant `name`."""
    from dots_socp_torch.ops import laplacian

    if name == "solver":
        return laplacian.blocked_matmul
    if name == "long":
        return _long_matmul
    if name == "f64":
        return _f64_matmul
    if name.startswith("block_") and name[6:].isdigit() and int(name[6:]) > 0:
        return functools.partial(laplacian.blocked_matmul, block=int(name[6:]))
    raise ValueError(f"unknown variant {name!r}: solver, long, block_N or f64")


@contextlib.contextmanager
def product(name):
    """`spectral_solve` computes its two long products as the variant
    `name` does, inside the block (it looks `blocked_matmul` up in its
    module at each call)."""
    from dots_socp_torch.ops import laplacian

    original = laplacian.blocked_matmul
    laplacian.blocked_matmul = variant_product(name)
    try:
        yield
    finally:
        laplacian.blocked_matmul = original


def energy_norm(pairs):
    """The energy norm of a (T+1, V) array under the pencil's host float64
    eigenpairs (lam_t, u_time, s, w, q): its eigen-coefficients weighted by
    |lam_t - w|."""
    import torch

    lam_t, u_time, s, w, q = (torch.as_tensor(a, dtype=torch.float64) for a in pairs)
    weight = (lam_t[:, None] - w[None, :]).abs()

    def energy(z):
        coef = ((u_time.T @ z) / s[None, :]) @ q
        return torch.sqrt((coef * coef * weight).sum())

    return energy


def floors(example, args, device):
    """The JSON row of one example: the solve's float32 errors, and those
    of each variant, on the device and on the host."""
    import numpy as np
    import torch

    from dots_socp_torch.ops.laplacian import (
        spectral_eigenpairs, spectral_factor_from_eigh, spectral_solve)
    from dots_socp_torch.scripts.common import device_fields, timed

    f32, f64 = torch.float32, torch.float64
    av, lap, n_vertices = padded_pencil(example, args.n_space, args.pad_multiple)
    pairs = spectral_eigenpairs(args.ntime, 1.0 / args.ntime, av, lap, f64)
    energy = energy_norm(pairs)
    factors = {
        "f32_device": spectral_factor_from_eigh(*pairs, dtype=f32, device=device),
        "f32_cpu": spectral_factor_from_eigh(*pairs, dtype=f32, device="cpu"),
        "f64_device": spectral_factor_from_eigh(*pairs, dtype=f64, device=device),
    }
    host64 = spectral_factor_from_eigh(*pairs, dtype=f64, device="cpu")
    gen = np.random.default_rng(args.seed)
    rel_l2 = {kind: dict.fromkeys(factors, 0.0) for kind in KINDS}
    rel_energy = {kind: dict.fromkeys(factors, 0.0) for kind in KINDS}
    by_variant = {v: {norm: {kind: {"device": 0.0, "cpu": 0.0} for kind in KINDS}
                      for norm in ("rel_l2", "rel_energy")} for v in args.variants}
    repeat_equal = True

    def errors(factor, rhs, z64):
        z = spectral_solve(factor, rhs.to(factor.q.dtype).to(factor.q.device))
        err = z.cpu().to(f64) - z64
        return float(err.norm() / z64.norm()), float(energy(err) / energy(z64)), z

    for _ in range(args.rhs):
        g = torch.as_tensor(gen.standard_normal((args.ntime + 1, lap.shape[0])))
        smooth = spectral_solve(host64, g)
        for kind, rhs in (("gaussian", g), ("smooth", smooth / smooth.norm())):
            z64 = spectral_solve(host64, rhs)
            for name, factor in factors.items():
                l2, en, z = errors(factor, rhs, z64)
                if name == "f32_device":
                    again = spectral_solve(factor, rhs.to(f32).to(device))
                    repeat_equal &= bool(torch.equal(z, again))
                rel_l2[kind][name] = max(rel_l2[kind][name], l2)
                rel_energy[kind][name] = max(rel_energy[kind][name], en)
            for variant, errs in by_variant.items():
                with product(variant):
                    for where in ("device", "cpu"):
                        l2, en, _ = errors(factors[f"f32_{where}"], rhs, z64)
                        errs["rel_l2"][kind][where] = max(errs["rel_l2"][kind][where], l2)
                        errs["rel_energy"][kind][where] = max(
                            errs["rel_energy"][kind][where], en)
    for errs in by_variant.values():
        for norm in errs.values():
            for e in norm.values():
                e["device_over_cpu"] = e["device"] / e["cpu"]

    def solve_us(rhs):
        rhs = rhs.to(f32).to(device)
        spectral_solve(factors["f32_device"], rhs)
        _, seconds = timed(lambda: [spectral_solve(factors["f32_device"], rhs)
                                    for _ in range(TIMED_CALLS)], device)
        return seconds / TIMED_CALLS * 1e6

    timings = {variant: [] for variant in ("solver", *by_variant)}
    for _ in range(TIMED_ROUNDS):
        for variant, times in timings.items():
            with product(variant):
                times.append(solve_us(g))
    return {
        "example": example, "vertices": n_vertices, "v_pad": int(lap.shape[0]),
        "n_time": args.ntime, "rhs": args.rhs, "seed": args.seed,
        "rel_l2": rel_l2, "rel_energy": rel_energy, "variants": by_variant,
        "solve_us": timings, "repeat_equal": repeat_equal,
        "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        **device_fields(device),
    }


def rows_under_variants(args, device):
    """One records-driver line per (row, variant), every run in one fresh
    factor cache (a mesh's host eigh is taken once)."""
    from dots_socp_torch.bench import fresh_cache_dir
    from dots_socp_torch.scripts import records
    from dots_socp_torch.scripts.common import device_fields, print_result

    record = records.RECORDS["R1"]
    reference = record.reference()
    lines = []
    with fresh_cache_dir():
        for row in args.rows:
            example, _, congestion = row.partition("@")
            if (example, congestion) not in reference:
                raise ValueError(f"--rows: {row} is not a row of R1")
            for variant in args.row_variants:
                run = argparse.Namespace(
                    examples=[example], congestions=[congestion], device=str(device),
                    outdir=str(Path(args.outdir) / variant))
                with product(variant):
                    (port,) = record.run(run, record).values()
                jax = reference[(example, congestion)]
                checks = records.compare(port, jax)
                lines.append(print_result({
                    "record": "R1", "row": row, "variant": variant, "tol": record.tol,
                    "port": port, "jax": jax, "checks": checks, "agrees": all(checks.values()),
                    **device_fields(device),
                }))
    return lines


def main(argv=None):
    from dots_socp_torch.scripts.common import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--examples", nargs="*", default=["knots_3", "hills"])
    ap.add_argument("--n_space", type=int, default=None,
                    help="resolution of a generated example (plane); default its own")
    ap.add_argument("--ntime", type=int, default=31)
    ap.add_argument("--pad_multiple", type=int, default=4096)
    ap.add_argument("--rhs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", nargs="*",
                    default=["long", "block_128", "block_512", "block_1024", "f64"],
                    help="products held against float64 beside the solver's")
    ap.add_argument("--rows", nargs="*", default=[],
                    help="R1 rows (EXAMPLE@CONGESTION, e.g. knots_3@0.00) to solve")
    ap.add_argument("--row_variants", nargs="+", default=["long", "solver", "f64"])
    ap.add_argument("--outdir", default="output/spectral_floor",
                    help="the rows' logs and tables, one folder per variant")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    for name in {*args.variants, *args.row_variants}:
        try:
            variant_product(name)
        except ValueError as err:
            ap.error(str(err))

    from dots_socp_torch.ops import resolve_device
    from dots_socp_torch.ops.laplacian import SPECTRAL_BLOCK_K
    from dots_socp_torch.scripts.common import device_fields, print_result

    device = resolve_device(args.device)
    examples = [print_result(floors(example, args, device)) for example in args.examples]
    lines = rows_under_variants(args, device) if args.rows else []

    def ratio(errs):
        return {kind: errs[kind]["f32_device"] / errs[kind]["f32_cpu"] for kind in KINDS}

    rows = {}
    for ln in lines:
        rows.setdefault(ln["row"], {})[ln["variant"]] = {
            k: ln["port"][k] for k in ("iterations", "converged", "kkt_max")}
        rows[ln["row"]][ln["variant"]]["agrees"] = ln["agrees"]
    return print_result({
        "examples": args.examples,
        "block_k": SPECTRAL_BLOCK_K,
        "device_over_cpu_f32": {r["example"]: ratio(r["rel_l2"]) for r in examples},
        "energy_device_over_cpu_f32": {r["example"]: ratio(r["rel_energy"]) for r in examples},
        "energy_device_over_host_blas": {
            r["example"]: {kind: r["rel_energy"][kind]["f32_device"]
                           / r["variants"]["long"]["rel_energy"][kind]["cpu"] for kind in KINDS}
            for r in examples if "long" in r["variants"]},
        "variants_energy_device_over_cpu": {
            r["example"]: {v: {kind: errs["rel_energy"][kind]["device_over_cpu"] for kind in KINDS}
                           for v, errs in r["variants"].items()}
            for r in examples},
        "solve_us": {r["example"]: r["solve_us"] for r in examples},
        "rows": rows,
        **device_fields(device),
    })


if __name__ == "__main__":
    main()
