"""Accuracy replication: solve with the port and compare against the exact
transport at order-of-magnitude KKT checkpoints (counterpart of
`replication/main_versus_exact.py`, the experiment of `make true_error`).

    python -m dots_socp_torch.replication.main_versus_exact --example=plane \
        --n_space=24 --tol=1e-2 --nit=200
"""

import sys
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

from dots_socp_torch import cli  # noqa: E402

# Examples whose settings module defines get_exact_transportation.
EXACT_EXAMPLES = ("plane",)


def parse_args(return_parser=False, argv=None):
    """The package CLI, re-defaulted for the versus-exact experiment."""
    parser = cli.parse_args(return_parser=True)
    parser.set_defaults(outdir="output/undated_versus_exact", versus_exact=True)
    if return_parser:
        return parser
    args = parser.parse_args(argv)
    args.versus_exact = True  # this script IS the versus-exact flow
    if args.example is not None and args.example not in EXACT_EXAMPLES:
        parser.error(
            f"--example must define an exact transport (one of {EXACT_EXAMPLES})"
        )
    return args


def automatic_checkpoints(tol: float):
    """One checkpoint per order of magnitude: [1e-1, 1e-2, ..., down to tol].

    Decades strictly between tol and 1 are included; tol itself is included
    when it sits on a decade (up to float fuzz).
    """
    checkpoints = []
    exponent = 1
    while 10.0 ** (-exponent) >= tol * (1.0 - 1e-9):
        checkpoints.append(10.0 ** (-exponent))
        exponent += 1
    return checkpoints


def main(argv=None):
    """Returns (solution, geometry, run_history, error_transportation,
    error_checkpoints)."""
    args = parse_args(argv=argv)
    if not args.checkpoints:
        args.checkpoints = automatic_checkpoints(args.tol)
    return cli.run(parse_args(return_parser=True), args, solver_name="socp")


if __name__ == "__main__":
    main()
