"""Demonstration of the usage on the port (counterpart of the repository's
`demo.py`).

Runs the plane example (no mesh data files needed) on --device (default
cuda) with show=False by default in headless environments; pass --show to
open the viewer.

    python -m dots_socp_torch.demo [--device cpu]
"""

import sys
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from dots_socp_torch import cli  # noqa: E402

DEFAULT_EXAMPLE = "plane"
DEFAULT_TOL = 1e-3
DEFAULT_ITERATIONS = 1000


def parse_args(return_parser=False, argv=None):
    parser = cli.parse_args(return_parser=True)
    parser.set_defaults(
        example=DEFAULT_EXAMPLE,
        tol=DEFAULT_TOL,
        nit=DEFAULT_ITERATIONS,
        n_space=50,
    )
    return parser if return_parser else parser.parse_args(argv)


def main(argv=None):
    return cli.run(parse_args(return_parser=True), parse_args(argv=argv), solver_name="socp")


if __name__ == "__main__":
    main()
