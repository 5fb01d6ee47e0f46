"""Replication entry point: run one benchmark example with the port's DOT
solver (counterpart of `replication/main.py`, which `make main` runs in its
sweep of 14 examples x 3 congestion levels).

    python -m dots_socp_torch.replication.main --example=plane --n_space=24 \
        --ntime=15 --tol=1e-2 --nit=120 --log_file=out/info.log

The flags are the CLI's (`dots_socp_torch.cli`): --device (default cuda),
and --mesh_shape TxS --dist_backend nccl|gloo under torchrun for a
solve sharded over space (and, with T > 1, over time). `dots_socp_torch.replication.log2table` turns the log
into the comparison table.
"""

import sys
from pathlib import Path

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

from dots_socp_torch import cli  # noqa: E402


def main(argv=None):
    parser = cli.parse_args(return_parser=True)
    return cli.run(parser, parser.parse_args(argv), solver_name="socp")


if __name__ == "__main__":
    main()
