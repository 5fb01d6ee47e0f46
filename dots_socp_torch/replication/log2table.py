# The port's own copy of replication/log2table.py; only the import path and
# the way it is started differ.
"""Parse replication log files into comparison tables.

Consumes the log blocks emitted by the solver/interface (the same format
the reference's `replication/log2table.py:90-140` parses: the
'Info: Experiment Setting' header, 'Example name:', vertex/triangle counts,
'Transportation cost:', 'Time of steps', 'Total Iteration') and exports
.tex/.html/.csv/.xlsx comparison tables.

Usage: python -m dots_socp_torch.replication.log2table -i info.log \
           -o table.tex table.html
"""

__all__ = ["log2table"]

import re
import sys
import warnings
from argparse import ArgumentParser, RawTextHelpFormatter
from pathlib import Path

import pandas as pd

if not __package__:  # started by its path: the repository root takes this
    # folder's place on sys.path (its modules must not answer to top-level names)
    sys.path[0] = str(Path(__file__).resolve().parents[2])

from dots_socp_torch.utils.tables import export_table  # noqa: E402

# One row per experiment block in the log.
BLOCK_START = re.compile(r".*Info: Experiment Setting.*")
FIELDS = [
    ("Example", re.compile(r"^Example name:\s*(\S+)")),
    ("Vertices", re.compile(r"^Number of vertices:\s*(\d+)")),
    ("Triangles", re.compile(r"^Number of triangles:\s*(\d+)")),
    (
        "Transport Cost",
        re.compile(r"^Transportation cost:\s*([-+]?\d+\.\d+e[-+]?\d+)"),
    ),
    ("Time [seconds]", re.compile(r"^Time of steps\s*:\s*(\d+\.?\d*)\s*sec")),
    (
        "Iterations",
        re.compile(r"^Total Iteration(?:\s*\(l\.l\.\))?\s*:\s*(\d+) iterations"),
    ),
]

# Optional per-run annotation written by replication/sweep.py (here: dots_socp_torch.replication.sweep): "yes" or
# "time-capped". Only present in sweep logs; the column is emitted only
# when at least one block carries it (plain runs keep the reference's
# exact column set).
OPTIONAL_FIELDS = [
    ("Converged", re.compile(r"^Converged:\s*(\S.*)$")),
]


def parse_log(file_path):
    """Collect one record per experiment block; timestamps prefixes (from
    file logging) are stripped before matching."""
    with open(file_path, "r") as f:
        lines = [re.sub(r"^\d{4}-\d{2}-\d{2} [\d:,]+ ", "", ln) for ln in f]

    # Split into blocks.
    starts = [i for i, ln in enumerate(lines) if BLOCK_START.match(ln)]
    records = []
    for idx, start in enumerate(starts):
        end = starts[idx + 1] if idx + 1 < len(starts) else len(lines)
        record = {}
        for name, pattern in FIELDS:
            for ln in lines[start:end]:
                match = pattern.match(ln)
                if match:
                    record[name] = match.group(1)
                    break
        if len(record) == len(FIELDS):
            for name, pattern in OPTIONAL_FIELDS:
                for ln in lines[start:end]:
                    match = pattern.match(ln)
                    if match:
                        record[name] = match.group(1).strip()
                        break
            records.append(record)
        else:
            warnings.warn(
                f"incomplete experiment block at line {start}: "
                f"matched only {sorted(record)}"
            )
    return records


def log2table(file_path, out_tables):
    """Read a replication log and export comparison table(s)."""
    records = parse_log(file_path)
    if not records:
        print(f"Warning: no data found in {file_path}")
        return

    df = pd.DataFrame(records)
    shared = df.groupby("Example")[["Vertices", "Triangles"]].first()
    metric_cols = ["Iterations", "Time [seconds]", "Transport Cost"]
    if "Converged" in df.columns:
        metric_cols.append("Converged")
    metrics = df.groupby("Example")[metric_cols].first()
    metrics["Transport Cost"] = pd.to_numeric(
        metrics["Transport Cost"], errors="coerce"
    ).round(4)

    table = pd.concat([shared, metrics], axis=1).reset_index()
    table["Example"] = table["Example"].str.replace("_", " ").str.title()

    outs = [out_tables] if isinstance(out_tables, str) else list(out_tables)
    for out in outs:
        export_table(table, out)


if __name__ == "__main__":
    parser = ArgumentParser(
        description="Read logging file and output table(s).",
        formatter_class=RawTextHelpFormatter,
    )
    parser.add_argument("-i", "--input", help="Path to logging file")
    parser.add_argument(
        "-o",
        "--output",
        nargs="+",
        required=True,
        help="Output files (.tex/.html/.csv/.xlsx)",
    )
    args = parser.parse_args()
    log2table(file_path=args.input, out_tables=args.output)
