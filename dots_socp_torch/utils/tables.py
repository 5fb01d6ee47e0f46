# The port's own copy of dots_socp_tpu/utils/tables.py; only the import paths differ.
"""Table export: checkpoint-error tables to .tex/.html/.csv/.xlsx.

The *output contract* matches reference `utils/file_process.py:6-77` — same
column labels, order and cell formats, so replication tables are directly
comparable. Structure here is a declarative column spec driving a single
writer-dispatch table.
"""

from __future__ import annotations

from pathlib import Path

from pandas import DataFrame

# (header label, checkpoint accessor, cell formatter) — row order below is
# the exported column order.
_COLUMNS = (
    ("L1", lambda cp: cp["error"]["l1"], "{:.2e}".format),
    ("L2", lambda cp: cp["error"]["l2"], "{:.2e}".format),
    ("L-Inf", lambda cp: cp["error"]["linf"], "{:.2e}".format),
    ("KKT", lambda cp: cp["kkt_error"], "{:.2e}".format),
    ("Iteration", lambda cp: cp["iteration"], lambda v: v),
    ("Time (s)", lambda cp: cp["time"], "{:.2f}".format),
)


def export_table_from_checkpoints_error(error_checkpoints, out: str):
    """Render the versus-exact checkpoint errors as a table file.

    error_checkpoints : list of CheckpointsErrorData dicts
        (see `utils.types`); rows are emitted in iteration order.
    """
    ordered = sorted(error_checkpoints, key=lambda cp: cp["iteration"])
    columns = {
        label: [fmt(get(cp)) for cp in ordered] for label, get, fmt in _COLUMNS
    }
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    export_table(DataFrame(columns), out_path=out)


def _to_excel(df: DataFrame, path: Path):
    # pandas cannot write MultiIndex columns without a row index.
    df.to_excel(path, index=df.columns.nlevels > 1)


_WRITERS = {
    ".tex": lambda df, path: df.to_latex(path, index=False, index_names=False),
    ".html": lambda df, path: df.to_html(path, index=False, index_names=False),
    ".csv": lambda df, path: df.to_csv(path, index=False),
    ".xlsx": _to_excel,
}


def export_table(dataframe: DataFrame, out_path: str):
    """Write a DataFrame to the format implied by the file extension."""
    out_path = Path(out_path)
    writer = _WRITERS.get(out_path.suffix)
    if writer is None:
        print(f"Unsupported file format: {out_path.suffix}")
        return
    writer(dataframe, out_path)
    print(f"Exported table: {out_path}")
