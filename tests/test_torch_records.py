"""The records driver (`dots_socp_torch.scripts.records`): its parsers on the
JAX package's real artifact files, its verdict at each tolerance's edge,
and a run end to end on the CPU at a tiny size (the plumbing only: a tiny
problem is not held to a record)."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dots_socp_torch.scripts import records, steady_state_configs
from torch_rank_worker import ONE_THREAD_ENV, one_thread

REPO = Path(__file__).resolve().parents[1]
TINY_SWEEP = ("--ntime", "4", "--nit", "40", "--time_limit", "60")
TINY_CONFIG = ["--example=plane", "--n_space=12", "--ntime=8", "--tol=1e-2", "--nit=40",
               "--time_limit=60"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def test_sweep_tables_read_42_rows():
    rows = records.sweep_reference()
    assert len(rows) == 42
    assert {c for _, c in rows} == set(records.SWEEP_CONGESTIONS)
    ring = rows[("ring", "0.00")]
    assert (ring["iterations"], ring["cost"]) == (718, 0.269)
    assert ring["source"] == "artifacts/round5/make_main/congestion_0_00/comparison_table.tex:18"
    assert rows[("knots_3", "0.00")]["iterations"] == 3436
    assert rows[("refined_punctured_ball", "0.05")]["iterations"] == 274
    # Every example of the sweep's default list, under the name it takes.
    from dots_socp_torch.replication.sweep import DEFAULT_EXAMPLES

    assert {e for e, _ in rows} == set(DEFAULT_EXAMPLES)


def test_sweep_pads_as_the_jax_sweep_did():
    """R1 runs the port's sweep on the shapes the JAX sweep solved: its
    --pad_multiple default (the shape buckets)."""
    import re

    text = (REPO / "replication" / "sweep.py").read_text()
    (jax_pad,) = re.findall(r'"--pad_multiple", type=int, default=(\d+)', text)
    argv = records.RECORDS["R1"].argv
    assert argv[argv.index("--pad_multiple") + 1] == jax_pad == "4096"


@pytest.mark.parametrize("record, iterations, cost, errors", [
    ("R2", 426, 2.542404e-01, None),
    ("R3", 1611, 3.998706e-02, None),
    ("R4", 1146, 3.980795e-02, None),
    ("R5", 1465, 3.978904e-02, None),
    ("R6", 1246, 3.986945e-02, None),
    ("R7", 412, 2.507968e-01, None),
    ("R8", 5493, None, {"l1": 9.94e-4, "l2": 1.49e-3, "linf": 5.05e-3}),
    ("R9", 4889, 3.998933e-02, {"l1": 1.77e-3, "l2": 2.91e-3, "linf": 1.45e-2}),
    ("R10", 1332, 3.990919e-02, None),
])
def test_record_reads_its_artifact(record, iterations, cost, errors):
    """Each record's JAX result, as parsed from its file, with the file and
    lines it came from."""
    (jax,) = records.RECORDS[record].reference().values()
    assert jax["iterations"] == iterations
    assert jax.get("cost") == cost
    assert jax.get("errors") == errors
    path, lines = jax["source"].split(":")
    lines = [int(n) for n in lines.split(",")]
    text = (REPO / path).read_bytes().decode().split("\n")[min(lines) - 1:max(lines)]
    assert any(str(iterations) in line for line in text)


def test_protocol_configs_agree_with_baseline():
    """R2 and R3 come from the steady-state artifact; BASELINE.md quotes
    the same counts."""
    baseline = (REPO / "BASELINE.md").read_text()
    for record in ("R2", "R3"):
        (jax,) = records.RECORDS[record].reference().values()
        assert f"**{jax['iterations']} iterations**" in baseline


def test_log_result_stops_above_the_line_it_is_given():
    path = REPO / "artifacts" / "round4" / "steady_state_configs.stdout"
    assert records.log_result(path, before=120)["iterations"] == 426
    assert records.log_result(path, before=119)["iterations"] == 1  # the warm-up's block


def _port(iterations=1000, cost=0.04, converged=True, errors=None):
    out = {"iterations": iterations, "cost": cost, "converged": converged}
    if errors:
        out["errors"] = errors
    return out


JAX_ROW = {"iterations": 1000, "cost": 0.04, "errors": {"l1": 1e-3, "l2": 2e-3}}
COST_EDGE = records.COST_RTOL * 0.04 + records.COST_ATOL
IN, OUT = 0.999, 1.001


@pytest.mark.parametrize("port, failed", [
    (_port(errors={"l1": 1e-3, "l2": 2e-3}), set()),
    (_port(converged=False, errors={"l1": 1e-3, "l2": 2e-3}), {"converged"}),
    (_port(iterations=1100, errors={"l1": 1e-3, "l2": 2e-3}), set()),
    (_port(iterations=1101, errors={"l1": 1e-3, "l2": 2e-3}), {"iterations"}),
    (_port(iterations=899, errors={"l1": 1e-3, "l2": 2e-3}), {"iterations"}),
    (_port(cost=0.04 + IN * COST_EDGE, errors={"l1": 1e-3, "l2": 2e-3}), set()),
    (_port(cost=0.04 - OUT * COST_EDGE, errors={"l1": 1e-3, "l2": 2e-3}), {"cost"}),
    (_port(errors={"l1": 1e-3 * (1 + 0.1 * IN), "l2": 2e-3}), set()),
    (_port(errors={"l1": 1e-3, "l2": 2e-3 * (1 - 0.1 * OUT)}), {"error_l2"}),
], ids=["equal", "not_converged", "iterations_edge_in", "iterations_above", "iterations_below",
        "cost_in", "cost_out", "error_in", "error_out"])
def test_verdict_at_each_tolerance(port, failed):
    checks = records.compare(port, JAX_ROW)
    assert {k for k, ok in checks.items() if not ok} == failed


def test_records_run_end_to_end_on_the_cpu(monkeypatch, tmp_path):
    """One row of the sweep and R3, both cut to a tiny size: a line per row
    with the port's and the record's numbers, the card field, a summary
    naming both as disagreeing (tiny sizes are not the record's), and the
    cache directory restored."""
    monkeypatch.setitem(records.RECORDS, "R1", records.RECORDS["R1"]._replace(argv=TINY_SWEEP))
    monkeypatch.setitem(steady_state_configs.CONFIGS, "3", TINY_CONFIG)
    monkeypatch.delenv("DOTS_SOCP_CACHE_DIR", raising=False)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = records.main(["--only", "R1", "R3", "--examples", "punctured_ball",
                            "--congestions", "0.01", "--outdir", str(tmp_path), "--device", "cpu"])
    lines = [json.loads(ln) for ln in printed.getvalue().splitlines() if ln.startswith('{"record": ')]
    assert lines == out["lines"] and len(lines) == 2
    sweep_row, r3 = lines
    assert (sweep_row["record"], sweep_row["row"], r3["record"], r3["row"]) == (
        "R1", "punctured_ball@0.01", "R3", None)
    assert sweep_row["jax"]["iterations"] == 305 and r3["jax"]["iterations"] == 1611
    for line in lines:
        assert line["device"] == "cpu" and line["card"] is None
        assert 0 < line["port"]["iterations"] <= 40 and line["port"]["it_per_s"] > 0
        assert line["checks"]["iterations"] is False and line["agrees"] is False
    assert out["disagree"] == ["R1:punctured_ball@0.01", "R3"] and out["agrees"] is False
    assert (tmp_path / "R1" / "congestion_0_01" / "comparison_table.tex").exists()
    assert "DOTS_SOCP_CACHE_DIR" not in os.environ


def test_records_exit_code_is_one_when_a_row_disagrees(tmp_path):
    """Started as a module (R3 cut to a tiny size before the module runs),
    the records driver prints its lines and exits 1."""
    code = (
        "import runpy, sys\n"
        "from dots_socp_torch.scripts import steady_state_configs\n"
        f"steady_state_configs.CONFIGS['3'] = {TINY_CONFIG!r}\n"
        f"sys.argv = ['records', '--only', 'R3', '--device', 'cpu', '--outdir', {str(tmp_path)!r}]\n"
        "runpy.run_module('dots_socp_torch.scripts.records', run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["disagree"] == ["R3"] and summary["agrees"] is False
