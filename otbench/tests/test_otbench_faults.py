"""A whole run of the harness on the CPU at a tiny size (the look for a chip
skipped), sound and with the timed path broken underneath: `correct` must
come out true, then false for each fault a cell of this benchmark can have.
Of the four kinds of fault such a check is held against (a state left
unchanged, half a batch left out, an exchange between chips left out, an
answer altered), two can happen here: the cells solve one problem per call
on one chip, with no batch to halve and no exchange between chips."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from otbench import run

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def tiny_spec(tmp_path, monkeypatch):
    """plane64.tol1e-4 with its limits, cut to plane n10 at ntime 7 (tol and
    limits as the cell has them)."""
    for var in run.CACHE_VARS:
        monkeypatch.delenv(var, raising=False)  # restored after the test
    run.use_cache_dirs(tmp_path / "cache")
    spec = run.load_spec("plane64.tol1e-4")
    spec["config"] = dict(spec["config"], n_space=10, ntime=7)
    spec["mix"] = dict(spec["mix"], warmup_nit=5, nit=3000)
    return spec


def run_tiny(spec, trace=False):
    return run.run_cell(spec, 2**35 + 3, 0.5, trace, device="cpu", t_process=time.perf_counter())


def test_sound_run_is_correct(tiny_spec):
    result = run_tiny(tiny_spec)
    assert result["correct"] and result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"solve_s", "setup_s"}
    assert list(result)[-1] == "compared"
    for number in result["compared"].values():
        assert number["value"] <= number["limit"]


def test_step_that_returns_its_state_unchanged(tiny_spec, monkeypatch):
    from dots_socp_torch.solver import socp

    segment = socp.run_chunk_adaptive

    def unchanged(config, data, state, *args, **kwargs):
        kept = type(state)(*(t.clone() if torch.is_tensor(t) else t for t in state))
        _, packed = segment(config, data, state, *args, **kwargs)
        return kept, packed

    monkeypatch.setattr(socp, "run_chunk_adaptive", unchanged)
    assert not run_tiny(tiny_spec)["correct"]


def test_answer_altered_where_it_is_produced(tiny_spec, monkeypatch):
    from dots_socp_torch.solver import socp

    recover = socp._recover_solution

    def altered(*args, **kwargs):
        solution = recover(*args, **kwargs)
        solution["E"] = solution["E"] * 1.02
        return solution

    monkeypatch.setattr(socp, "_recover_solution", altered)
    assert not run_tiny(tiny_spec)["correct"]


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["dots_socp_torch", "dots_socp_torch.ops.graphs"]) == []
    assert run.forbidden_modules(["jaxtyping", "flaxen", "dots_socp_tpu_extra"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "dots_socp_tpu.ops"]) == [
        "dots_socp_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax(tmp_path):
    """A CPU run of the harness in a fresh interpreter, then its modules."""
    code = f"""
import json, sys, time
t0 = time.perf_counter()
from otbench import run
run.use_cache_dirs(__import__("pathlib").Path({str(tmp_path)!r}))
spec = run.load_spec("plane200.tol1e-4")
spec["config"] = dict(spec["config"], n_space=8, ntime=3, phi_solve="spectral")
spec["mix"] = dict(spec["mix"], warmup_nit=3, nit=20)
run.run_cell(spec, 7, 0.1, True, device="cpu", t_process=t0)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dots_socp_torch.solver" in modules and "otbench.reference.optimality" in modules
    assert run.forbidden_modules(modules) == []


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "-m", "otbench.run", "--workload", "plane64.tol1e-4",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files the
    command fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "otbench", tmp_path / "otbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "otbench.run", "--workload", "plane64.tol1e-4",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
