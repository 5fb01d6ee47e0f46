"""The control of `correct` and the fault only `cost_gap` sees: the
program's answer in bfloat16, and its reported cost altered by 1%, must come
out not correct where the sound run is correct (the CPU at a tiny size; the
cells' own sizes on the card: `python3 -m otbench.control`)."""

from __future__ import annotations

import time

import pytest

from otbench import control, run


def tiny_spec(tmp_path, monkeypatch, workload, n_space, ntime, phi_solve):
    for var in run.CACHE_VARS:
        monkeypatch.delenv(var, raising=False)  # restored after the test
    run.use_cache_dirs(tmp_path / "cache")
    spec = run.load_spec(workload)
    spec["config"] = dict(spec["config"], n_space=n_space, ntime=ntime, phi_solve=phi_solve)
    spec["mix"] = dict(spec["mix"], warmup_nit=5, nit=3000)
    return spec


@pytest.mark.parametrize("name", ["bf16", "cost"])
def test_lower_precision_answer_is_not_correct(tmp_path, monkeypatch, name):
    spec = tiny_spec(tmp_path, monkeypatch, "plane64.tol1e-4", 10, 7, "spectral")
    with control.variant(name):
        result = run.run_cell(spec, 11, 0.5, False, device="cpu", t_process=time.perf_counter())
    assert not result["correct"]
    with control.variant("none"):
        result = run.run_cell(spec, 11, 0.5, False, device="cpu", t_process=time.perf_counter())
    assert result["correct"]
