"""The `fused_step_share` reader on synthetic traced problems: the profiled
problem's iterations through kernel K6 over its iterations; None on a
program without the counter (the parent's record), without a profile, or
where the tracer's last problem is not the profiled one."""

from __future__ import annotations

import importlib.util
import sys
import types
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader():
    spec = importlib.util.spec_from_file_location("fused_step_share",
                                                  METRICS / "fused_step_share.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _traced(monkeypatch, counters, iterations=1100, profiled=1100):
    """A record whose profiled problem (`profiled` iterations) the program's
    tracer kept with `counters` over `iterations` (a stand-in
    `dots_socp_torch.utils.trace`)."""
    problem = {"spans": [{"name": "solve", "attrs": {"iterations": iterations}}],
               "totals": {}, "counters": counters}
    fake = types.ModuleType("dots_socp_torch.utils.trace")
    fake.last_problem = lambda: problem
    pkg = types.ModuleType("dots_socp_torch.utils")
    pkg.trace = fake
    monkeypatch.setitem(sys.modules, "dots_socp_torch.utils", pkg)
    monkeypatch.setitem(sys.modules, "dots_socp_torch.utils.trace", fake)
    return {"profile": {"record": {"iterations": profiled}}}


def test_the_metrics_declaration():
    module = reader()
    assert (module.UNIT, module.BETTER, module.SOURCE) == ("%", "higher", "program_counter")
    assert (module.LAYER, module.MOVES) == ("kernel K6", "solve_s")


@pytest.mark.parametrize("steps, share", [(1100, 100.0), (275, 25.0), (0, 0.0)])
def test_a_change_record_reads_its_iterations_through_k6(monkeypatch, steps, share):
    rec = _traced(monkeypatch, {"step.fused_steps": steps, "graphs.host_reads": 7})
    assert reader().read(rec) == share


def test_a_parent_record_without_the_counter_reads_none(monkeypatch):
    rec = _traced(monkeypatch, {"graphs.host_reads": 7, "cg.iterations": 30_000})
    assert reader().read(rec) is None
    assert reader().read({"profile": None}) is None


def test_another_problem_than_the_profiled_one_reads_none(monkeypatch):
    rec = _traced(monkeypatch, {"step.fused_steps": 900}, iterations=900, profiled=1100)
    assert reader().read(rec) is None
