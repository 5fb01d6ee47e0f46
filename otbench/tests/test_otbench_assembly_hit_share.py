"""The `assembly_hit_share` reader on a synthetic traced problem: the
profiled problem's assembly lookups that found the mesh's operators kept
from an earlier call, over all its lookups; nothing where the program keeps
no such counters."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def read(name, rec):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(rec)


def test_assembly_hit_share_from_the_traced_problem(monkeypatch):
    """The profiled problem's lookups kept across calls over all its lookups;
    nothing where the program keeps no such counters (the parent's)."""
    from dots_socp_torch.utils import trace as program_trace

    rec = {"profile": {"record": {"iterations": 40}}, "problems": []}
    traced = {"spans": [{"name": "solve", "attrs": {"iterations": 40}}],
              "counters": {"assembly.hits": 3, "assembly.misses": 1, "graphs.host_reads": 9}}
    monkeypatch.setattr(program_trace, "last_problem", lambda: traced)
    assert read("assembly_hit_share", rec) == pytest.approx(75.0)
    traced["counters"] = {"assembly.hits": 1, "assembly.misses": 0}
    assert read("assembly_hit_share", rec) == pytest.approx(100.0)
    traced["counters"] = {"graphs.host_reads": 9}
    assert read("assembly_hit_share", rec) is None
    assert read("assembly_hit_share", {"profile": None, "problems": []}) is None
