"""The float64 cell's benchmark files: the reader of `f64_route_share` on
synthetic records (None where it finds nothing: the spectral path, a
program without the counter, no profile), and BENCHMARK.json's new entries
found through `load_spec`."""

from __future__ import annotations

import importlib.util
import json
import sys
import types
from pathlib import Path

import pytest

from otbench import run

ROOT = Path(__file__).resolve().parents[2]
METRICS = ROOT / "otbench" / "metrics"
CELL = "plane200f64.tol1e-4"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _traced(monkeypatch, counters, iterations=1000):
    """A record whose profiled problem the program's tracer kept with
    `counters` (a stand-in `dots_socp_torch.utils.trace`)."""
    problem = {"spans": [{"name": "solve", "attrs": {"iterations": iterations}}],
               "totals": {}, "counters": counters}
    fake = types.ModuleType("dots_socp_torch.utils.trace")
    fake.last_problem = lambda: problem
    pkg = types.ModuleType("dots_socp_torch.utils")
    pkg.trace = fake
    monkeypatch.setitem(sys.modules, "dots_socp_torch.utils", pkg)
    monkeypatch.setitem(sys.modules, "dots_socp_torch.utils.trace", fake)
    return {"profile": {"record": {"iterations": iterations}}}


@pytest.mark.parametrize("f64_steps, share", [(30_000, 100.0), (7_500, 25.0)])
def test_f64_route_share_reads_the_live_iterations_through_k4_f64(monkeypatch, f64_steps, share):
    rec = _traced(monkeypatch, {"cg.iterations": 30_000, "cg.f64_fused_steps": f64_steps})
    assert reader("f64_route_share")(rec) == share


@pytest.mark.parametrize("counters", [
    {"cg.iterations": 30_000},  # a program without the counter
    {"cg.iterations": 0, "cg.f64_fused_steps": 0},  # the spectral path
])
def test_f64_route_share_reads_none_without_its_counters(monkeypatch, counters):
    assert reader("f64_route_share")(_traced(monkeypatch, counters)) is None
    assert reader("f64_route_share")({"profile": None}) is None


def test_f64_route_share_reads_none_for_another_problem(monkeypatch):
    """The tracer's last problem is not the profiled one (another iteration
    count): nothing to read."""
    rec = _traced(monkeypatch, {"cg.iterations": 30_000, "cg.f64_fused_steps": 30_000})
    rec["profile"]["record"]["iterations"] = 999
    assert reader("f64_route_share")(rec) is None


def test_the_f64_cell_resolves_through_load_spec():
    """plane200f64.tol1e-4: the float64 configuration on the CG path, the
    float32 cell's traffic, its own limits, every per-layer metric of the
    layers it runs (the float32 kernels' rooflines aside) and
    `f64_route_share`, which no other cell reports."""
    spec = run.load_spec(CELL)
    config = spec["config"]
    assert config["precision"] == "float64" and config["phi_solve"] == "cg"
    assert config["n_vertices"] == 46_431 and config["ntime"] == 31 and config["reduced"] == []
    assert spec["cell"]["traffic"] == "gauss-pairs.tol1e-4" and spec["cell"]["chips"] == 1
    assert [m["name"] for m in spec["end_to_end"]] == ["solve_s", "setup_s"]
    names = [m["name"] for m in spec["per_layer"]]
    assert "f64_route_share" in names and "inner_cg_per_it" in names
    assert not {"b1_roofline", "k4_roofline"} & set(names)
    assert set(spec["limits"]["compared"]) == {"continuity", "momentum", "complement", "cost_gap"}
    for cell in ("plane200.tol1e-4", "plane64.tol1e-4"):
        assert "f64_route_share" not in [m["name"] for m in run.load_spec(cell)["per_layer"]]


def test_the_f64_configuration_is_the_f32_one_in_float64():
    """`plane-n200-t31-f64` differs from `plane-n200-t31-f32` only in its
    precision and what it says of it: the same mesh, resolution and ntime."""
    configs = ROOT / "otbench" / "configs"
    f64 = json.loads((configs / "plane-n200-t31-f64.json").read_text())
    f32 = json.loads((configs / "plane-n200-t31-f32.json").read_text())
    same = ("mesh", "n_space", "n_vertices", "n_triangles", "ntime", "phi_solve", "reduced")
    assert {k: f64[k] for k in same} == {k: f32[k] for k in same}
    assert (f64["precision"], f32["precision"]) == ("float64", "float32")
