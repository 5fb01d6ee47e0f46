"""BENCHMARK.json and the files it names: every configuration, traffic mix,
limit, metric reader and kernel list found by name, within the contract's
names, units and sizes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

from otbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def metric_module(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "otbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["otbench"]
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_uniqueness():
    for group in ("configs", "workloads"):
        names = [entry["name"] for entry in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for entry in BENCH["configs"] + BENCH["workloads"] + METRICS:
        assert NAME.match(entry["name"]), entry["name"]
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_by_name(config):
    path = ROOT / config["file"]
    assert path.parts[len(ROOT.parts)] == "otbench"
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert data["phi_solve"] in ("spectral", "cg")
    # The sizes the file states are those of the mesh the harness makes.
    geom = run.MESHES[data["mesh"]](data["n_space"])
    assert geom["triangles"].shape[0] == data["n_triangles"]
    assert geom["vertices"].shape[0] == data["n_vertices"]
    assert (data["n_vertices"] <= 16384) == (data["phi_solve"] == "spectral")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    mix = json.loads((ROOT / "otbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert mix["name"] == cell["traffic"]
    limits = json.loads((ROOT / "otbench" / "limits" / f"{cell['name']}.json").read_text())
    assert set(limits["compared"]) == {"continuity", "momentum", "complement", "cost_gap"}
    for number in limits["compared"].values():
        assert 0 < number["limit"]
    # Every cell reports setup_s, another end-to-end metric and a per-layer one.
    def reports(metric):
        return cell["name"] in metric.get("workloads", [cell["name"]])

    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    module = metric_module(metric["name"])
    assert callable(module.read)
    assert (module.UNIT, module.BETTER, module.SOURCE) == (
        metric["unit"], metric["better"], metric["source"])
    if metric in BENCH["per_layer"]:
        assert (module.LAYER, module.MOVES) == (metric["layer"], metric["moves"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(metric["workloads"]) <= {c["name"] for c in BENCH["workloads"]}
    else:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_kernel_lists_name_their_kernels():
    lists = {p.stem: json.loads(p.read_text())
             for p in (ROOT / "otbench" / "kernels").glob("*.json")}
    assert {"b1", "k4"} <= set(lists)
    b1, k4 = (re.compile(lists[k]["pattern"]) for k in ("b1", "k4"))
    assert b1.search("window_spmv_kernel(Args)")
    assert not b1.search("sharded_window_spmv_kernel(Args)")
    for stage in ("void cg_step_walk_kernel<4>(Args, int)", "cg_step_wide_kernel(Args, int)",
                  "cg_step_null_kernel<16>(Args)"):
        assert k4.search(stage) and not b1.search(stage)
    for entry in lists.values():
        module, attr = entry["launch_counter"].split(":")
        assert module.startswith("dots_socp_torch.") and attr
        assert entry["metric"] in {m["name"] for m in BENCH["per_layer"]}
