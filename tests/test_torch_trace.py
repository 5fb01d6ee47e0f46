"""The port's tracer (`dots_socp_torch.utils.trace`) on the conftest plane
(n=12, ntime 7), on the spectral and the CG path: off, a solve leaves
nothing; on, one span tree per public call whose phases add up, agree with
the run history and the program's counters, and leave the answer bit for
bit as it was; its stamps share torch.profiler's clock; a profiler session
traces the calls inside it; the CLI's `--profile_dir` trace names the
phases; and the benchmark's readers of the tracer (`otbench/metrics/`)."""

import contextlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dots_socp_torch.ops import graphs
from dots_socp_torch.ops.laplacian import CG_COUNTERS
from dots_socp_torch.solver import socp
from dots_socp_torch.solver.decorators import solver, solver_raw
from dots_socp_torch.utils import trace
from torch_rank_worker import one_thread

REPO = Path(__file__).resolve().parents[1]
N_TIME = 7
PATHS = {"spectral": dict(laplacian_mode="spectral", precision="float64"),
         "cg": dict(laplacian_mode="cg", precision="float32")}
SOLVE = dict(tol=1e-2, nit=150, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


@contextlib.contextmanager
def tracing(annotate=False):
    trace.enable(annotate=annotate)
    try:
        yield
    finally:
        trace.disable()


def _checks_made(monkeypatch):
    """The validations the adaptive segments report (`packed[0]`), summed."""
    made = []
    real = socp.run_chunk_adaptive

    def counted(*args, **kwargs):
        state, packed = real(*args, **kwargs)
        made.append(int(packed[0]))
        return state, packed

    monkeypatch.setattr(socp, "run_chunk_adaptive", counted)
    return made


@pytest.fixture(scope="module", params=sorted(PATHS))
def solved(request, plane_geometry):
    """The path's solve with tracing off, then on: both answers, the traced
    problem and what the program counted around the traced call."""
    kw = dict(SOLVE, **PATHS[request.param])
    plain = solver(N_TIME, plane_geometry, **kw)
    with pytest.MonkeyPatch.context() as mp, tracing():
        made = _checks_made(mp)
        stats = graphs.STATS.snapshot()
        passes = CG_COUNTERS.passes
        traced = solver(N_TIME, plane_geometry, **kw)
    return {"path": request.param, "plain": plain, "traced": traced,
            "problem": trace.last_problem(), "checks": sum(made),
            "capture_s": graphs.STATS.since(stats)["capture_seconds"],
            "passes": CG_COUNTERS.passes - passes}


def _spans(problem, name):
    return [s for s in problem["spans"] if s["name"] == name]


def _seconds(s):
    return (s["end_ns"] - s["start_ns"]) / 1e9


def test_off_leaves_no_spans_and_no_events(plane_geometry, monkeypatch):
    """Tracing off: no problem opened, no CUDA event made, nothing kept."""
    def refuse(*args, **kwargs):
        raise AssertionError("the tracer ran while off")

    monkeypatch.setattr(trace, "_LAST", None)
    monkeypatch.setattr(trace, "_Problem", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    solver(N_TIME, plane_geometry, **dict(SOLVE, nit=5, **PATHS["cg"]))
    assert trace.last_problem() is None and not trace.ON and not trace._POOL


def test_span_tree_one_root_with_parents(solved):
    spans = solved["problem"]["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert len(roots) == 1 and roots[0] is spans[0] and spans[0]["name"] == "solve"
    for i, s in enumerate(spans[1:], 1):
        parent = spans[s["parent"]]
        assert s["parent"] < i
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    assert {s["name"] for s in spans} >= {"assembly", "build_problem", "initial_state", "loop",
                                          "segment", "run", "read", "finish", "final_kkt",
                                          "fetch_kkt", "recover", "recover_solution"}
    segments = {s["attrs"]["segment"] for s in _spans(solved["problem"], "run")}
    if solved["path"] == "cg":
        assert segments == {"before", "after", "start", "block", "finish", "init", "result",
                            "validate"}
        assert _spans(solved["problem"], "cg_pass") and _spans(solved["problem"], "cg_block")
    else:
        assert segments == {"iteration", "validate"}
        assert _spans(solved["problem"], "spectral_solve")


def test_phases_add_up_exactly(solved):
    problem = solved["problem"]
    (root,) = _spans(problem, "solve")
    phases = [s for s in problem["spans"] if s["parent"] == 0]
    assert [s["name"] for s in phases] == ["assembly", "loop", "finish"]
    assert phases[0]["start_ns"] == root["start_ns"] and phases[-1]["end_ns"] == root["end_ns"]
    for a, b in zip(phases, phases[1:]):
        assert a["end_ns"] == b["start_ns"]
    finish = problem["spans"].index(phases[2])
    final, recover = [s for s in problem["spans"] if s["parent"] == finish
                      and s["name"] in ("final_kkt", "recover")]
    assert (final["start_ns"], final["end_ns"], recover["end_ns"]) == (
        phases[2]["start_ns"], recover["start_ns"], phases[2]["end_ns"])
    totals = problem["totals"]
    assert totals["solve"]["count"] == totals["loop"]["count"] == 1


def test_running_time_is_loop_plus_final_kkt(solved):
    _, history = solved["traced"]
    totals = solved["problem"]["totals"]
    loop = totals["loop"]["host_s"] + totals["final_kkt"]["host_s"]
    assert abs(history.running_time - loop) < 1e-3


def test_validate_runs_are_the_segments_validations(solved):
    problem = solved["problem"]
    _, history = solved["traced"]
    validate = [s for s in _spans(problem, "run") if s["attrs"]["segment"] == "validate"]
    assert len(validate) == solved["checks"] > 0
    assert abs(len(history.kkt_iteration) - len(validate)) <= 1
    assert problem["spans"][0]["attrs"]["iterations"] == int(history.kkt_iteration[-1]) + 1


def test_captures_and_passes_match_the_counters(solved):
    problem = solved["problem"]
    capture = sum(_seconds(s) for s in _spans(problem, "capture"))
    assert capture == pytest.approx(solved["capture_s"], abs=1e-9)
    assert len(_spans(problem, "cg_pass")) == solved["passes"] == problem["counters"]["cg.passes"]
    assert (solved["passes"] > 0) == (solved["path"] == "cg")
    reads = len(_spans(problem, "read"))
    assert reads == problem["counters"]["graphs.host_reads"] + problem["counters"]["cg.flag_reads"]


def test_tracing_leaves_the_answer_bit_equal(solved):
    (sol_a, hist_a), (sol_b, hist_b) = solved["plain"], solved["traced"]
    assert sorted(sol_a) == sorted(sol_b)
    for key, value in sol_a.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value, sol_b[key], err_msg=key)
    np.testing.assert_array_equal(hist_a.kkt_errors, hist_b.kkt_errors)
    np.testing.assert_array_equal(hist_a.kkt_iteration, hist_b.kkt_iteration)
    for key in hist_a.history:
        np.testing.assert_array_equal(hist_a.history[key], hist_b.history[key], err_msg=key)


def test_each_public_call_is_one_problem_with_a_new_id(plane_geometry):
    kw = dict(SOLVE, nit=3, **PATHS["spectral"])
    ids = []
    with tracing():
        for entry in (solver, solver_raw, socp.solver_socp):
            entry(N_TIME, plane_geometry, **kw)
            problem = trace.last_problem()
            ids.append(problem["id"])
            assert [s["name"] for s in problem["spans"]].count("solve") == 1
    assert ids == sorted(ids) and len(set(ids)) == 3
    assert not trace.ON


def test_capture_span_feeds_capture_seconds(monkeypatch):
    """`STATS.capture_seconds` grows by the `capture` span's own reading;
    a replay runs inside its `run` span, between two events whose interval
    is the span's device seconds."""
    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    class Event:
        def __init__(self, enable_timing):
            self.at = None

        def record(self, stream):
            self.at = Graph.replays

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 1.5 * (end.at - self.at)

    def capture_graph(self, name, fn):
        self._graphs[name] = (Graph(), [0] * len(graphs._COUNTERS))
        return self._graphs[name]

    monkeypatch.setattr(graphs.Workspace, "_capture_graph", capture_graph)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(trace, "_POOL", [])

    @trace.problem
    def two_runs():
        ws = graphs.Workspace("cpu")
        ws.captures = True
        ws.run("seg", lambda b: {})
        ws.run("seg", lambda b: {})

    before = graphs.STATS.snapshot()
    with tracing():
        two_runs()
    problem = trace.last_problem()
    (capture,) = _spans(problem, "capture")
    runs = _spans(problem, "run")
    assert [r["attrs"]["how"] for r in runs] == ["capture", "replay"] and Graph.replays == 2
    assert [r["device_s"] for r in runs] == [pytest.approx(1.5e-3)] * 2
    assert capture["parent"] == problem["spans"].index(runs[0])
    grew = graphs.STATS.since(before)
    assert grew["captures"] == 1
    assert grew["capture_seconds"] == pytest.approx(_seconds(capture), abs=1e-12)
    assert problem["counters"]["graphs.captures"] == 1


def test_replay_events_are_read_once_and_never_inside_a_later_call(monkeypatch):
    """A problem's replay events are read when `last_problem()` reads it,
    with one wait for the last; a problem left unread gives its events back
    to the pool when the next begins, and that call waits on none."""
    class Event:
        syncs = 0

        def synchronize(self):
            Event.syncs += 1

        def query(self):
            return True

        def elapsed_time(self, end):
            return 2.0

    @trace.problem
    def call():
        pass

    monkeypatch.setattr(trace, "_POOL", [])
    with tracing():
        call()
        unread = [Event() for _ in range(6)]
        spans, starts, ends = trace._LAST.pending
        spans.extend([0] * 3)
        starts.extend(unread[:3])
        ends.extend(unread[3:])
        call()
        assert Event.syncs == 0 and sorted(map(id, trace._POOL)) == sorted(map(id, unread))
        spans, starts, ends = trace._LAST.pending
        spans.extend([0] * 3)
        starts.extend(Event() for _ in range(3))
        ends.extend(Event() for _ in range(3))
    problem = trace.last_problem()
    assert Event.syncs == 1 and len(trace._POOL) == 12
    assert problem["spans"][0]["device_s"] == pytest.approx(0.002)
    assert trace.last_problem() is problem and Event.syncs == 1


def test_cg_counters_reset_clears_passes():
    saved = dict(vars(CG_COUNTERS))
    try:
        CG_COUNTERS.passes = 5
        CG_COUNTERS.reset()
        assert all(v == 0 for v in vars(CG_COUNTERS).values())
    finally:
        for key, value in saved.items():
            setattr(CG_COUNTERS, key, value)


def test_spans_share_the_profilers_clock(plane_geometry):
    """Each span's profiler range (annotate) lies within 20 us of the
    tracer's own stamps: one clock, no offset."""
    kw = dict(SOLVE, nit=8, **PATHS["cg"])
    with profile(activities=[ProfilerActivity.CPU]) as prof, tracing(annotate=True):
        solver(N_TIME, plane_geometry, **kw)
    problem = trace.last_problem()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            ranges.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
    names = {s["name"] for s in problem["spans"]}
    assert names <= set(ranges)
    slack = 20_000
    for name in names:
        spans = sorted((s["start_ns"], s["end_ns"]) for s in _spans(problem, name))
        got = sorted(ranges[name])
        assert len(got) == len(spans), name
        for (s0, s1), (k0, k1) in zip(spans, got):
            assert k0 >= s0 - slack and k1 <= s1 + slack, name


def test_a_profiler_session_traces_the_calls_inside_it(plane_geometry):
    kw = dict(SOLVE, nit=3, **PATHS["spectral"])
    with profile(activities=[ProfilerActivity.CPU]):
        solver(N_TIME, plane_geometry, **kw)
    inside = trace.last_problem()
    assert inside is not None and not trace.ON
    assert all(s["name"] != "run" or s["device_s"] is None for s in inside["spans"])
    solver(N_TIME, plane_geometry, **kw)
    assert trace.last_problem() is inside


def test_profile_dir_trace_names_the_phases(plane_geometry, tmp_path):
    from dots_socp_torch import interface

    with interface.profiler_trace(tmp_path) as out:
        solver(N_TIME, plane_geometry, **dict(SOLVE, nit=3, **PATHS["cg"]))
    names = {e.get("name") for e in json.loads(out.read_text())["traceEvents"]}
    assert {"solve", "assembly", "segment", "loop", "finish"} <= names
    assert not trace._WANT and not trace._ANNOTATE


# ---- the benchmark's readers of the tracer ---------------------------------

def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"otbench_metric_{name}", REPO / "otbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _span(name, start, end, parent, device=None, **attrs):
    return {"name": name, "start_ns": start, "end_ns": end, "parent": parent,
            "attrs": attrs, "device_s": device}


SYNTHETIC = {
    "id": 7,
    "spans": [
        _span("solve", 0, 10_000_000_000, None, iterations=40),
        _span("assembly", 0, 2_000_000_000, 0),
        _span("loop", 2_000_000_000, 9_000_000_000, 0),
        _span("run", 2_100_000_000, 2_200_000_000, 2, 0.5, segment="iteration", how="capture"),
        _span("run", 2_300_000_000, 2_400_000_000, 2, 3.0, segment="iteration", how="replay"),
        _span("run", 2_500_000_000, 2_600_000_000, 2, 0.002, segment="validate", how="replay"),
        _span("run", 2_700_000_000, 2_800_000_000, 2, 0.004, segment="validate", how="replay"),
        _span("run", 2_900_000_000, 2_950_000_000, 2, None, segment="validate", how="op_by_op"),
        _span("finish", 9_000_000_000, 10_000_000_000, 0),
    ],
    "totals": {"assembly": {"count": 1, "host_s": 2.0, "self_s": 2.0, "device_s": None},
               "loop": {"count": 1, "host_s": 7.0, "self_s": 6.5, "device_s": None},
               "finish": {"count": 1, "host_s": 1.0, "self_s": 1.0, "device_s": None}},
    "counters": {"graphs.host_reads": 30, "cg.flag_reads": 170},
}
EXPECTED = {"assembly_s": 2.0, "finish_s": 1.0, "validate_device_ms": 3.0,
            "loop_device_share": 100.0 * 3.506 / 7.0, "host_reads_per_it": 5.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_of_the_tracer(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(trace, "last_problem", lambda: SYNTHETIC)
    rec = {"profile": {"record": {"iterations": 40}}, "problems": []}
    assert read(rec) == pytest.approx(EXPECTED[name])
    assert read({"profile": None, "problems": []}) is None
    assert read({"profile": {"record": {"iterations": 41}}, "problems": []}) is None
    monkeypatch.setattr(trace, "last_problem", lambda: None)
    assert read(rec) is None
