"""The metric arithmetic on synthetic records: solve_s over whole problems,
the device's busy union from overlapping kernels, a lost profiler session
dropped, and rooflines that count the work the solve needed, not launches."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from otbench import run, trace
from otbench.reference import bounds

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def read(name, rec):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(rec)


def problem(iterations, call_s, running_time, **cg):
    return {"iterations": iterations, "validations": 10, "call_s": call_s,
            "running_time": running_time, "capture_s": 0.5,
            "cg.solves": cg.get("solves", 0), "cg.iterations": cg.get("inner", 0)}


def test_solve_s_is_the_window_over_whole_problems():
    rec = {"window_s": 47.0, "setup_s": 12.0,
           "problems": [problem(1000, 15.0, 12.0), problem(1200, 16.0, 13.0),
                        problem(1100, 16.0, 13.0)]}
    assert read("solve_s", rec) == pytest.approx(47.0 / 3)
    assert read("setup_s", rec) == 12.0
    assert read("host_s_per_problem", rec) == pytest.approx(3.0)
    assert read("loop_it_per_s", rec) == pytest.approx(3300 / 38.0)
    assert read("iters_per_problem", rec) == pytest.approx(1100)
    assert read("capture_s_per_problem", rec) == pytest.approx(0.5)
    assert read("inner_cg_per_it", rec) is None  # spectral: no CG solve


def test_union_of_overlapping_kernels():
    starts = np.array([0, 5, 3, 20, 21, 40])
    ends = np.array([4, 10, 6, 25, 22, 41])
    lo, hi = trace._union(starts, ends)
    assert lo.tolist() == [0, 20, 40] and hi.tolist() == [10, 25, 41]


class FakeEvent:
    def __init__(self, name, device, start, end, annotation=False):
        self._v = (name, device, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def fake_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_idle_share_and_layers_from_a_session():
    from torch.autograd import DeviceType

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        FakeEvent(trace.SPAN, cpu, 0, 1000),
        FakeEvent(trace.SPAN, gpu, 0, 1000, annotation=True),  # the span's mirror: not work
        FakeEvent("cudaGraphLaunch", cpu, 100, 110),
        FakeEvent("cudaGraphLaunch", cpu, 500, 510),
        FakeEvent("window_spmv_kernel(Args)", gpu, 200, 300),
        FakeEvent("void cg_step_walk_kernel<4>(Args, int)", gpu, 250, 400),  # overlaps B1
        FakeEvent("sharded_window_spmv_kernel(Args)", gpu, 600, 700),
        FakeEvent("cudaStreamSynchronize", cpu, 400, 600),
    ]
    got = trace.read(fake_prof(events), {"b1": r"(^|[^\w])window_spmv_kernel",
                                         "k4": r"(^|[^\w])cg_step_(walk|wide|null)_kernel"})
    assert got["wall_s"] == pytest.approx(1000e-9)
    assert got["busy_s"] == pytest.approx(300e-9)  # [200, 400) and [600, 700)
    assert got["launch_calls"] == 2
    assert got["layers"]["b1"] == {"seconds": pytest.approx(100e-9), "events": 1}
    assert got["layers"]["k4"] == {"seconds": pytest.approx(150e-9), "events": 1}
    rec = {"profile": got}
    assert read("idle_share", rec) == pytest.approx(70.0)
    widest = got["idle_gaps"][0]
    assert widest[1] == pytest.approx(300e-9)  # [700, 1000): after the last replay
    assert widest[0].startswith("after the last graph replay")
    sync_gap = ["between graph replays: cudaStreamSynchronize", pytest.approx(200e-9)]
    assert sync_gap in got["idle_gaps"]


def test_lost_session_is_dropped_not_idle():
    from torch.autograd import DeviceType

    events = [FakeEvent(trace.SPAN, DeviceType.CPU, 0, 1000),
              FakeEvent("cudaGraphLaunch", DeviceType.CPU, 100, 110)]
    assert trace.read(fake_prof(events), {"b1": "window_spmv_kernel"}) is None


def roofline_record(live, matvecs, fused, b1_s, k4_s):
    record = {"cg.iterations": live, "cg.window_matvecs": matvecs, "cg.fused_steps": fused,
              "iterations": 10}
    return {"profile": {"record": record, "layers": {"b1": {"seconds": b1_s, "events": matvecs},
                                                     "k4": {"seconds": k4_s, "events": 5 * fused}},
                        "launch_calls": 110, "wall_s": 1.0, "busy_s": 0.9},
            "work": {"matvec": {"n_vertices": 46431, "lanes": 32, "nnz": 323061},
                     "cg_update": {"n_vertices": 46431, "lanes": 32}}}


def test_rooflines_count_needed_work_not_launches():
    # 284 live inner iterations, 10 pass starts, 369 latched iterations (85 no-ops).
    rec = roofline_record(live=284, matvecs=379, fused=369, b1_s=379 * 10.09e-6,
                          k4_s=369 * 46.4e-6)
    b1_least, b1_by = bounds.least_seconds(bounds.matvec_work(46431, 32, 323061))
    k4_least, k4_by = bounds.least_seconds(bounds.cg_update_work(46431, 32))
    assert (b1_by, k4_by) == ("bytes", "bytes")
    assert b1_least == pytest.approx(4.3e-6, rel=0.02)
    assert k4_least == pytest.approx(14.2e-6, rel=0.02)
    assert read("b1_roofline", rec) == pytest.approx(100 * 294 * b1_least / (379 * 10.09e-6))
    assert read("k4_roofline", rec) == pytest.approx(100 * 284 * k4_least / (369 * 46.4e-6))
    # More no-op launches in the same time leave the work, and so the share, as it was.
    more = roofline_record(live=284, matvecs=479, fused=469, b1_s=379 * 10.09e-6,
                           k4_s=369 * 46.4e-6)
    assert read("b1_roofline", more) == pytest.approx(read("b1_roofline", rec))
    assert read("k4_roofline", more) == pytest.approx(read("k4_roofline", rec))
    assert read("launch_calls_per_it", rec) == pytest.approx(11.0)
    # No kernel time, nothing read (never a share of 0).
    spectral = roofline_record(live=0, matvecs=0, fused=0, b1_s=0.0, k4_s=0.0)
    assert read("b1_roofline", spectral) is None and read("k4_roofline", spectral) is None


def test_profiled_session_with_lost_launches_is_dropped(monkeypatch):
    kernels = {"b1": {"pattern": "window_spmv_kernel", "launch_counter": "x:y"}}

    class Program:
        device = "cpu"

        def solve(self, geom, pair):
            return None, {"launches.b1": 3}

    got = {"layers": {"b1": {"seconds": 1e-5, "events": 2}}}
    monkeypatch.setattr(trace, "read", lambda prof, layers: dict(got))
    monkeypatch.setattr("torch.cuda.synchronize", lambda: None)
    assert run.profile_problem(Program(), {}, {}, kernels) is None
    got["layers"]["b1"]["events"] = 3
    assert run.profile_problem(Program(), {}, {}, kernels)["record"] == {"launches.b1": 3}
