"""The port's measurement drivers `scripts.profile_large`,
`scripts.refine_cost_bench`, `scripts.bench_matvec` and
`scripts/measure_protocol.sh` at tiny sizes on the CPU, and where the
kernel library is built (`ops/_build.py`)."""

import argparse
import contextlib
import functools
import importlib
import io
import json
import os
import re
import shlex
import subprocess
from pathlib import Path

import numpy as np
import pytest

from dots_socp_torch.ops import _build
from dots_socp_torch.scripts import (
    bench_matvec, common, profile_large, refine_cost_bench, spectral_floor)
from torch_rank_worker import one_thread

REPO = Path(__file__).resolve().parents[1]
PROTOCOL = REPO / "dots_socp_torch" / "scripts" / "measure_protocol.sh"


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def run_main(main, argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = main(argv)
    lines = printed.getvalue().strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    return out


# ---- where the kernel library is built --------------------------------------

def test_kernel_library_lies_under_the_cache_dir(monkeypatch, tmp_path):
    """With DOTS_SOCP_CACHE_DIR set, the library (and its build log beside it)
    goes to $DOTS_SOCP_CACHE_DIR/kernels, read when the path is asked for."""
    monkeypatch.setenv("DOTS_SOCP_CACHE_DIR", str(tmp_path))
    path = _build.library_path()
    assert path.parent == tmp_path / "kernels" == _build.build_dir()
    assert re.fullmatch(r"libdots_torch_kernels_[0-9a-f]{16}\.so", path.name)


def test_kernel_library_defaults_to_the_repository_build_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("DOTS_SOCP_CACHE_DIR", str(tmp_path))
    under_cache = _build.library_path()
    monkeypatch.delenv("DOTS_SOCP_CACHE_DIR")
    path = _build.library_path()
    assert path.parent == REPO / "build" / "kernels"
    assert path.name == under_cache.name  # the same sources and flags


# ---- device_ms: lost profiler events -----------------------------------------

class FakeProfile:
    """torch.profiler.profile's stand-in: one CUDA event of `us` µs per call
    of the function under it (counted by `FakeProfile.calls`), the first
    `lost` calls' events lost, as CUPTI loses them now and then."""

    calls = 0

    def __init__(self, lost, us=2.0, **kw):
        self.lost, self.us = lost, us

    def __enter__(self):
        FakeProfile.calls = 0
        return self

    def __exit__(self, *exc):
        from types import SimpleNamespace

        from torch.autograd import DeviceType

        span = SimpleNamespace(elapsed_us=lambda: self.us)
        self._events = [SimpleNamespace(device_type=DeviceType.CUDA, name="k", time_range=span)
                        for _ in range(max(FakeProfile.calls - self.lost, 0))]

    def events(self):
        return self._events


class FakeEvent:
    """torch.cuda.Event's stand-in: 3 ms between any two."""

    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 3.0


@pytest.mark.parametrize("lost", [0, 15, 25, 26, 75])
def test_device_ms_keeps_a_session_that_lost_some_calls(monkeypatch, lost):
    """A session makes 75 calls for reps=50; up to 25 calls' events may be
    lost (the mean of the rest is the time). With more lost in every one of
    three sessions the calls are timed between CUDA events instead, and with
    none recorded at all it raises."""
    import torch
    import torch.profiler

    from dots_socp_torch import kernel_timing

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: FakeProfile(lost))

    def fn():
        FakeProfile.calls += 1

    if lost == 75:
        with pytest.raises(RuntimeError, match="recorded no device event"):
            kernel_timing.device_ms(fn, reps=50)
        return
    ms, by_name, events = kernel_timing.device_ms(fn, reps=50)
    assert events["seen"] == {"k": 75 - lost} and events["calls"] == 75
    if lost <= 25:
        assert ms == pytest.approx(2e-3) and by_name == {"k": pytest.approx(2e-3)}
        assert events["sessions"] == 1 and events["timed_by"] == "torch.profiler"
    else:
        assert ms == pytest.approx(3.0 / 75) and by_name == {"k": pytest.approx(3.0 / 75)}
        assert events["sessions"] == 3 and events["timed_by"] == "cuda events"


# ---- profile_large ----------------------------------------------------------

COMPONENTS = ("iteration", "cg_solve", "proj_soc", "laplacian_rhs", "q_dual", "kkt_table")


def test_profile_large_attributes_every_component(monkeypatch, tmp_path):
    """plane n12 with the CG path forced (the automatic choice at n200 and
    above; a mesh this small would take the spectral one), --cg_rtol pinned,
    --cg_slope, --f64_solve_race and --profile_dir: every key of the JAX
    script's line, the trace written, and the vertex count the JAX package
    builds for the same mesh."""
    import __graft_entry__ as graft

    monkeypatch.setattr(common, "plane_problem",
                        functools.partial(common.plane_problem, laplacian_mode="cg"))
    out = run_main(profile_large.main, [
        "--n_space", "12", "--ntime", "4", "--iters", "2", "--cg_rtol", "1e-4", "--cg_slope",
        "--f64_solve_race", "--profile_dir", str(tmp_path), "--device", "cpu"])
    for name in COMPONENTS:
        assert out[f"{name}_ms"] > 0, name
    assert out["unattributed_ms"] == pytest.approx(
        out["iteration_ms"] - out["cg_solve_ms"] - out["proj_soc_ms"] - out["q_dual_ms"])
    assert out["device_event_ms"] is None and out["device"] == "cpu"
    assert out["laplacian_mode"] == "cg" and out["cg_rtol"] == pytest.approx(1e-4)
    assert "cg_inner_iter_ms" in out and "cg_fixed_overhead_ms" in out
    assert set(out["f64_solve_race_ms"]) == {"refined_f32_window", "plain_f64_ell"}
    assert all(ms > 0 for ms in out["f64_solve_race_ms"].values())
    assert (tmp_path / "profile_large_trace.json").stat().st_size > 0
    assert out["n_vertices"] == graft._build(12, 4, "float32")[0].n_vertices_real


def test_profile_large_on_the_spectral_path():
    """What the JAX package's smoke test runs (plane n12 takes the spectral
    phi-solve): the chains run, and --cg_slope has no CG operator to time."""
    out = run_main(profile_large.main, ["--n_space", "12", "--ntime", "4", "--iters", "2",
                                        "--cg_slope", "--device", "cpu"])
    assert out["laplacian_mode"] == "spectral" and out["cg_rtol"] is None
    assert all(out[f"{name}_ms"] > 0 for name in COMPONENTS)
    assert "cg_inner_iter_ms" not in out


# ---- refine_cost_bench ------------------------------------------------------

def test_refine_cost_bench_times_every_piece_but_the_double_float_matvec():
    out = run_main(refine_cost_bench.main, ["--n_space", "12", "--ntime", "4", "--chain", "3",
                                            "--device", "cpu"])
    for key in ("matvec_hi_f64_ms", "u64_transform_ms", "deflate64_ms", "window_f32_ms",
                "ell_f32_ms"):
        assert out[key] > 0, key
    assert "matvec_df_ms" not in out  # no double-float module in the port
    # B1 (its plain version here) chained: 1 untimed + 3 timed chains of 3.
    assert out["chained_matvecs"] == 4 * 3 and out["n_vertices"] == 182
    assert out["device_event_ms"] is None and out["card"] is None


# ---- bench_matvec -----------------------------------------------------------

def test_bench_matvec_variants_match_reference_ell_matvec():
    """The four variants, one application each to the seeded x (rng 0,
    (T+1, V)) on the generated plane n12, against the JAX package's
    `ell_matvec` of its own CG operator on the same x: within 1e-5 of
    max|y| (float32 sums in other orders)."""
    import jax.numpy as jnp

    from dots_socp_tpu.geometry.generators import generate_plane_mesh
    from dots_socp_tpu.geometry.surface import cotan_laplacian, triangle_quantities
    from dots_socp_tpu.ops.laplacian import build_cg_operator, ell_matvec
    from dots_socp_tpu.ops.mesh_ops import build_surface_ops

    variants, x0, _ = bench_matvec.build(12, 4, "float32", 0, "cpu")
    outs = bench_matvec.apply_once(variants, x0)
    assert sorted(outs) == ["ell", "graddiv", "library", "window"]

    vertices, triangles, _ = generate_plane_mesh(n=12)
    _, angles, _ = triangle_quantities(vertices, triangles)
    lap = cotan_laplacian(triangles, angles, vertices.shape[0])
    ops = build_surface_ops(vertices, triangles, dtype=jnp.float32)
    op = build_cg_operator(4, 0.25, np.asarray(ops.av), lap, dtype=jnp.float32, deflation_k=0)
    x = np.random.default_rng(0).standard_normal((5, vertices.shape[0]))
    np.testing.assert_array_equal(x0.numpy(), x.astype(np.float32))
    ref = np.asarray(ell_matvec(op, jnp.asarray(x, dtype=jnp.float32)), dtype=np.float64)
    for name, y in outs.items():
        assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max(), name


def test_bench_matvec_ends_in_the_reference_keys():
    """The JAX script's keys (`banded` skipped: the port has none; `library`
    in its place); `super_width` null and `group` 1: no super-windows."""
    out = run_main(bench_matvec.main, ["--n_space", "12", "--n_time", "4", "--iters", "3",
                                       "--skip", "banded", "--device", "cpu"])
    assert set(out["variants"]) == {"graddiv", "ell", "window", "library"}
    assert all(us > 0 for us in out["variants"].values())
    assert out["max_disagreement"] <= 1e-5 * out["max_abs_y"]
    assert out["window_width"] >= out["tile_rows"] > 0 and out["group"] == 1
    assert out["super_width"] is None and out["unit"] == "us/matvec"
    # B1's plain version: 1 untimed + 1 timed chain of 3, and one application.
    assert out["chained_matvecs"] == 2 * 3 + 1


def test_spectral_floor_holds_each_float32_solve_against_float64():
    """On the CPU the "device" is the host: its float32 answers are the
    host's bit for bit, the float64 one is the reference's own, and the
    float32 error is rounding-sized on both kinds of right-hand side; the
    same under each variant of the two long products, where float64
    products are the most accurate and the solver's are the `solver`
    variant's."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = spectral_floor.main(["--examples", "plane", "--n_space", "12", "--ntime", "7",
                                   "--pad_multiple", "1", "--rhs", "2", "--variants", "solver",
                                   "long", "block_16", "f64", "--device", "cpu"])
    row, last = (json.loads(ln) for ln in printed.getvalue().strip().splitlines())
    ones = {"gaussian": 1.0, "smooth": 1.0}
    assert last == out and out["device_over_cpu_f32"] == {"plane": ones}
    assert out["energy_device_over_cpu_f32"] == {"plane": ones}
    assert out["variants_energy_device_over_cpu"] == {
        "plane": dict.fromkeys(("solver", "long", "block_16", "f64"), ones)}
    assert set(out["energy_device_over_host_blas"]["plane"]) == {"gaussian", "smooth"}
    assert out["block_k"] == 256 and out["rows"] == {}
    assert (row["example"], row["n_time"], row["v_pad"]) == ("plane", 7, row["vertices"])
    for norm in ("rel_l2", "rel_energy"):
        for kind in ("gaussian", "smooth"):
            errors = row[norm][kind]
            assert errors["f64_device"] == 0.0
            assert 0 < errors["f32_device"] == errors["f32_cpu"] < 1e-5
            variants = {v: e[norm][kind] for v, e in row["variants"].items()}
            assert variants["solver"]["device"] == errors["f32_device"]
            assert all(0 < e["device"] == e["cpu"] < 1e-5 for e in variants.values())
            assert variants["f64"]["device"] <= min(e["device"] for e in variants.values())
    assert set(row["solve_us"]) == {"solver", "long", "block_16", "f64"}
    assert all(len(us) == 3 and min(us) > 0 for us in row["solve_us"].values())
    assert row["repeat_equal"] and not row["allow_tf32"] and row["device"] == "cpu"


def test_spectral_floor_runs_each_row_under_each_variant(monkeypatch, tmp_path):
    """--rows: one records-driver line per row and variant, the run made
    with the variant's product in `spectral_solve` and the solver's back
    after it; an unknown variant or row is refused."""
    from dots_socp_torch.ops import laplacian
    from dots_socp_torch.scripts import records

    seen = []

    def run(args, record):
        product = laplacian.blocked_matmul
        seen.append((args.examples, args.congestions, getattr(product, "keywords", product)))
        return {(args.examples[0], args.congestions[0]): {
            "iterations": 3436, "converged": True, "kkt_max": 9e-5, "cost": 0.0, "seconds": 1.0,
            "it_per_s": 3436.0}}

    monkeypatch.setitem(records.RECORDS, "R1", records.RECORDS["R1"]._replace(run=run))
    out = run_main(spectral_floor.main, [
        "--examples", "--rows", "knots_3@0.00", "--row_variants", "long", "block_64",
        "--outdir", str(tmp_path), "--device", "cpu"])
    assert seen == [(["knots_3"], ["0.00"], spectral_floor._long_matmul),
                    (["knots_3"], ["0.00"], {"block": 64})]
    assert laplacian.blocked_matmul.__name__ == "blocked_matmul"
    long = out["rows"]["knots_3@0.00"]["long"]
    assert set(out["rows"]["knots_3@0.00"]) == {"long", "block_64"}
    assert (long["iterations"], long["converged"], long["kkt_max"]) == (3436, True, 9e-5)
    assert long["agrees"] is False  # the cost of 0.0 is not the record's
    with pytest.raises(SystemExit):
        spectral_floor.main(["--examples", "--variants", "block_x", "--device", "cpu"])
    with pytest.raises(ValueError, match="not a row of R1"):
        spectral_floor.main(["--examples", "--rows", "knots_3@0.02", "--device", "cpu"])


# ---- every driver: the card or an error -----------------------------------

DRIVERS = {
    "bench": ["--n_space", "12", "--large_n_space", "12", "--ntime", "4"],
    "scripts.bench_large": ["--n_space", "12", "--n_time", "4"],
    "scripts.profile_large": ["--n_space", "12", "--ntime", "4"],
    "scripts.refine_cost_bench": ["--n_space", "12", "--ntime", "4"],
    "scripts.bench_matvec": ["--n_space", "12", "--n_time", "4"],
    "scripts.steady_state_configs": ["--configs", "smoke"],
    "scripts.records": ["--only", "R3"],
    "scripts.spectral_floor": ["--examples", "plane", "--n_space", "12", "--ntime", "4"],
}


@pytest.mark.parametrize("module", list(DRIVERS))
def test_driver_asked_for_the_card_without_one_raises(module):
    """--device defaults to cuda; without a card every driver raises (through
    `ops.resolve_device`) instead of measuring the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    main = importlib.import_module(f"dots_socp_torch.{module}").main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(DRIVERS[module])


# ---- measure_protocol.sh ----------------------------------------------------

def test_protocol_script_parses():
    subprocess.run(["bash", "-n", str(PROTOCOL)], check=True, timeout=60)


def protocol_commands():
    """(module, argv) of every `python -m` command in the script, its
    continuation lines joined, its redirections dropped, $DEVICE and $OUT
    given values."""
    text = PROTOCOL.read_text().replace("\\\n", " ")
    text = text.replace('"$DEVICE"', "cpu").replace('"$OUT', '"out')
    commands = []
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if "python" not in words:
            continue
        words = words[words.index("python"):]
        assert words[1] == "-m", line
        argv = []
        for word in words[3:]:
            if word.startswith((">", "2>")):
                break
            argv.append(word)
        commands.append((words[2], argv))
    return commands


class Parsed(Exception):
    pass


def test_protocol_commands_name_port_modules_whose_parsers_accept_them(monkeypatch):
    """Every command runs a module of the port (none of the JAX package), in
    the five steps of scripts/measure_protocol.sh, and the module's own
    parser accepts every flag it is given (parsing stops the module there)."""
    commands = protocol_commands()
    modules = [m for m, _ in commands]
    assert modules == [
        "dots_socp_torch.replication.main", "dots_socp_torch.replication.main",
        "dots_socp_torch.scripts.bench_large", "dots_socp_torch.scripts.bench_large",
        "dots_socp_torch.replication.main_versus_exact", "dots_socp_torch.replication.sweep",
    ]
    parse_args = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        raise Parsed(parse_args(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_then_stop)
    for module, argv in commands:
        assert "--device=cpu" in argv or argv[argv.index("--device") + 1] == "cpu"
        with pytest.raises(Parsed) as parsed:
            importlib.import_module(module).main(argv)
        assert vars(parsed.value.args[0])["device"] == "cpu", module


def test_the_port_keeps_cupti_up_between_profiler_sessions():
    """Importing the port sets Kineto's TEARDOWN_CUPTI to "0" where it was
    unset, and keeps a value the caller set."""
    import subprocess
    import sys

    code = "import os, dots_socp_torch; print(os.environ['TEARDOWN_CUPTI'])"
    for given, expected in ((None, "0"), ("1", "1")):
        env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        if given is not None:
            env["TEARDOWN_CUPTI"] = given
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, check=True, cwd=Path(__file__).resolve().parents[1])
        assert out.stdout.strip() == expected


def test_profiler_loss_needs_a_card(monkeypatch):
    """`scripts/profiler_loss.py` refuses to run without a card."""
    import torch

    from dots_socp_torch.scripts import profiler_loss

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        profiler_loss.main(["--sessions", "1"])
