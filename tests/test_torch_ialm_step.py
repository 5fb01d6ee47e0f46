"""Kernel K6's route on the CPU: the gate that keeps the torch route where
the kernel cannot run (the CPU, `graphs.eager()`, a halo or a mesh,
`ialm_step.torch_route()`, arrays it does not take), the `iteration` and
`after` segments declared `in_place` against the host iteration, and the
counters that stay at 0 here. The kernel itself runs on the card only
(tests/test_torch_cuda.py, `-k ialm`)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from dots_socp_torch import cli
from dots_socp_torch.kernel_timing import ialm_step_bound
from dots_socp_torch.ops import graphs
from dots_socp_torch.ops import ialm_step as k6
from dots_socp_torch.solver import solver_socp
from dots_socp_torch.solver import step as t_step
from dots_socp_torch.solver.problem import build_problem, initial_state
from torch_rank_worker import one_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def _problem(mode, precision="float32", n=9, T=4):
    geometry = cli.load_geometry("plane", n)
    config, data, extras = build_problem(T, geometry, laplacian_mode=mode, dtype=precision,
                                         cg_rtol=1e-4, device="cpu")
    return config, data, initial_state(config, data, extras)


@pytest.fixture(scope="module")
def cg_problem():
    return _problem("cg")


def _gate(config, data, device="cuda"):
    return t_step._fused_route(config, data, device)


@pytest.mark.parametrize("case", ["card", "cpu", "halo", "time_mesh", "torch_route",
                                  "wide_table", "leaves_in_another_dtype"])
def test_the_gate_takes_the_torch_route_where_the_kernel_cannot_run(cg_problem, case):
    """On a (nominal) card with one device the gate takes K6; on the CPU,
    with a halo (a space-sharded problem), on a mesh (a time-sharded one),
    inside `torch_route()` and on arrays the kernel does not take it keeps
    the torch route."""
    config, data, _ = cg_problem
    expect = case == "card"
    if case == "cpu":
        assert _gate(config, data, "cpu") is expect
        return
    if case == "halo":
        config = dataclasses.replace(config, mesh_axes=(1, 2))
        data = data._replace(halo=object(), mesh=object())
        assert config.spmd_kwargs(data)
    elif case == "time_mesh":
        data = data._replace(mesh=object())
    elif case == "wide_table":
        wide = torch.zeros((data.ops.inc_table.shape[0], k6.MAX_DEGREE + 1), dtype=torch.int64)
        data = data._replace(ops=data.ops._replace(inc_table=wide))
    elif case == "leaves_in_another_dtype":
        config = dataclasses.replace(config, dtype="float64")
    if case == "torch_route":
        with k6.torch_route():
            assert _gate(config, data) is expect
        assert k6.enabled()
    else:
        assert _gate(config, data) is expect


def test_eager_runs_the_host_iteration_on_the_torch_route(cg_problem, monkeypatch):
    """Inside `graphs.eager()` the iterations run from the host
    (`_HostIteration`), which never takes K6, even where the gate would."""
    config, data, state = cg_problem
    monkeypatch.setattr(t_step, "_fused_route", lambda *a: True)
    with graphs.eager():
        runner = t_step._runner(config, data, state)
    assert isinstance(runner, t_step._HostIteration) and not hasattr(runner, "fused")
    runner = t_step._runner(config, data, state)
    assert runner.fused and {"iteration", "after"} <= runner.ws.in_place
    graphs.release()


@pytest.mark.parametrize("fused", [False, True], ids=["torch_route", "in_place"])
@pytest.mark.parametrize("mode, precision", [("cg", "float32"), ("spectral", "float32"),
                                             ("cg", "float64")])
def test_in_place_segments_equal_the_host_iteration(mode, precision, fused, monkeypatch):
    """The `iteration` (spectral) and `after` (CG) segments, declared
    `in_place`, give the host iteration's state bit for bit over chunks of
    iterations, on the torch route and on the fused one (on the CPU the
    torch route's values written into the buffers in place, as K6 writes
    them on the card): the buffers keep their identity and only the fused
    route counts its steps."""
    config, data, state = _problem(mode, precision)
    monkeypatch.setattr(t_step, "_fused_route", lambda *a: fused)
    steps = graphs.counters()["step.fused_steps"]
    launches = k6.KERNEL_LAUNCHES
    first = t_step.run_chunk(config, data, state, 3)
    runner = next(obj for obj, _ in graphs._CACHE.values()
                  if isinstance(obj, t_step._GraphedIteration))
    ids = {name: id(t) for name, t in runner.ws.bufs.items()}
    second = t_step.run_chunk(config, data, first, 4)
    assert {name: id(t) for name, t in runner.ws.bufs.items()} == ids
    with graphs.eager():
        e_first = t_step.run_chunk(config, data, state, 3)
        e_second = t_step.run_chunk(config, data, e_first, 4)
    for got, want in ((first, e_first), (second, e_second)):
        for name, a, b in zip(got._fields, got, want):
            assert torch.equal(a, b), name
    assert graphs.counters()["step.fused_steps"] - steps == (7 if fused else 0)
    assert k6.KERNEL_LAUNCHES == launches  # no kernel on the CPU
    graphs.release()


@pytest.mark.parametrize("mode", ["cg", "spectral"])
def test_fused_steps_stay_at_zero_in_a_cpu_solve(mode):
    """A whole solve on the CPU takes the torch route: `step.fused_steps`
    and `ialm_step.launches` do not move, and both are in the counters the
    tracer differences."""
    geometry = cli.load_geometry("plane", 9)
    before = graphs.counters()
    solver_socp(4, geometry, nit=12, tol=1e-12, precision="float32", laplacian_mode=mode,
                device="cpu", time_limit=600)
    after = graphs.counters()
    for name in ("step.fused_steps", "ialm_step.launches"):
        assert after[name] == before[name], name


def test_the_kernel_refuses_the_cpu_and_arrays_it_does_not_take(cg_problem):
    """`ialm_step` raises on CPU tensors, and `supports` refuses float64
    work with float32 phi, leaves in another dtype and a wide table."""
    config, data, state = cg_problem
    scal = torch.zeros(len(k6.SCALARS))
    with pytest.raises(ValueError, match="card"):
        k6.ialm_step(data.ops, state, state.phi, scal, config.stepsize_time)
    f32, f64 = torch.float32, torch.float64
    ops = data.ops
    assert k6.supports(ops, f32, f32) and k6.supports(ops, f32, f64)
    assert not k6.supports(ops, f64, f32) and not k6.supports(ops, f64, f64)
    ops64 = ops._replace(**{name: getattr(ops, name).to(f64)
                            for name in ("grad_basis", "inc_mask", "diag_soc")})
    assert k6.supports(ops64, f64, f64)
    wide = types.SimpleNamespace(**ops._asdict())
    wide.inc_table = torch.zeros((4, k6.MAX_DEGREE + 1), dtype=torch.int64)
    assert not k6.supports(wide, f32, f32)


@pytest.mark.parametrize("dt", [1.0 / 31, 1.0 / 7, 0.1, 1.0 / 127, 1.0 / 15])
def test_inv_dt_is_the_double_reciprocal_rounded_to_phis_precision(dt):
    """1 / dt as PyTorch takes it for a division of a CUDA tensor by a
    Python number: the reciprocal in double, rounded to phi's precision
    (at dt = 1/7 and 1/15 not the reciprocal of dt rounded first)."""
    assert k6.inv_dt(dt, torch.float64) == 1.0 / dt
    r32 = k6.inv_dt(dt, torch.float32)
    assert r32 == float(np.float32(1.0 / dt)) and np.float32(r32) == r32
    if round(1.0 / dt) in (7, 15):
        assert r32 != float(np.float32(1.0) / np.float32(dt))


@pytest.mark.parametrize("mode, precision", [("spectral", "float32"), ("cg", "float32"),
                                             ("cg", "float64")])
def test_the_bound_moves_each_array_of_the_step_once(mode, precision):
    """`ialm_step_bound`'s bytes are the step's arrays, each once: the 13
    it writes, beta_mid, B, E, A, mu, beta_fst and beta_end read, phi and
    the five operator leaves it reads."""
    config, data, state = _problem(mode, precision)
    read = ("beta_mid", "B", "E", "A", "mu", "beta_fst", "beta_end", "phi")
    leaves = ("tri", "grad_basis", "inc_table", "inc_mask", "diag_soc")
    n_bytes = (sum(getattr(state, k).nbytes for k in k6.OUTPUTS + read)
               + sum(getattr(data.ops, k).nbytes for k in leaves))
    T, V = state.A.shape
    F, D = data.ops.tri.shape[0], data.ops.inc_table.shape[-1]
    bound = ialm_step_bound(T, V, F, D, state.A.element_size(), state.phi.element_size())
    assert bound["bytes"] == n_bytes and bound["by"] == "bytes"
    assert bound["reads_twice_bytes"] == n_bytes + state.beta_mid.nbytes
