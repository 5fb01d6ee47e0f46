"""Kernel K4 (`dots_socp_torch/ops/cg_step.py`: one latched inner CG
iteration after the matvec, fused) on the CPU, where `cg_step` runs its
plain version: the plain version against the torch route
(`_CGSystem.gated_step`, the body of `_BlockedCG._block`) on seeded and
settled states with frozen rows, a den <= 0 row, the null row and padding
slots; the latch; whole single-device solves driven through it against the
JAX package's `cg_solve` (its window kernel in interpret mode); the wrapper's
input contract and its refusal without a card; and the graph counts a solve
makes (`ops.graphs.STATS`) and `profile_slice`'s launch-site table. The
kernel itself runs on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 19)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from test_torch_graphs import PATH_IDS, PATHS, X_TOL, _jax_solve, problems  # noqa: F401
from torch.autograd import DeviceType

import chip_smoke
from dots_socp_torch import cli
from dots_socp_torch.ops import cg_step as k4
from dots_socp_torch.ops import graphs
from dots_socp_torch.ops import laplacian as tl
from dots_socp_torch.profile_slice import launch_sites
from dots_socp_torch.scripts.common import settled_cg_state
from dots_socp_torch.solver import solver_socp
from torch_rank_worker import one_thread

NAMES = ("x", "r", "p", "rz", "rr", "it", "live")
# cg_step_plain against the torch route: float32 rounding (they run the same
# ops in the same order on the CPU, so in fact bit for bit).
STEP_RTOL = 1e-5
FROZEN_ROW, BREAKDOWN_ROW = 1, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def _seeded_state(p, seed, inner=3):
    """A path's CG system and an inner PCG state from a seeded right-hand
    side, `inner` torch-route iterations in, then changed: row FROZEN_ROW
    frozen (its threshold above its residual), row BREAKDOWN_ROW with p = 0
    (den = 0); the null row is the last."""
    cg = tl._CGSystem(p["tops"], p["top"], torch.from_numpy(p["rhs"]).dtype)
    rhs = torch.from_numpy(np.random.default_rng(seed).standard_normal(p["rhs"].shape))
    b = cg.deflate(rhs.to(cg.work))
    x, r, z, rz, rr = cg.pcg_start(b, torch.zeros_like(b))
    thresh = cg.row_thresh(b, torch.tensor(1e-12, dtype=b.dtype))
    state = (x, r, z, rz, rr, torch.zeros((), dtype=torch.int64), torch.ones((), dtype=torch.bool))
    for _ in range(inner):
        state = cg.gated_step(*state, thresh, 600)
    state = dict(zip(NAMES, state), thresh=thresh)
    state["thresh"] = thresh.clone()
    state["thresh"][FROZEN_ROW] = 2 * state["rr"][FROZEN_ROW]
    state["p"] = state["p"].clone()
    state["p"][BREAKDOWN_ROW] = 0.0
    return cg, state


def _padded_state():
    """Plane n12 padded to 192 slots (10 padding slots), settled
    (`settled_cg_state`, the state phase 19 uses on the card), changed as
    `_seeded_state` changes it."""
    cg, st = settled_cg_state(12, 5, "cpu", settle=2, inner=3, pad_multiple=64)
    assert float(cg.real_w.sum()) < cg.real_w.numel() and float(cg.null_w[-1]) == 1.0
    st["thresh"][FROZEN_ROW] = 2 * st["rr"][FROZEN_ROW]
    st["p"][BREAKDOWN_ROW] = 0.0
    return cg, st


def _both(cg, st, max_iters=600):
    """(torch route's outputs, cg_step_plain's) from the same state."""
    ref = cg.gated_step(*(st[k] for k in NAMES), st["thresh"], max_iters)
    ins = tuple(st[k].clone() for k in NAMES)
    lap = cg.lap(ins[2])
    out = k4.cg_step_plain(lap, *ins, st["thresh"], max_iters, cg.leaves)
    assert all(a is b for a, b in zip(out, ins))  # in place
    return ref, out


def _assert_close(ref, out):
    for name, a, b in zip(NAMES, ref, out):
        if a.is_floating_point():
            scale = float(a.abs().max()) or 1.0
            assert float((a - b).abs().max()) <= STEP_RTOL * scale, name
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("refine, window", PATHS, ids=PATH_IDS)
def test_plain_step_equals_the_torch_route(problems, refine, window):  # noqa: F811
    """cg_step_plain equals one `gated_step` (pcg_step with `_block`'s
    gating) to float32 rounding on seeded states of every path, the
    frozen row and the den = 0 row holding still (x and p kept) while the
    others step, the null row re-deflated to mean zero."""
    for seed in (0, 1):
        cg, st = _seeded_state(problems[refine, window], seed)
        ref, out = _both(cg, st)
        _assert_close(ref, out)
        x, p = out[0], out[2]
        for row in (FROZEN_ROW, BREAKDOWN_ROW):
            assert torch.equal(x[row], st["x"][row]) and torch.equal(p[row], st["p"][row])
        assert not torch.equal(x[0], st["x"][0])
        null = out[1][-1]
        assert abs(float(null.sum())) <= 1e-6 * float(null.abs().sum())


def test_plain_step_equals_the_torch_route_with_padding_slots():
    """The same on plane n12's settled refined state with padding slots:
    the null row's padding slots stay zero."""
    cg, st = _padded_state()
    ref, out = _both(cg, st)
    _assert_close(ref, out)
    pad = cg.real_w == 0
    assert bool(pad.any()) and float(out[1][-1][pad].abs().max()) == 0.0


@pytest.mark.parametrize("refine, window", PATHS, ids=PATH_IDS)
def test_plain_step_with_live_false_is_a_no_op(problems, refine, window):  # noqa: F811
    """With live false every output keeps its bits; with the iteration
    limit reached the step runs and then drops the latch."""
    cg, st = _seeded_state(problems[refine, window], 0)
    ins = tuple(st[k].clone() for k in NAMES)
    ins[6].fill_(False)
    kept = [t.clone() for t in ins]
    k4.cg_step_plain(cg.lap(ins[2]), *ins, st["thresh"], 600, cg.leaves)
    assert all(torch.equal(a, b) for a, b in zip(ins, kept))
    ref, out = _both(cg, st, max_iters=int(st["it"]) + 1)
    _assert_close(ref, out)
    assert int(out[5]) == int(st["it"]) + 1 and not bool(out[6])


def test_plain_step_trace_names_every_stage():
    """The trace holds each stage's values under the names the kernel's
    wrapper copies them to (phase 19 compares the two by name)."""
    cg, st = _padded_state()
    trace = {}
    ins = tuple(st[k].clone() for k in NAMES)
    k4.cg_step_plain(cg.lap(ins[2]), *ins, st["thresh"], 600, cg.leaves, trace=trace)
    assert set(trace) == {"den", "alpha", "step", "x", "r1", "mean", "r", "sr", "coef", "g",
                          "z", "rr", "rz", "beta", "p", "it", "live"}
    assert trace["step"].flatten().tolist()[FROZEN_ROW:BREAKDOWN_ROW + 1] == [False, False]
    assert torch.equal(trace["p"], ins[2]) and torch.equal(trace["x"], ins[0])


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "host_loop"])
@pytest.mark.parametrize("refine, window", PATHS, ids=PATH_IDS)
def test_solve_through_the_plain_step_matches_reference(problems, monkeypatch,  # noqa: F811
                                                        refine, window, blocked):
    """A whole single-device cg_solve whose inner iterations go through
    `cg_step` (on the CPU its plain version), refined and unrefined, with
    and without the window operator, in the latched blocks and in the host
    loop: the JAX package's inner iteration count exactly, x within X_TOL;
    K4's route counted in `fused_steps`, no kernel launched."""
    monkeypatch.setattr(tl, "_fused_route", lambda cg, device: True)
    p = problems[refine, window]
    ref, ref_iters = _jax_solve(p, (refine, window), 600)
    tl.CG_COUNTERS.reset()
    launches = k4.KERNEL_LAUNCHES
    with graphs.eager() if not blocked else graphs.uncaptured():
        x, iters = tl.cg_solve(p["tops"], p["top"], torch.from_numpy(p["rhs"]),
                               x0=torch.from_numpy(p["x0"]), max_iters=600, rtol=p["rtol"],
                               return_iters=True)
    graphs.release()
    assert iters == ref_iters > 0
    diff = x.numpy() - ref
    assert np.abs(diff - diff.mean()).max() < X_TOL[refine or window]
    assert tl.CG_COUNTERS.fused_steps >= iters and k4.KERNEL_LAUNCHES == launches


def test_fused_route_is_taken_on_one_card_only(problems):  # noqa: F811
    """`_fused_route`: the card, no mesh, float32 work with the window
    SpMV, outside `torch_route()`; the CPU keeps the torch route."""
    top = problems[True, True]
    cg = tl._CGSystem(top["tops"], top["top"], torch.float64)
    cuda = torch.device("cuda")
    assert cg.use_window and tl._fused_route(cg, cuda) and not cg.fused
    with k4.torch_route():
        assert not k4.enabled() and not tl._fused_route(cg, cuda)
    assert k4.enabled()
    ell = tl._CGSystem(problems[True, False]["tops"], problems[True, False]["top"], torch.float64)
    f64 = tl._CGSystem(problems[False, False]["tops"], problems[False, False]["top"],
                       torch.float64)
    assert not tl._fused_route(ell, cuda) and not tl._fused_route(f64, cuda)


def test_cg_step_checks_its_inputs_and_needs_a_card():
    """The kernel's contract, checked before any launch: float32,
    contiguous, the state's shapes; on a device that is neither the CPU nor
    CUDA `cg_step` raises, and without a card its CUDA launcher raises."""
    cg, st = _padded_state()
    ins = tuple(st[k].clone() for k in NAMES)
    lap = cg.lap(ins[2])
    assert k4._check(lap, *ins, st["thresh"], cg.leaves) == (6, 192, cg.leaves.defl_q.shape[1])
    with pytest.raises(TypeError, match="float32"):
        k4._check(lap.double(), *ins, st["thresh"], cg.leaves)
    with pytest.raises(ValueError, match="contiguous"):
        k4._check(lap, ins[0].t().contiguous().t(), *ins[1:], st["thresh"], cg.leaves)
    with pytest.raises(ValueError, match="live"):
        k4._check(lap, *ins[:6], torch.ones(()), st["thresh"], cg.leaves)
    meta = tuple(t.to("meta") for t in ins)
    with pytest.raises(ValueError, match="unsupported device"):
        k4.cg_step(lap.to("meta"), *meta, st["thresh"].to("meta"), 600, cg.leaves)
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        k4._cg_step_cuda(lap, *ins, st["thresh"], 600, cg.leaves, None)


def test_chip_smoke_cg_step_phase_needs_a_card(capsys):
    """`chip_smoke.py --phase cg_step` fails at the device phase without a
    card, and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chip_smoke.main(["--phase", "cg_step"])
    assert capsys.readouterr().out == ""


def test_repeated_solves_count_their_graph_cache_misses():
    """`graphs.STATS`: each solve of plane n13 on the CG path misses the
    graph cache for its iteration and its CG (the solve releases both at
    its end), the second as often as the first; on the CPU nothing is
    captured."""
    geometry = cli.load_geometry("plane", 13)
    counts = []
    for _ in range(2):
        before = graphs.STATS.snapshot()
        solver_socp(4, geometry, nit=12, tol=1e-12, laplacian_mode="cg", precision="float32",
                    device="cpu", time_limit=600)
        counts.append(graphs.STATS.since(before))
    assert counts[0] == counts[1]
    assert counts[0]["cache_misses"] >= 2 and counts[0]["captures"] == 0
    assert counts[0]["capture_seconds"] == 0.0


def test_launch_sites_name_the_line_of_each_kernel():
    """`profile_slice.launch_sites`: a kernel launched under a torch call
    of ops/laplacian.py is charged to that line (the profiler range its
    `_LaunchSites` opened), one launched through ctypes to "ctypes"; per
    call over the calls profiled."""
    def cpu(name, parent=None, kernels=()):
        return SimpleNamespace(name=name, device_type=DeviceType.CPU, cpu_parent=parent,
                               kernels=list(kernels))

    def cuda(name, us):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               time_range=SimpleNamespace(elapsed_us=lambda: us))

    kernel = SimpleNamespace(name="elementwise_kernel", device=0, duration=4.0)
    site = cpu("laplacian.py:804")
    events = [site, cpu("aten::mul", site, [kernel]), cpu("aten::add", None, [kernel]),
              cuda("elementwise_kernel", 4.0), cuda("elementwise_kernel", 4.0),
              cuda("window_spmv_kernel", 10.0), cuda("cg_step_kernel", 6.0),
              cuda("laplacian.py:804", 9.0)]  # the range's own span on the device
    rows = launch_sites(events, 2)
    by = {(r["site"], r["kernel"]): (r["us"], r["launches"]) for r in rows}
    assert by == {("laplacian.py:804", "elementwise_kernel"): (2.0, 0.5),
                  ("other", "elementwise_kernel"): (2.0, 0.5),
                  ("ctypes", "window_spmv_kernel"): (5.0, 0.5),
                  ("ctypes", "cg_step_kernel"): (3.0, 0.5)}


@pytest.mark.parametrize("rows, n, expect", [
    # plane n200 at 32 and 128 modes: one block of 32 x 16 per row
    (32, 46_431, (32, 16, 1, 1, 32, 0, 0, 512, 1, 1)),
    (128, 46_431, (32, 16, 1, 1, 32, 0, 0, 512, 1, 1)),
    # plane n410: rows split over 17 blocks, summed by the last to finish
    (32, 194_814, (32, 16, 1, 1, 32, 512, 0, 8704, 1, 17)),
    # short rows: the warps take a row each; below 128 no 4-wide loads
    (8, 700, (64, 8, 1, 1, 0, 0, 1, 64, 8, 1)),
    (8, 64, (64, 8, 0, 1, 0, 0, 1, 64, 8, 1)),
], ids=["n200", "n200-128modes", "n410", "short", "unvectorized"])
def test_row_sum_config_is_pytorchs(rows, n, expect):
    """The geometry K4 sums its rows in: PyTorch's `setReduceConfig` for a
    float32 sum over the last axis on an H100 (132 SMs of 2,048 threads),
    worked by hand from ATen/native/cuda/Reduce.cuh."""
    assert k4.row_sum_config(rows, n, 132, 2048) == expect


@pytest.mark.parametrize("lost_sessions, expect", [(0, [1.0, 2.0, 3.0]), (2, [1.0, 2.0, 3.0]),
                                                   (3, None)])
def test_launch_times_retry_a_session_that_lost_events(monkeypatch, lost_sessions, expect):
    """`kernel_timing.launch_times_us` (phase 19's time per stage): each of
    a call's launches in launch order, the mean over the calls; a session
    whose profiler lost an event is made again, and after three such
    sessions the stages are not measured (None) rather than misassigned."""
    import torch.profiler

    from dots_socp_torch import kernel_timing

    sessions = []

    class Profile:
        def __init__(self, **kw):
            sessions.append(self)
            self.calls = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def events(self):
            lost = len(sessions) <= lost_sessions
            out = []
            for c in range(self.calls):
                for i, us in enumerate((1.0, 2.0, 3.0)):
                    if lost and c == 1 and i == 0:
                        continue
                    span = SimpleNamespace(start=10 * c + i, elapsed_us=lambda us=us: us)
                    out.append(SimpleNamespace(device_type=DeviceType.CUDA,
                                               name=f"cg_step_{i % 2}", time_range=span))
            return out

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", Profile)

    def fn():
        if sessions:
            sessions[-1].calls += 1

    assert kernel_timing.launch_times_us(fn, "cg_step_", 3, reps=4) == expect
    assert len(sessions) == min(lost_sessions + 1, 3)
