"""Kernel K4 (`dots_socp_torch/ops/cg_step.py`: one latched inner CG
iteration after the matvec, fused) on the CPU, where `cg_step` runs its
plain version: the plain version against the torch route
(`_CGSystem.gated_step`, the body of `_BlockedCG._block`) on seeded and
settled states with frozen rows, a den <= 0 row, the null row and padding
slots; the latch; whole single-device solves driven through it against the
JAX package's `cg_solve` (its window kernel in interpret mode); the wrapper's
input contract and its refusal without a card; and the graph counts a solve
makes (`ops.graphs.STATS`) and `profile_slice`'s launch-site table. The
kernel itself runs on the card (tests/test_torch_cuda.py, `-k "cg_step or
k4"`)."""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies
from test_torch_graphs import PATH_IDS, PATHS, X_TOL, _jax_solve, problems  # noqa: F401
from torch.autograd import DeviceType

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
    (`settled_cg_state`, the state the card test uses at n200), changed as
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
    wrapper copies them to (the card test compares the two by name)."""
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
    """`kernel_timing.launch_times_us` (`bench_kernels`' time per stage): each of
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


# ---- the walks' split plan (`cg_step.split_plan`) ----------------------------

PLAN_SHAPES = [(32, 46_431), (128, 46_431), (32, 194_814), (8, 700), (8, 64), (32, 97_485),
               (33, 46_431), (128, 194_814)]


def _assert_plan_covers(rows, n, **kw):
    """Every (group, cta, lane row) of the geometry has one block and one
    staging slot, each block holds `lanes` lane rows of one virtual block,
    the slots and the virtual blocks' counters are distinct and lie clear of
    the other counters and of the virtual blocks' own slots."""
    red = k4.row_sum_config(rows, n, 132, 2048)
    bw, bh, ctas = red[0], red[1], red[9]
    plan = k4.split_plan(red, rows, 132, **kw)
    layout = k4.plan_layout(red, plan)
    assert len(layout) == plan.groups * ctas * bh and plan.virtual == plan.groups * ctas
    assert plan.blocks == plan.virtual * plan.parts and plan.parts * plan.lanes == bh
    assert plan.threads == plan.lanes * bw <= k4.WALK_THREADS[plan.depth]
    assert plan.threads >= min(32, bw * bh)  # whole warps
    held, count = {}, Counter(block for block, _, _ in layout.values())
    for (group, cta, y), (block, _, _) in layout.items():
        held.setdefault(block, set()).add((group, cta, y // plan.lanes))
    assert sorted(held) == list(range(plan.blocks))
    assert all(len(v) == 1 for v in held.values())
    assert set(count.values()) == {plan.lanes}
    slots = [slot for _, slot, _ in layout.values()]
    assert len(set(slots)) == len(slots)
    assert min(slots) >= 2 * plan.virtual and max(slots) < 2 * plan.virtual + plan.virtual * bh
    assert 2 * plan.virtual * (1 + bh) == plan.staging  # both sums, both levels
    counters = {}
    for (group, cta, _), (_, _, counter) in layout.items():
        counters.setdefault((group, cta), set()).add(counter)
    assert all(len(v) == 1 for v in counters.values())
    flat = sorted(c for v in counters.values() for c in v)
    assert flat == list(range(1 + plan.groups, 1 + plan.groups + plan.virtual))
    assert plan.counters == 1 + plan.groups + plan.virtual
    return plan


@pytest.mark.parametrize("rows, n", PLAN_SHAPES, ids=[f"{r}x{n}" for r, n in PLAN_SHAPES])
def test_split_plan_gives_each_lane_row_one_block_and_slot(rows, n):
    """`split_plan` on PyTorch's geometry at the main path's shapes (n200 at
    32, 33 and 128 modes, n290, n410 at 32 and 128) and the short ones: one
    block and one staging slot per (group, cta, lane row), one counter per
    virtual block; the default plan and every split it accepts."""
    plan = _assert_plan_covers(rows, n)
    red = k4.row_sum_config(rows, n, 132, 2048)
    splits = 0
    for depth in sorted(k4.WALK_THREADS):
        for lanes in (1, 2, 4, 8, 16, 32):
            try:
                _assert_plan_covers(rows, n, lanes=lanes, depth=depth)
                splits += 1
            except ValueError:
                assert (lanes > red[1] or lanes * red[0] > k4.WALK_THREADS[depth]
                        or lanes * red[0] < min(32, red[0] * red[1]))
    assert splits >= 1


@pytest.fixture(scope="module")
def hypothesis_home(tmp_path_factory):
    """Hypothesis keeps its files in a temporary directory, not the checkout."""
    from hypothesis import configuration

    configuration.set_hypothesis_home_dir(tmp_path_factory.mktemp("hypothesis"))
    yield
    configuration.set_hypothesis_home_dir(None)


@settings(max_examples=300, deadline=None, database=None)
@given(rows=strategies.integers(1, 256), n=strategies.integers(1, 300_000))
def test_split_plan_covers_every_geometry(hypothesis_home, rows, n):
    """The same for every (rows, n) with rows 1-256 and n up to 300,000."""
    _assert_plan_covers(rows, n)


def test_split_plan_rejects_splits_the_kernel_cannot_run():
    """A split that is not a power of two of whole warps within bh, or too
    wide for its depth, raises; so does a depth the kernel has no body for.
    A cluster hand-over is taken only where a row's lane rows span blocks."""
    red = k4.row_sum_config(32, 46_431, 132, 2048)
    for kw in (dict(lanes=3), dict(lanes=32), dict(lanes=16, depth=8), dict(depth=12)):
        with pytest.raises(ValueError):
            k4.split_plan(red, 32, 132, **kw)
    assert k4.split_plan(red, 32, 132, lanes=1, cluster=True).cluster
    assert not k4.split_plan(red, 32, 132, lanes=16, depth=4, cluster=True).cluster  # one block
    short = k4.row_sum_config(8, 700, 132, 2048)  # the lane rows own rows: nothing to combine
    assert not k4.split_plan(short, 8, 132, lanes=1, cluster=True).cluster
    with k4.walk_plan(lanes=4, depth=4, cluster=True):
        assert k4._PLAN == {"lanes": 4, "depth": 4, "cluster": True}
    assert k4._PLAN == {}


def _block_x(v, bw):
    """block_x_reduce over the lanes of each lane row (the last axis), as
    its lane 0 sees it: its shared-memory steps and its shuffles add lane x
    + off into lane x for x < off, off = bw / 2, ..., 1."""
    v = v.copy()
    off = bw // 2
    while off > 0:
        v[..., :off] = (v[..., :off] + v[..., off:2 * off]).astype(np.float32)
        off //= 2
    return v


def _block_y(v):
    """block_y_reduce over the lane rows (first axis), in place as its
    shared-memory tree: rows y < off add row y + off."""
    v = v.copy()
    off = v.shape[0] // 2
    while off > 0:
        v[:off] = (v[:off] + v[off:2 * off]).astype(np.float32)
        off //= 2
    return v


@pytest.mark.parametrize("bw, bh, lanes", [(32, 16, 1), (32, 16, 2), (32, 16, 4), (32, 16, 8),
                                           (64, 8, 1), (256, 2, 1), (32, 2, 1)])
def test_split_combine_is_pytorchs_block_y_order(bw, bh, lanes):
    """A float32 model of the two combine orders on random thread sums:
    PyTorch's block (block_x_reduce, then block_y_reduce over the whole
    (bh, bw) block) against the split (each block of `lanes` lane rows runs
    block_x_reduce alone and writes its lane rows' lane-0 values to their
    slots; the last block runs block_y_reduce's tree over the bh slots):
    bit-equal; a left-to-right sum of the same slots is not, on some draw."""
    rng = np.random.default_rng(bw * bh + lanes)
    differs = False
    for _ in range(50):
        sums = (rng.standard_normal((bh, bw)) * 10.0 ** rng.integers(-3, 4, (bh, bw)))
        sums = sums.astype(np.float32)
        whole = _block_y(_block_x(sums, bw))[0, 0]
        slots = np.empty(bh, dtype=np.float32)
        for part in range(bh // lanes):
            rows = slice(part * lanes, (part + 1) * lanes)
            slots[rows] = _block_x(sums[rows], bw)[:, 0]
        split = _block_y(slots[:, None])[0, 0]
        assert whole.tobytes() == split.tobytes()
        flat = np.float32(0.0)
        for value in slots:
            flat = np.float32(flat + value)
        differs = differs or flat.tobytes() != whole.tobytes()
    assert differs or bh <= 2


def test_wrapper_makes_stages_launches_in_order():
    """`run_stages`, the wrapper's launch sequence, on a stand-in library:
    STAGES launches, stages 1, 2, 3 (the null rows' mean and deflation,
    stages 3 and 4 before), the two GEMMs, then 5 and 6 with G; the
    geometry and the plan's split passed in `red`; KERNEL_LAUNCHES counts
    each; an error code raises."""
    import ctypes

    cg, st = _padded_state()
    ins = tuple(st[k].clone() for k in NAMES)
    lap = cg.lap(ins[2])
    rows, n = ins[0].shape
    red = k4.row_sum_config(rows, n)
    plan = k4.split_plan(red, rows, lanes=1, depth=4)
    calls = []

    class Lib:
        def dots_cg_step_f32(self, stage, *args):
            red_c = args[22]
            calls.append((stage, args[16] is not None, tuple(red_c[i] for i in range(13))))
            return 0

    before = k4.KERNEL_LAUNCHES
    counter = torch.zeros(plan.counters, dtype=torch.int32)
    k4.run_stages(Lib(), 0, counter, red, plan, lap, *ins, st["thresh"], 600, cg.leaves)
    assert len(calls) == k4.STAGES == len(k4.STAGE_IDS) == len(k4.STAGE_NAMES)
    assert [c[0] for c in calls] == list(k4.STAGE_IDS) == [1, 2, 3, 5, 6]
    assert [c[1] for c in calls] == [False, False, False, True, True]
    assert all(c[2] == (*red, 1, 4, 0) for c in calls)
    assert k4.KERNEL_LAUNCHES == before + k4.STAGES

    class Refused:
        def dots_cg_step_f32(self, stage, *args):
            return 1

    with pytest.raises(RuntimeError, match="stage 1"):
        k4.run_stages(Refused(), 0, counter, red, plan, lap, *ins, st["thresh"], 600, cg.leaves)
    assert ctypes  # the geometry travels as a ctypes int array


def test_k4_sweep_lists_every_split_and_needs_a_card():
    """`scripts/k4_sweep.py`: its splits at n200 are the kernel's own
    choice, then every split `split_plan` accepts, through a cluster and
    through device memory; its stage bounds name STAGE_NAMES; without a
    card it raises before timing anything."""
    from dots_socp_torch.scripts import k4_sweep

    splits = k4_sweep.plans(32, 46_431)
    assert splits[0] == (None, None, None) and len(set(splits)) == len(splits)
    red = k4.row_sum_config(32, 46_431)
    for lanes, depth, cluster in splits[1:]:
        assert k4.split_plan(red, 32, lanes=lanes, depth=depth, cluster=cluster).cluster == cluster
    assert {c for *_, c in splits[1:]} == {False, True}
    assert k4_sweep.plans(32, 46_431, default_only=True) == [(None, None, None)]
    assert list(k4_sweep.stage_bounds_us(32, 46_431)) == list(k4.STAGE_NAMES)
    lap, state, thresh, leaves = k4_sweep.random_cg_state(8, 700, "cpu", k=4)
    assert lap.shape == state[0].shape == (8, 700) and float(leaves.null[-1]) == 1.0
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        k4_sweep.main([])
