"""Correctness checks of the port's hand-written kernels on one NVIDIA GPU,
each against its plain PyTorch version or torch route on the same inputs:
what the card tests (`tests/test_torch_cuda.py`) and `chip_smoke.py`'s
`kernels` phase share. Each check raises AssertionError when it fails and
returns what it compared.

  one_kernel     -- one call is one launch of one kernel and nothing else
  b1             -- B1 / B1-f64 on plane n200's window operator
  b2             -- B2 on every shard of plane n200's blocked operator
  k4             -- K4 stage by stage against its plain version
  k4_f64_latched -- K4-f64 against the float64 torch route over a solve
  k4_every_split -- every split of K4's walks bit-equal to the plain version
  k6             -- K6, one step, against the torch route
"""

from __future__ import annotations

import numpy as np
import torch

N_TIME = 31
# B1's cases: dtype, modes (32: ntime 31; 33: two mode groups, the second
# with one live lane; 128: B1's limit), and B2's: shards, modes.
B1_CASES = tuple((dtype, lanes) for dtype in ("float32", "float64") for lanes in (32, 33, 128))
B2_CASES = ((2, 32), (4, 32), (2, 33))
# Profiler sessions `k4_every_split` may make per split: on an H100 a lossy
# session was seen to follow another, twice in a row.
PROFILE_TRIES = 10
CG_STEP_NAMES = ("x", "r", "p", "rz", "rr", "it", "live")
# K6's setups: plane n, precision (n64 float32: spectral, float32 phi; n200
# float32: CG, float64 phi; n200 float64), and its cases: congestion, scale_z.
IALM_SETUPS = ((64, "float32"), (200, "float32"), (200, "float64"))
IALM_CASES = ((0.0, 1.0), (0.05, 1.7))


def _require(ok, what):
    if not ok:
        raise AssertionError(what)


def one_kernel(fn, launches):
    """`fn` launches one kernel and nothing else (no transpose, no gather,
    no copy): one call captured in a CUDA graph is one kernel node, and the
    kernel's own counter, `launches()`, moved by one over the capture. The
    graph's nodes, not torch.profiler: on an H100 the profiler's sessions
    lose launches now and then, late in a long process."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = launches()
    with torch.cuda.graph(graph):
        fn()
    _require(launches() == before + 1, f"{launches() - before} launches counted in one call")
    libcuda = ctypes.CDLL("libcuda.so.1")
    for name in ("cuGraphGetNodes", "cuGraphNodeGetType"):
        getattr(libcuda, name).restype = ctypes.c_int
    libcuda.cuGraphGetNodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t))
    libcuda.cuGraphNodeGetType.argtypes = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int))
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    _require(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0, "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _require(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _require(libcuda.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0, "cuGraphNodeGetType")
        kinds.append(kind.value)
    _require(kinds == [0], f"graph node kinds {kinds}, not one kernel")  # CU_GRAPH_NODE_TYPE_KERNEL


def b1(dtype, lanes):
    """Kernel B1 (float32) or B1-f64 (float64) on the window operator the
    main path's `build_problem` makes for plane n200 at `lanes` modes (32;
    33: two mode groups, the second with one live lane; 128: B1's limit):
    the kernel, its plain version on the card and SciPy's float64 L @ x on
    the host (L from the operator's ELL arrays, not the window format)
    pairwise within 1e-5 (float32) or 1e-13 (float64) of max|y|, and B1-f64
    within the same of the float64 ELL gather; one call is one launch of
    the kernel and nothing else, counted in its own dtype's counter alone."""
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.kernel_timing import (ell_laplacian, f64_launches, reset_counts,
                                               window_bound)
    from dots_socp_torch.ops import laplacian as tl
    from dots_socp_torch.ops import window_spmv as tw
    from dots_socp_torch.solver.problem import build_problem

    f64 = dtype == "float64"
    config, data, _ = build_problem(lanes - 1, load_geometry("plane", 200), dtype=dtype,
                                    cg_deflation_k=0, device="cuda")
    op = data.cg_op
    wop = op.window
    _require(config.laplacian_mode == "cg" and wop.vals.dtype == getattr(torch, dtype),
             f"plane n200 at {lanes} modes did not build the {dtype} window")
    _require((op.ell_w_hi is None) == f64, "float32 refines in float64, float64 does not")
    lap = ell_laplacian(op)
    x = np.random.default_rng(lanes).standard_normal((lanes, lap.shape[0])).astype(dtype)
    xp = torch.from_numpy(np.ascontiguousarray(x[:, wop.perm.cpu().numpy()])).cuda()
    reset_counts()
    y = tw.window_matvec(wop, xp)
    torch.cuda.synchronize()
    counted = f64_launches()
    _require(counted == ((1, 0, 0, 0) if f64 else (0, 0, 1, 0)),
             f"one call counted (B1-f64, K4-f64, B1, K4) {counted}")
    iperm = wop.iperm.cpu().numpy()
    got = y.cpu().numpy().astype(np.float64)[:, iperm]
    plain = tw.window_matvec_plain(wop, xp).cpu().numpy().astype(np.float64)[:, iperm]
    ref = (lap @ x.astype(np.float64).T).T
    scale = np.abs(ref).max()
    errors = {"plain": np.abs(got - plain).max() / scale, "scipy": np.abs(got - ref).max() / scale,
              "plain_scipy": np.abs(plain - ref).max() / scale}
    if f64:
        ell = tl.ell_matvec(op, torch.from_numpy(x).cuda()).cpu().numpy()
        errors["ell"] = np.abs(got - ell).max() / scale
    tol = 1e-13 if f64 else 1e-5
    _require(all(e <= tol for e in errors.values()),
             f"B1 {dtype} at {lanes} modes: {errors} > {tol}")
    one_kernel(lambda: tw.window_matvec(wop, xp),
               lambda: tw.KERNEL_LAUNCHES_F64 if f64 else tw.KERNEL_LAUNCHES)
    v = wop.perm.shape[0]
    return {"rel_err": {k: float(e) for k, e in errors.items()}, "launches": 2,  # call, capture
            "bound_us": window_bound(wop, v, lanes, v)["ms"] * 1e3}


def b2(shards, lanes):
    """B2 on every shard of plane n200 as the main path's `build_problem`
    blocks it in `shards` space shards at `lanes` modes: on every shard the
    kernel against its plain version on the window vector, and the shards
    assembled through the inverse window permute against SciPy's float64
    L @ x on the host (L from the operator's ELL arrays), within 1e-5
    max|y|; one shard-call is one launch of the kernel and nothing else.
    The exports' all-gather is a concatenation here: this checks the
    kernel, not the collective."""
    from dots_socp_torch.cli import load_geometry
    from dots_socp_torch.kernel_timing import ell_laplacian, shard_bound, shard_inputs
    from dots_socp_torch.ops import sharded_window as tsw
    from dots_socp_torch.solver.problem import build_problem

    _, data, _ = build_problem(lanes - 1, load_geometry("plane", 200), dtype="float32",
                               space_partitions=shards, mesh_axes=(1, shards), cg_deflation_k=0,
                               device="cpu")
    _require(data.cg_op.swindow is not None and data.cg_op.ell_w_hi is not None,
             f"plane n200 in {shards} shards did not build the refined sharded window")
    lap = ell_laplacian(data.cg_op)
    x, shard_ops, xs, buf = shard_inputs(data.cg_op.swindow, shards, lanes)
    ref = (lap @ x.astype(np.float64).T).T
    scale = np.abs(ref).max()
    ys, errors, launches = [], [], 0
    for sw, xl in zip(shard_ops, xs):
        before = tsw.KERNEL_LAUNCHES
        y = tsw.shard_spmv(sw, xl, buf)
        torch.cuda.synchronize()
        _require(tsw.KERNEL_LAUNCHES == before + 1, "one shard-call is not one counted launch")
        plain = tsw.sharded_window_matvec_plain(sw, tsw.window_vector(sw, xl, buf))
        errors.append((y - plain).abs().max().item() / scale)
        ys.append(tsw.window_permute(sw, y, inverse=True).cpu().numpy())
        one_kernel(lambda: tsw.shard_spmv(sw, xl, buf), lambda: tsw.KERNEL_LAUNCHES)
        launches += 2
    assembled = np.abs(np.concatenate(ys, axis=-1) - ref).max() / scale
    _require(max(errors) <= 1e-5 and assembled <= 1e-5,
             f"B2 in {shards} shards at {lanes} modes: per shard {errors}, assembled {assembled}")
    return {"rel_err": {"plain": [float(e) for e in errors], "scipy": float(assembled)},
            "launches": launches,
            "bound_us": [shard_bound(sw, lanes, buf.shape[-1])["ms"] * 1e3 for sw in shard_ops]}


def plane_operators(n):
    """Plane n's vertices, triangles, vertex areas and cotan Laplacian."""
    from dots_socp_torch.geometry.generators import generate_plane_mesh
    from dots_socp_torch.geometry.surface import cotan_laplacian, triangle_quantities, vertex_areas

    vertices, triangles, _ = generate_plane_mesh(n=n)
    area_f, angles, _ = triangle_quantities(vertices, triangles)
    av = vertex_areas(triangles, area_f, vertices.shape[0]) / 3.0
    return vertices, triangles, av, cotan_laplacian(triangles, angles, vertices.shape[0])


def cg_step_system(n, deflation_k, T=7):
    """Plane n's refined window CG system on the card (deflation rank
    `deflation_k`, 0 for none) and an inner PCG state from a seeded
    right-hand side, 3 torch-route iterations in; with `deflation_k` None,
    the main path's own (ntime 31, its deflation rank) and its settled
    inner state (`settled_cg_state`). Row 1 frozen (its threshold above its
    residual) and row 2 at p = 0 (den = 0); the null row is the last."""
    from dots_socp_torch.ops import laplacian as tl
    from dots_socp_torch.ops import mesh_ops

    if deflation_k is None:
        from dots_socp_torch.scripts.common import settled_cg_state

        cg, state = settled_cg_state(n, N_TIME, "cuda")
        thresh = state.pop("thresh")
        _require(cg.fused and cg.use_window, "the settled CG system is not on B1 and K4")
        return cg, *_frozen_and_breakdown(state, thresh)
    vertices, triangles, av, lap = plane_operators(n)
    ops = mesh_ops.build_surface_ops(vertices, triangles, dtype=torch.float64, device="cuda")
    op = tl.build_cg_operator(T, 1.0 / T, av, lap, dtype=torch.float64, deflation_k=deflation_k,
                              refine=True, coords=vertices, device="cuda")
    cg = tl._CGSystem(ops, op, torch.float64)
    _require(cg.fused and cg.use_window and (cg.leaves.defl_q.shape[1] > 0) == (deflation_k > 0),
             f"plane n{n}'s CG system is not on B1 and K4 at deflation rank {deflation_k}")
    rhs = torch.from_numpy(np.random.default_rng(n).standard_normal((T + 1, av.shape[0])))
    b = cg.deflate(rhs.cuda().to(torch.float32))
    x, r, z, rz, rr = cg.pcg_start(b, torch.zeros_like(b))
    thresh = cg.row_thresh(b, torch.tensor(1e-12, device="cuda"))
    state = (x, r, z, rz, rr, torch.zeros((), dtype=torch.int64, device="cuda"),
             torch.ones((), dtype=torch.bool, device="cuda"))
    for _ in range(3):
        state = cg.gated_step(*state, thresh, 600)
    return cg, *_frozen_and_breakdown(dict(zip(CG_STEP_NAMES, (t.clone() for t in state))),
                                      thresh)


def _frozen_and_breakdown(state, thresh):
    thresh = thresh.clone()
    thresh[1] = 2 * state["rr"][1]
    state["p"][2] = 0.0
    return state, thresh


def k4(n, deflation_k=None):
    """K4 against its plain version on the same inputs (`cg_step_system`;
    `deflation_k` None: the main path's settled n200 state): every stage's
    outputs (the wrapper's trace) and every output within 1e-5 max|.|
    (float32 row sums in another order; the mean on the null row, where the
    kernel keeps it, against the largest term it averages), the step mask,
    it and live equal; the frozen and den = 0 rows hold still, others step;
    STAGES counted launches per call; with live false every output keeps
    its bits; two launches on the same inputs are bit-equal."""
    from dots_socp_torch.kernel_timing import cg_step_bound
    from dots_socp_torch.ops import cg_step
    from dots_socp_torch.ops import window_spmv as tw

    cg, st, thresh = cg_step_system(n, deflation_k)
    lap = tw.window_matvec(cg.wop, st["p"])

    def run(fn, **kw):
        ins = tuple(st[k].clone() for k in CG_STEP_NAMES)
        fn(lap, *ins, thresh, 600, cg.leaves, **kw)
        return ins

    before = cg_step.KERNEL_LAUNCHES
    trace_k, trace_p = {}, {}
    out_k = run(cg_step.cg_step, trace=trace_k)
    out_p = run(cg_step.cg_step_plain, trace=trace_p)
    torch.cuda.synchronize()
    launches = cg_step.KERNEL_LAUNCHES - before
    _require(launches == cg_step.STAGES, f"one call counted {launches} launches")
    errors = {}  # name: (max |kernel - plain|, its limit)
    for name, a, b in zip(CG_STEP_NAMES, out_k, out_p):
        if a.is_floating_point():
            errors[name] = (float((a - b).abs().max()), 1e-5 * float(b.abs().max()))
        else:
            _require(torch.equal(a, b), f"K4's {name} differs")
    null = torch.nonzero(cg.null_w > 0).flatten()
    for key, got in trace_k.items():
        ref = trace_p.get(key)
        if ref is None:
            continue
        scale = ref
        if key == "mean":
            got, ref, scale = got[null], ref[null], trace_p["r1"][null]
        if ref.is_floating_point():
            errors[f"stage:{key}"] = (float((got - ref).abs().max()),
                                      1e-5 * (float(scale.abs().max()) or 1.0))
        else:
            _require(torch.equal(got, ref), f"K4's stage {key} differs")
    _require(all(err <= limit for err, limit in errors.values()), f"K4 at n{n}: {errors}")
    step = trace_k["step"].flatten().tolist()
    _require(step[1:3] == [False, False] and any(step), f"K4's step mask {step}")
    for row in (1, 2):
        _require(torch.equal(out_k[0][row], st["x"][row])
                 and torch.equal(out_k[2][row], st["p"][row]), f"row {row} moved")
    _require(all(torch.equal(a, b) for a, b in zip(out_k, run(cg_step.cg_step))),
             "two launches on the same inputs differ")
    idle = tuple(st[k].clone() for k in CG_STEP_NAMES)
    idle[6].fill_(False)
    kept = [t.clone() for t in idle]
    cg_step.cg_step(lap, *idle, thresh, 600, cg.leaves)
    torch.cuda.synchronize()
    _require(all(torch.equal(a, b) for a, b in zip(idle, kept)), "live false moved the state")
    rows, v = st["x"].shape
    return {"abs_err_limit": errors, "launches": cg_step.KERNEL_LAUNCHES - before,
            "bound_us": cg_step_bound(rows, v, cg.leaves.defl_q.shape[1])["ms"] * 1e3}


def k4_f64_latched():
    """Kernel K4-f64 against the float64 torch route (`gated_step`) from
    plane n200's settled float64 phi solve, one latched iteration after
    another on the same B1-f64 matvec until the latch falls: x, r, p, rz,
    rr and it bit for bit after every iteration's step; B1-f64 launched
    once a step on each route and K4-f64 STAGES times a call, each counted
    in its float64 counter, and no float32 kernel."""
    from dots_socp_torch.kernel_timing import cg_step_bound, f64_launches, reset_counts
    from dots_socp_torch.ops import cg_step
    from dots_socp_torch.scripts.common import settled_cg_state

    cg, st = settled_cg_state(200, N_TIME, "cuda", settle=20, inner=0, rtol=1e-8, dtype="float64")
    _require(cg.work == torch.float64 and cg.use_window and cg.fused,
             "plane n200 float64 did not put its inner CG on B1-f64 and K4-f64")
    ref = tuple(st[k].clone() for k in CG_STEP_NAMES)
    ker = tuple(st[k].clone() for k in CG_STEP_NAMES)
    reset_counts()
    steps = 0
    while bool(ref[6]) and steps < 5000:
        ref = cg.gated_step(*ref, st["thresh"], 10_000)
        ker = cg.fused_step(*ker, st["thresh"], 10_000)
        steps += 1
        for name, a, b in zip(CG_STEP_NAMES, ref, ker):
            if not torch.equal(a, b):
                raise AssertionError(f"K4-f64's {name} after step {steps}: "
                                     f"{float((a.double() - b.double()).abs().max())}")
    _require(steps > 10 and not bool(ker[6]) and int(ker[5]) == steps,
             f"the latch fell after {steps} steps at it {int(ker[5])}")
    counted = f64_launches()
    _require(counted == (2 * steps, cg_step.STAGES * steps, 0, 0),
             f"{steps} steps counted (B1-f64, K4-f64, B1, K4) {counted}")
    rows, v = st["x"].shape
    return {"steps": steps, "bit_equal": True, "launches": counted[1],
            "bound_us": cg_step_bound(rows, v, cg.leaves.defl_q.shape[1], value_bytes=8)["ms"]
            * 1e3}


def k4_every_split(rows, n):
    """Every split `split_plan` accepts (lane rows per block, load depth,
    hand-over through a cluster or device memory) on a seeded random state
    of shape (rows, n): one call launches STAGES kernels of K4 (torch.
    profiler, through `launch_times_us`: a session that loses launches is
    made again, PROFILE_TRIES at most, and none records a launch that did
    not run), every stage's outputs equal the plain version's bit for bit, and
    every handshake counter is 0 after the call."""
    from dots_socp_torch.kernel_timing import launch_times_us
    from dots_socp_torch.ops import cg_step
    from dots_socp_torch.scripts import k4_sweep

    lap, state, thresh, leaves = k4_sweep.random_cg_state(rows, n, "cuda", k=16)
    trace_p = {}
    cg_step.cg_step_plain(lap, *(t.clone() for t in state), thresh, 600, leaves, trace=trace_p)
    splits = k4_sweep.plans(rows, n)
    _require(len(splits) >= 4, f"{len(splits)} splits at ({rows}, {n})")
    for split in splits:
        trace_k = {}
        with cg_step.walk_plan(*split):
            stages = launch_times_us(
                lambda: cg_step.cg_step(lap, *(t.clone() for t in state), thresh, 600, leaves,
                                        trace=trace_k), "cg_step_", cg_step.STAGES, reps=1,
                tries=PROFILE_TRIES)
        _require(stages is not None, f"split {split}: no session recorded STAGES launches")
        counter = cg_step._COUNTER[torch.device("cuda", torch.cuda.current_device())]
        _require(int(counter.abs().sum()) == 0, f"split {split}: handshake counters not 0")
        for key in (*k4_sweep.TRACE_KEYS, "mean"):
            got, ref = trace_k[key], trace_p[key]
            if key == "mean":
                got, ref = got[-1], ref[-1]
            _require(torch.equal(got, ref), f"split {split}: stage {key} differs")
    return {"splits": len(splits)}


def k6(n, precision, congestion, scale_z):
    """Kernel K6, one step after phi from a settled state: its three
    launches give every one of the 13 arrays of the torch route
    (`_after_phi`) bit for bit, written in place into the state's own
    tensors, on a state where some cones project and some do not."""
    from dots_socp_torch.kernel_timing import ialm_step_bound
    from dots_socp_torch.ops import ialm_step
    from dots_socp_torch.scripts.common import settled_ialm_state
    from dots_socp_torch.solver import step

    config, data, state, phi = settled_ialm_state(n, N_TIME, precision, "cuda", settle=15,
                                                  congestion=congestion, scale_z=scale_z)
    ref = step._after_phi(config, data, state, phi)
    ker = state._replace(**{name: getattr(state, name).clone() for name in ialm_step.OUTPUTS})
    ptrs = {name: getattr(ker, name).data_ptr() for name in ialm_step.OUTPUTS}
    before = ialm_step.KERNEL_LAUNCHES
    out = step._after_phi(config, data, ker, phi, fused=True)
    torch.cuda.synchronize()
    launches = ialm_step.KERNEL_LAUNCHES - before
    _require(launches == ialm_step.LAUNCHES and out.phi is phi, f"one step counted {launches}")
    for name in ialm_step.OUTPUTS:
        _require(getattr(out, name).data_ptr() == ptrs[name], f"K6 did not write {name} in place")
        _require(torch.equal(getattr(out, name), getattr(ref, name)), f"K6's {name} differs")
    inside = ref.z_fst == state.constant_d - state.scale_z * state.A - state.beta_fst
    projected = int(inside.numel() - inside.sum())
    _require(0 < projected < inside.numel(), f"{projected} of {inside.numel()} cones projected")
    T, V = state.A.shape
    bound = ialm_step_bound(T, V, data.ops.tri.shape[0], data.ops.inc_table.shape[-1],
                            state.A.element_size(), phi.element_size())
    return {"bit_equal": True, "launches": launches, "cones_projected": projected,
            "bound_us": bound["ms"] * 1e3}
