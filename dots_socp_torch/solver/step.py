"""The iALM iteration and the chunked loops (counterpart of
`dots_socp_tpu/solver/step.py`).

One call to `iteration` is the whole per-iteration hot loop:

  step 1a  phi   <- space-time Laplacian solve of the dual residual RHS
  step 1b  z     <- batched SOC projection (uses the pre-step-2 A, B)
  step 2   q     <- closed-form diagonal solve for (A, B, lambda_c)
  step 3   duals <- multiplier ascent with step tau

`run_chunk` is a Python loop over `iteration` where the reference has one
jitted `lax.fori_loop` (`dots_socp_tpu/solver/step.py:173-179`). It runs
over static buffers (`ops.graphs`), so that on the card an iteration is one
CUDA graph replay on the spectral path, and on the CG path a few: the parts
before and after the phi solve, and the CG's own segments between them,
whose host reads (one per block of inner iterations, one per refinement
pass) are the iteration's only syncs. On a mesh each rank runs the same
segments over its shard, the collectives inside them: CUDA graph replays
over nccl, op by op over gloo (whose collectives cannot be captured).
Inside `graphs.eager()` every op is launched from the host. On one card
steps 1b-3 are kernel K6 (`ops.ialm_step`, `_after_phi_in_place`), which
writes the state into the buffers in place, bit for bit as the torch ops
(`_after_phi`) compute it; a mesh, the CPU and `graphs.eager()` take the
torch ops.
`run_chunk_adaptive` is the reference's device-resident segment with its
packed-record output, so the host loop in `socp.py` reads it unchanged: its
validations and decisions run on the device over the same buffers (one
`validate` replay each), and the host reads one small tensor per
validation to learn how many iterations come next.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dots_socp_torch.ops import graphs
from dots_socp_torch.ops import ialm_step as k6
from dots_socp_torch.ops.cones import project_soc
from dots_socp_torch.ops.laplacian import cg_solve, spectral_solve
from dots_socp_torch.ops.mesh_ops import div_space, grad_space
from dots_socp_torch.ops.time_stencils import (
    SQRT3,
    decouple_space,
    decouple_space_adjoint,
    div_time,
    grad_time,
)
from dots_socp_torch.solver.kkt import kkt_table
from dots_socp_torch.solver.problem import ProblemConfig, ProblemData
from dots_socp_torch.solver.scaling import apply_penalty_factor
from dots_socp_torch.solver.state import SolverState


def laplacian_rhs(config: ProblemConfig, data: ProblemData, state: SolverState):
    """RHS of the phi system, incl. the proximal -eps * av * phi_prev term."""
    ops = data.ops
    dt = config.stepsize_time
    rhs_t = (state.A + state.lambda_c - state.mu) * ops.av[None, :]
    rhs_x = (state.B - state.E) * ops.area_f[None, :, None]
    rhs = div_time(dt, rhs_t, data.mesh) + div_space(ops, rhs_x, **config.spmd_kwargs(data))
    # phi may be f64 (mixed-precision refinement); the RHS stays in the
    # work dtype.
    phi_w = state.phi.to(rhs.dtype)
    return rhs - state.boundary - state.eps * ops.av[None, :] * phi_w


def solve_laplacian(config: ProblemConfig, data: ProblemData, state: SolverState):
    """Step 1a: solve the space-time Laplacian system for phi."""
    rhs = laplacian_rhs(config, data, state)
    if config.laplacian_mode == "spectral":
        return spectral_solve(data.spectral, rhs, mesh=data.mesh)
    return _cg_phi(config, data, rhs, state.phi)


def _cg_phi(config: ProblemConfig, data: ProblemData, rhs, phi):
    """The CG phi solve, warm-started at `phi`. On a mesh every rank passes
    it the mesh, so that its loops read their flags on the host (the space
    shards' arrays and halo with them)."""
    layout = config.spmd_kwargs(data) or ({"mesh": data.mesh} if data.mesh is not None else {})
    return cg_solve(
        data.ops,
        data.cg_op,
        rhs,
        x0=phi,
        max_iters=config.cg_max_iters,
        rtol=None,  # data.cg_op.rtol, adapted by the host loop
        ops_hi=data.ops_hi,
        **layout,
    )


def solve_proj_soc(config: ProblemConfig, data: ProblemData, state: SolverState):
    """Step 1b: project onto the second-order cones (uses pre-step-2 A, B)."""
    ops = data.ops
    dec_b = decouple_space(state.B, state.scale_z, data.mesh)
    to_fst = state.constant_d - state.scale_z * state.A - state.beta_fst
    to_mid = ops.diag_soc[None, None, :, :, None] * (dec_b - state.beta_mid)
    to_end = state.constant_d + state.scale_z * state.A - state.beta_end
    return project_soc(ops, to_fst, to_mid, to_end, **config.spmd_kwargs(data))


def solve_q_lambda(config: ProblemConfig, state: SolverState, dt_phi, dx_phi, mesh=None):
    """Step 2 (and PALM step 0): closed-form diagonal solve for (A, B, lambda).
    On a mesh with a time axis (`mesh`) B, like every centered array, is
    computed whole by every time-rank from the gathered cone blocks."""
    sz = state.scale_z
    a1, a2, interior, endpoint, c_lambda = _q_lambda_scalars(state)

    memo_a = dt_phi + state.mu
    memo_b = decouple_space_adjoint(state.z_mid + state.beta_mid, sz, mesh)

    A = (1.0 / a2) * memo_a + (a1 / a2) * (
        state.z_end + state.beta_end - state.z_fst - state.beta_fst
    )
    diag_b = torch.cat(
        [endpoint[None], interior.expand(config.n_time - 1), endpoint[None]]
    )
    B = (dx_phi + state.E + memo_b) / diag_b[:, None, None]
    lambda_c = c_lambda * (memo_a - A)
    return A, B, lambda_c


def _q_lambda_scalars(state: SolverState):
    """The q/lambda solve's scalars (0-d tensors): a1, a2, the diagonal of
    the B system on interior time slices (1 + 2 sz^2) and at the endpoints
    (1 + sz^2: each endpoint slice has one cone copy), and cr / (1 + cr)."""
    sz = state.scale_z
    a1 = sz * (1.0 + state.congestion * state.r)
    a2 = 1.0 + 2.0 * sz * a1
    interior = 1.0 + 2.0 * sz * sz
    endpoint = 1.0 + sz * sz
    cr = state.congestion * state.r
    return a1, a2, interior, endpoint, cr / (1.0 + cr)


def _palm_step(config: ProblemConfig, data: ProblemData, state: SolverState):
    """PALM's step 0 (the q/lambda solve on the last gradients); the state
    as it is otherwise."""
    if not config.is_palm:
        return state
    A, B, lambda_c = solve_q_lambda(config, state, state.dt_phi, state.dx_phi, data.mesh)
    return state._replace(A=A, B=B, lambda_c=lambda_c)


def _after_phi(config: ProblemConfig, data: ProblemData, state: SolverState, phi, fused=False):
    """Steps 1b, 2 and 3 of the iteration, given its phi; `fused`: through
    kernel K6, which writes the new values into the state's own tensors
    (`_after_phi_in_place`)."""
    if fused:
        return _after_phi_in_place(config, data, state, phi)
    # Step 1b shares the pre-update state with the Laplacian solve.
    z_fst, z_mid, z_end = solve_proj_soc(config, data, state)

    # Step 2. With refinement phi is f64; its gradients are taken in f64
    # then rounded to the work dtype.
    wd = config.torch_dtype
    dt_phi = grad_time(config.stepsize_time, phi, data.mesh).to(wd)
    dx_phi = grad_space(data.ops, phi, **config.spmd_kwargs(data)).to(wd)
    state_z = state._replace(z_fst=z_fst, z_mid=z_mid, z_end=z_end)
    A, B, lambda_c = solve_q_lambda(config, state_z, dt_phi, dx_phi, data.mesh)

    # Step 3: multiplier ascent
    tau = state.tau
    sz = state.scale_z
    dec_b = decouple_space(B, sz, data.mesh)
    mu = state.mu + tau * (dt_phi - A - lambda_c)
    E = state.E + tau * (dx_phi - B)
    beta_fst = state.beta_fst + tau * (z_fst + sz * A - state.constant_d)
    beta_mid = state.beta_mid + tau * (z_mid - dec_b)
    beta_end = state.beta_end + tau * (z_end - sz * A - state.constant_d)

    return state._replace(
        phi=phi,
        A=A,
        B=B,
        lambda_c=lambda_c,
        z_fst=z_fst,
        z_mid=z_mid,
        z_end=z_end,
        mu=mu,
        E=E,
        beta_fst=beta_fst,
        beta_mid=beta_mid,
        beta_end=beta_end,
        dt_phi=dt_phi,
        dx_phi=dx_phi,
    )


def _after_phi_in_place(config: ProblemConfig, data: ProblemData, state: SolverState, phi):
    """`_after_phi` through kernel K6 (`ops.ialm_step`): the same values,
    written into the state's own tensors (a workspace's buffers), which the
    returned state holds, with `phi`. The scalar factors are the torch
    route's own ops. On CPU tensors, where there is no kernel, the torch
    route's values are copied in (the CPU tests of the plumbing)."""
    if phi.device.type == "cpu":
        new = _after_phi(config, data, state, phi)
        for name in k6.OUTPUTS:
            getattr(state, name).copy_(getattr(new, name))
        return state._replace(phi=phi)
    sz = state.scale_z
    a1, a2, interior, endpoint, c_lambda = _q_lambda_scalars(state)
    scal = torch.stack([sz, sz / SQRT3, state.tau, state.constant_d, 1.0 / a2, a1 / a2,
                        interior, endpoint, c_lambda])
    k6.ialm_step(data.ops, state, phi.contiguous(), scal, config.stepsize_time)
    return state._replace(phi=phi)


def _fused_route(config: ProblemConfig, data: ProblemData, device) -> bool:
    """Whether `_GraphedIteration` takes the step after phi through kernel
    K6: on the card, one device (no mesh, no halo), arrays the kernel takes
    (`ialm_step.supports`), outside `ialm_step.torch_route()`. Elsewhere,
    and in `_HostIteration` (inside `graphs.eager()`), the torch route."""
    return (torch.device(device).type == "cuda" and data.mesh is None
            and not config.spmd_kwargs(data) and k6.enabled()
            and k6.supports(data.ops, config.torch_dtype, config.phi_dtype))


def iteration(config: ProblemConfig, data: ProblemData, state: SolverState, fused=False):
    """One full iALM iteration; returns the new state (`fused`: the step
    after phi through kernel K6, in place into `state`'s tensors)."""
    state = _palm_step(config, data, state)
    phi = solve_laplacian(config, data, state)
    return _after_phi(config, data, state, phi, fused)


class _GraphedIteration:
    """`iteration` over the static buffers of a `graphs.Workspace` (one
    device, or this rank's shard of a mesh), which hold the state between
    iterations: the
    spectral path is one segment; the CG path is the segment before the
    phi solve (PALM's step 0 and the right-hand side), `cg_solve`'s own
    segments (into the buffer `phi_next`), and the segment after it. The
    KKT table (`table`) and a validation of the adaptive segment
    (`validate`) are segments over the same buffers. A state comes in and
    goes out as a copy, so no caller keeps an alias of a buffer that a
    later replay overwrites. On one card the step after phi is kernel K6
    (`fused`, `_fused_route`), which writes the state's buffers in place:
    the `iteration` and `after` segments are declared `in_place` (their
    capture's warm-up runs on copies of the buffers)."""

    def __init__(self, config: ProblemConfig, data: ProblemData, state: SolverState):
        self.config, self.data = config, data
        mesh = data.mesh
        self.fused = _fused_route(config, data, state.phi.device)
        self.ws = graphs.Workspace(state.phi.device, in_place=("iteration", "after"), mesh=mesh,
                                   group=None if mesh is None else mesh.world_group)
        self.bufs = self.ws.bufs

    def load(self, state: SolverState):
        for name, value in zip(SolverState._fields, state):
            self.ws.load(name, value)

    def load_segment(self, values: dict):
        """The adaptive segment's scalars and records, copied to the card;
        records of another shape (another `max_checks`) drop the captured
        validation with the old buffer."""
        recs = self.bufs.get("recs")
        if recs is not None and recs.shape != values["recs"].shape:
            self.ws.drop("validate", "recs")
        for name, value in values.items():
            self.ws.load(name, value.to(self.ws.device))

    def state(self) -> SolverState:
        return SolverState(*(self.bufs[name].clone() for name in SolverState._fields))

    def run(self, name, fn):
        self.ws.run(name, fn)

    def step(self, data: ProblemData):
        """One iteration; `data` carries the CG's current inner tolerance."""
        global FUSED_STEPS
        config, ws, fused = self.config, self.ws, self.fused
        if config.laplacian_mode == "spectral":
            ws.run("iteration",
                   lambda b: iteration(config, self.data, _state_of(b), fused)._asdict())
        else:
            ws.run("before", self._before)
            ws.load("phi_next", _cg_phi(config, data, ws.bufs["rhs"], ws.bufs["phi"]))
            ws.run("after", lambda b: _after_phi(config, self.data, _state_of(b), b["phi_next"],
                                                 fused)._asdict())
        if fused:
            FUSED_STEPS += 1

    def _before(self, bufs):
        state = _palm_step(self.config, self.data, _state_of(bufs))
        rhs = laplacian_rhs(self.config, self.data, state)
        return {"rhs": rhs, "A": state.A, "B": state.B, "lambda_c": state.lambda_c}


class _HostIteration:
    """`_GraphedIteration`'s interface over a plain dict, every op launched
    from the host: inside `graphs.eager()`, the loops as PyTorch runs them
    without graphs (the reference the graphed loops are held to)."""

    def __init__(self, config: ProblemConfig):
        self.config = config
        self.bufs: dict = {}

    def load(self, state: SolverState):
        self.bufs.update(state._asdict())

    def load_segment(self, values: dict):
        self.bufs.update({k: v.to(self.bufs["r"].device) for k, v in values.items()})

    def state(self) -> SolverState:
        return _state_of(self.bufs)

    def run(self, name, fn):
        self.bufs.update(fn(self.bufs))

    def step(self, data: ProblemData):
        self.bufs.update(iteration(self.config, data, _state_of(self.bufs))._asdict())


def _state_of(bufs) -> SolverState:
    return SolverState(*(bufs[name] for name in SolverState._fields))


#: Called after every iteration when set (None: nothing is called). The
#: interface's bounded profiler trace counts iterations through it.
AFTER_ITERATION = None

#: Iterations in this process whose step after phi ran kernel K6 (one per
#: `_GraphedIteration.step` on the fused route, counted where the host runs
#: the segment: a capture's warm-up is no iteration), in `graphs.counters()`.
FUSED_STEPS = 0


def _set_fused_steps(n):
    global FUSED_STEPS
    FUSED_STEPS = n


graphs.register_counter(lambda: FUSED_STEPS, _set_fused_steps, "step.fused_steps")


def _runner(config: ProblemConfig, data: ProblemData, state: SolverState):
    """The cached `_GraphedIteration` of this problem (on one device or this
    rank's shard), else (inside `graphs.eager()`) a `_HostIteration`;
    `state` loaded."""
    if not graphs.enabled():
        runner = _HostIteration(config)
    else:
        cg_op = data.cg_op._replace(rtol=None) if data.cg_op is not None else None
        key = ("iteration", config, tuple((t.shape, t.dtype, t.device) for t in state),
               graphs.mesh_key(data.mesh), k6.enabled())
        runner = graphs.cached(key, lambda: _GraphedIteration(config, data, state),
                               graphs.leaves(data._replace(cg_op=cg_op)))
    runner.load(state)
    return runner


def _iterate(runner, data: ProblemData, n):
    for _ in range(int(n)):
        runner.step(data)
        if AFTER_ITERATION is not None:
            AFTER_ITERATION()


def run_chunk(config: ProblemConfig, data: ProblemData, state: SolverState, n):
    """Run `n` iterations over the static buffers of a cached
    `_GraphedIteration` (CUDA graphs on the card, over nccl on a mesh), the
    state copied in and out; inside `graphs.eager()`, `iteration` by
    iteration from the host."""
    runner = _runner(config, data, state)
    _iterate(runner, data, n)
    return runner.state()


def run_chunk_kkt(config: ProblemConfig, data: ProblemData, state: SolverState, n):
    """`run_chunk` followed by the (7, 2) KKT table (a device tensor), one
    more segment over the same buffers (JAX `step.py:385-400`)."""
    runner = _runner(config, data, state)
    _iterate(runner, data, n)
    runner.run("table", lambda b: {"table": kkt_table(config, data, _state_of(b))})
    return runner.state(), runner.bufs["table"].clone()


# sigma-schedule constants (must match `schedule.SigmaSchedule`).
_ADJ_LOS = (0, 20, 50, 100, 200, 500)
_ADJ_HIS = (20, 50, 100, 200, 500, 1 << 30)
_ADJ_GAPS = (3, 7, 11, 17, 31, 43)
_GAP_FACTORS_ASC = (  # ascending thresholds; last satisfied wins
    (1.2, 1.10), (1.5, 1.20), (2.0, 1.26), (2.5, 1.28), (3.0, 1.32),
    (5.0, 1.35), (10.0, 1.40), (20.0, 1.60), (35.0, 1.75), (50.0, 2.00),
)
_SIGMA_LOWER, _SIGMA_UPPER = 1e-3, 1e3
_MIN_INTERVAL, _MAX_INTERVAL = 1, 37  # AdaptiveKKTCadence defaults
_ONE_OVER_LN10 = 0.4342944819032518

#: Packed layout of one per-check record in `run_chunk_adaptive` output.
ADAPTIVE_REC_SIZE = 17  # [it_offset, adjusted, sigma_factor, table(7x2)]
ADAPTIVE_HEADER = 4  # [n_checks, it_total, last_adjust_it, is_org_kkt]

_STOP_IDX = (0, 2, 4, 5)


@functools.lru_cache(maxsize=None)
def _adjust_tables(device):
    """`_ADJ_LOS`, `_ADJ_HIS`, `_ADJ_GAPS` as int32 tensors on `device`,
    made once (outside any capture: the first validation runs warm-up)."""
    return tuple(torch.tensor(t, dtype=torch.int32, device=device)
                 for t in (_ADJ_LOS, _ADJ_HIS, _ADJ_GAPS))


def _device_next_adjust(it, last_adjust):
    """Smallest absolute iteration a >= it with a - last_adjust >= gap(a),
    int32 (JAX `step.py:197-205`; `SigmaSchedule.next_adjust_iteration`)."""
    los, his, gaps = _adjust_tables(it.device)
    cand = torch.maximum(torch.maximum(los, it), last_adjust + gaps)
    return torch.where(cand < his, cand, 1 << 30).amin()


def _device_sigma_factor(sigma, prim_dual_gap):
    """Applied multiplicative sigma factor in sigma's dtype (JAX
    `step.py:208-217`; `SigmaSchedule.updated_sigma`, incl. the [1e-3, 1e3]
    safeguard)."""
    g = torch.where(prim_dual_gap < 1.0, 1.0 / prim_dual_gap, prim_dual_gap)
    fac = torch.ones_like(sigma)
    for threshold, f in _GAP_FACTORS_ASC:
        fac = torch.where(g > threshold, f, fac)
    fac = torch.where(prim_dual_gap < 1.0, 1.0 / fac, fac)
    new_sigma = torch.clamp(sigma * fac, _SIGMA_LOWER, _SIGMA_UPPER)
    return new_sigma / sigma


def next_interval(err, tol):
    """Iterations to the next validation, int32 (JAX `step.py:285-294`;
    `AdaptiveKKTCadence.set_error_and_tolerance`)."""
    ratio = err / torch.clamp(tol, min=1e-10)
    # log10 as `jnp.log10` computes it, log(x) * (1 / ln 10) in the dtype:
    # torch.log10 (the C library's) differs from it by an ulp at the
    # interval's boundaries 10^(k/36), and the truncation below by one.
    log_ratio = torch.log(ratio) * _ONE_OVER_LN10
    lin = (_MIN_INTERVAL + log_ratio * (_MAX_INTERVAL - _MIN_INTERVAL)).to(torch.int32)
    iv = torch.where(log_ratio > 1.0, _MAX_INTERVAL, torch.clamp(lin, min=_MIN_INTERVAL))
    iv = torch.where(ratio <= 1.0, _MIN_INTERVAL, iv)
    return torch.where(torch.isfinite(err), iv, _MAX_INTERVAL).to(torch.int32)


def _nanmax(x):
    """The largest entry that is not NaN; NaN when every entry is."""
    nan = torch.isnan(x)
    return torch.where(nan.all(), math.nan, torch.where(nan, -math.inf, x).amax())


def _plan(b, max_checks):
    """The next stride of the segment: `na` (the next sigma adjustment), `j`
    (iterations before the next validation, JAX `step.py:302-306`) and the
    host's `flags` [live, j, n, it_total, last_adjust, is_org], `live` the
    while-loop's condition (`:296-298`)."""
    it_cur = b["it0"] + b["it_total"]
    na = _device_next_adjust(it_cur, b["last_adjust"])
    j = torch.minimum(torch.minimum(b["j_next"], b["k_bound"] - b["it_total"]),
                      torch.clamp(na - it_cur + 1, min=1))
    live = ~b["done"] & (b["it_total"] < b["k_bound"]) & (b["n"] < max_checks)
    flags = torch.stack([live.to(torch.int32), j, b["n"], b["it_total"], b["last_adjust"],
                         b["is_org"].to(torch.int32)])
    return {"na": na, "j": j, "flags": flags}


def _validate(config: ProblemConfig, data: ProblemData, b, max_checks):
    """One validation after the stride of `j` iterations (the body of JAX
    `step.py:310-365` after its fori_loop): the KKT table, the decisions,
    the sigma factor applied to the state, the record into row `n` of
    `recs`, and the next stride's plan. Every value a 0-d tensor on the
    state's device: nothing is read on the host."""
    dtype = config.torch_dtype
    it_total = b["it_total"] + b["j"]
    a = b["it0"] + it_total - 1  # absolute index of the just-finished iteration
    state = _state_of(b)
    tol = b["tol"]

    table = kkt_table(config, data, state)
    org, scaled = table[:, 0], table[:, 1]
    err = _nanmax(torch.stack([org[i] for i in _STOP_IDX]))
    passed = (org < tol).all()
    done = passed | (err <= b["next_checkpoint"])
    # org/scaled switch precedes the sigma update (host order).
    is_org = b["is_org"] | (_nanmax(scaled) < 5 * tol)
    # Sticky tail freeze, latched before the factor at this validation.
    frozen = b["frozen"] | (err < b["sigma_freeze"])

    adjust_now = (a == b["na"]) & ~passed
    col = torch.where(is_org, org, scaled)
    prim_error, dual_error = _nanmax(col[0:2]), _nanmax(col[2:4])
    gap_ok = torch.isfinite(prim_error) & torch.isfinite(dual_error) & (dual_error > 0)
    gap = torch.where(gap_ok, prim_error / torch.where(dual_error > 0, dual_error, 1.0), 1.0)
    factor = torch.where(adjust_now & gap_ok & ~frozen,
                         _device_sigma_factor(state.r, gap), 1.0).to(dtype)
    state = apply_penalty_factor(state, factor)

    rec = torch.cat([torch.stack([it_total.to(dtype), adjust_now.to(dtype), factor]),
                     table.reshape(-1).to(dtype)])
    out = dict(
        state._asdict(),
        table=table,
        recs=b["recs"].index_copy(0, b["n"].reshape(1).long(), rec[None]),
        n=b["n"] + 1,
        it_total=it_total,
        j_next=next_interval(err, tol),
        last_adjust=torch.where(adjust_now, a, b["last_adjust"]),
        is_org=is_org,
        frozen=frozen,
        done=done,
    )
    return {**out, **_plan({**b, **out}, max_checks)}


def segment_scalars(config: ProblemConfig, it0, k_bound, j_first, aux, max_checks):
    """The segment's scalars and empty records on the host (JAX
    `step.py:275-283, 367-370`), its first stride planned by the same code
    as every later one; `load_segment` copies them to the device once."""
    dtype = config.torch_dtype
    aux = torch.as_tensor(np.asarray(aux))

    def i32(v):
        return torch.tensor(int(v), dtype=torch.int32)

    scalars = dict(
        it0=i32(it0), k_bound=i32(k_bound), j_next=i32(j_first), it_total=i32(0), n=i32(0),
        last_adjust=aux[0].to(torch.int32), is_org=aux[1] > 0.5,
        frozen=torch.tensor(False), done=torch.tensor(False),
        tol=aux[2].to(dtype), next_checkpoint=aux[3].to(dtype), sigma_freeze=aux[4].to(dtype),
        recs=torch.full((max_checks, ADAPTIVE_REC_SIZE), math.nan, dtype=dtype),
    )
    return {**scalars, **_plan(scalars, max_checks)}


def run_chunk_adaptive(
    config: ProblemConfig,
    data: ProblemData,
    state: SolverState,
    it0,
    k_bound,
    j_first,
    aux,
    max_checks: int = 64,
):
    """Solver segment: iterations, adaptive-cadence KKT validations and sigma
    updates, up to `k_bound` iterations or `max_checks` validations.

    The reference's device-resident segment (`dots_socp_tpu/solver/step.py:
    220-382`): the adaptive KKT cadence (interval 1 at tolerance, 37 beyond
    10x away, log-linear between), the sigma cadence and gap lookup with
    safeguards, the org/scaled column switch once the scaled errors are
    below 5 tol, the sticky sigma freeze, and the early exit at a tolerance
    checkpoint or convergence, all decided on the device in the config's
    dtype (`_validate`). The state stays in the `_GraphedIteration`'s
    buffers for the whole segment (loaded once, cloned out once); each
    validation is one `validate` replay, after which the host reads
    `flags` (one small copy) to know how many iteration replays come next;
    the records are read once at the end. On a mesh the flags are computed
    from world rank 0's table (`kkt_table`'s broadcast, inside `validate`),
    so every rank reads the same. Over gloo, and inside `graphs.eager()`,
    the same code runs op by op.

    aux = [last_adjust_it, is_org_kkt (0/1), tol, next_checkpoint,
    sigma_freeze]. Returns (state, packed) with packed a numpy array
      [n_checks, it_total, last_adjust_it, is_org_kkt,
       rec_0 ... rec_{max_checks-1}],
    rec = [it_offset (1-based), adjusted (0/1), sigma_factor, table.ravel()].
    """
    scalars = segment_scalars(config, it0, k_bound, j_first, aux, max_checks)
    flags = scalars["flags"].tolist()
    runner = _runner(config, data, state)
    runner.load_segment(scalars)
    while flags[0]:
        _iterate(runner, data, flags[1])
        runner.run("validate", lambda b: _validate(config, data, b, max_checks))
        flags = graphs.read(runner.bufs["flags"]).tolist()
    recs = graphs.read(runner.bufs["recs"]).numpy()
    header = np.asarray(flags[2:], dtype=recs.dtype)
    return runner.state(), np.concatenate([header, recs.ravel()])
