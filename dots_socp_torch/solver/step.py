"""The iALM iteration and the chunked loops (counterpart of
`dots_socp_tpu/solver/step.py`).

One call to `iteration` is the whole per-iteration hot loop:

  step 1a  phi   <- space-time Laplacian solve of the dual residual RHS
  step 1b  z     <- batched SOC projection (uses the pre-step-2 A, B)
  step 2   q     <- closed-form diagonal solve for (A, B, lambda_c)
  step 3   duals <- multiplier ascent with step tau

`run_chunk` is a Python loop over `iteration` where the reference has one
jitted `lax.fori_loop` (`dots_socp_tpu/solver/step.py:173-179`). On one
device it runs over static buffers (`ops.graphs`), so that on the card an
iteration is one CUDA graph replay on the spectral path, and on the CG path
a few: the parts before and after the phi solve, and the CG's own segments
between them, whose host reads (one per block of inner iterations, one per
refinement pass) are the iteration's only syncs. On a mesh, and inside
`graphs.eager()`, every op is launched from the host.
`run_chunk_adaptive` keeps the reference's packed-record output, so the host
loop in `socp.py` reads it unchanged; its validations run on the host
(one KKT-table transfer each) with the device's decisions and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from dots_socp_torch.ops import graphs
from dots_socp_torch.ops.cones import project_soc
from dots_socp_torch.ops.laplacian import cg_solve, spectral_solve
from dots_socp_torch.ops.mesh_ops import div_space, grad_space
from dots_socp_torch.ops.time_stencils import (
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
    a1 = sz * (1.0 + state.congestion * state.r)
    a2 = 1.0 + 2.0 * sz * a1

    memo_a = dt_phi + state.mu
    memo_b = decouple_space_adjoint(state.z_mid + state.beta_mid, sz, mesh)

    A = (1.0 / a2) * memo_a + (a1 / a2) * (
        state.z_end + state.beta_end - state.z_fst - state.beta_fst
    )
    # Diagonal of the B system: 1 + 2 sz^2 on interior time slices,
    # 1 + sz^2 at the endpoints (each endpoint slice has one cone copy).
    interior = 1.0 + 2.0 * sz * sz
    endpoint = 1.0 + sz * sz
    diag_b = torch.cat(
        [endpoint[None], interior.expand(config.n_time - 1), endpoint[None]]
    )
    B = (dx_phi + state.E + memo_b) / diag_b[:, None, None]
    cr = state.congestion * state.r
    lambda_c = (cr / (1.0 + cr)) * (memo_a - A)
    return A, B, lambda_c


def _palm_step(config: ProblemConfig, data: ProblemData, state: SolverState):
    """PALM's step 0 (the q/lambda solve on the last gradients); the state
    as it is otherwise."""
    if not config.is_palm:
        return state
    A, B, lambda_c = solve_q_lambda(config, state, state.dt_phi, state.dx_phi, data.mesh)
    return state._replace(A=A, B=B, lambda_c=lambda_c)


def _after_phi(config: ProblemConfig, data: ProblemData, state: SolverState, phi):
    """Steps 1b, 2 and 3 of the iteration, given its phi."""
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


def iteration(config: ProblemConfig, data: ProblemData, state: SolverState):
    """One full iALM iteration; returns the new state."""
    state = _palm_step(config, data, state)
    phi = solve_laplacian(config, data, state)
    return _after_phi(config, data, state, phi)


class _GraphedIteration:
    """`iteration` on one device over the static buffers of a
    `graphs.Workspace`, which hold the state between iterations: the
    spectral path is one segment; the CG path is the segment before the
    phi solve (PALM's step 0 and the right-hand side), `cg_solve`'s own
    segments (into the buffer `phi_next`), and the segment after it. A
    state comes in and goes out as a copy, so no caller keeps an alias of a
    buffer that a later replay overwrites."""

    def __init__(self, config: ProblemConfig, data: ProblemData, state: SolverState):
        self.config, self.data = config, data
        self.ws = graphs.Workspace(state.phi.device)

    def load(self, state: SolverState):
        for name, value in zip(SolverState._fields, state):
            self.ws.load(name, value)

    def state(self) -> SolverState:
        return SolverState(*(self.ws.bufs[name].clone() for name in SolverState._fields))

    def step(self, data: ProblemData):
        """One iteration; `data` carries the CG's current inner tolerance."""
        config, ws = self.config, self.ws
        if config.laplacian_mode == "spectral":
            ws.run("iteration", lambda b: iteration(config, self.data, _state_of(b))._asdict())
            return
        ws.run("before", self._before)
        ws.load("phi_next", _cg_phi(config, data, ws.bufs["rhs"], ws.bufs["phi"]))
        ws.run("after", lambda b: _after_phi(config, self.data, _state_of(b), b["phi_next"])._asdict())

    def _before(self, bufs):
        state = _palm_step(self.config, self.data, _state_of(bufs))
        rhs = laplacian_rhs(self.config, self.data, state)
        return {"rhs": rhs, "A": state.A, "B": state.B, "lambda_c": state.lambda_c}


def _state_of(bufs) -> SolverState:
    return SolverState(*(bufs[name] for name in SolverState._fields))


#: Called after every iteration when set (None: nothing is called). The
#: interface's bounded profiler trace counts iterations through it.
AFTER_ITERATION = None


def run_chunk(config: ProblemConfig, data: ProblemData, state: SolverState, n):
    """Run `n` iterations: on one device over the static buffers of a cached
    `_GraphedIteration` (CUDA graphs on the card), the state copied in and
    out; on a mesh or inside `graphs.eager()`, `iteration` by iteration."""
    runner = None
    if data.mesh is None and graphs.enabled():
        cg_op = data.cg_op._replace(rtol=None) if data.cg_op is not None else None
        key = ("iteration", config, tuple((t.shape, t.dtype, t.device) for t in state))
        runner = graphs.cached(key, lambda: _GraphedIteration(config, data, state),
                               graphs.leaves(data._replace(cg_op=cg_op)))
        runner.load(state)
    for _ in range(int(n)):
        if runner is None:
            state = iteration(config, data, state)
        else:
            runner.step(data)
        if AFTER_ITERATION is not None:
            AFTER_ITERATION()
    return state if runner is None else runner.state()


def run_chunk_kkt(config: ProblemConfig, data: ProblemData, state: SolverState, n):
    """`run_chunk` followed by the (7, 2) KKT table (a device tensor)."""
    state = run_chunk(config, data, state, n)
    return state, kkt_table(config, data, state)


# sigma-schedule constants (must match `schedule.SigmaSchedule`).
_ADJ_LOS = (0, 20, 50, 100, 200, 500)
_ADJ_HIS = (20, 50, 100, 200, 500, 1 << 30)
_ADJ_GAPS = (3, 7, 11, 17, 31, 43)
_GAP_FACTORS_ASC = (  # ascending thresholds; last satisfied wins
    (1.2, 1.10), (1.5, 1.20), (2.0, 1.26), (2.5, 1.28), (3.0, 1.32),
    (5.0, 1.35), (10.0, 1.40), (20.0, 1.60), (35.0, 1.75), (50.0, 2.00),
)
_SIGMA_LOWER, _SIGMA_UPPER = 1e-3, 1e3

#: Packed layout of one per-check record in `run_chunk_adaptive` output.
ADAPTIVE_REC_SIZE = 17  # [it_offset, adjusted, sigma_factor, table(7x2)]
ADAPTIVE_HEADER = 4  # [n_checks, it_total, last_adjust_it, is_org_kkt]

_STOP_IDX = [0, 2, 4, 5]
_PRIM_POS = [0, 1]
_DUAL_POS = [2, 3]


def _next_adjust(it: int, last_adjust: int) -> int:
    """Smallest absolute iteration a >= it with a - last_adjust >= gap(a)
    (mirror of `SigmaSchedule.next_adjust_iteration`)."""
    best = 1 << 30
    for lo, hi, gap in zip(_ADJ_LOS, _ADJ_HIS, _ADJ_GAPS):
        cand = max(lo, it, last_adjust + gap)
        if cand < hi:
            best = min(best, cand)
    return best


def _nanmax(values, npd):
    finite = values[~np.isnan(values)]
    return finite.max() if finite.size else npd(np.nan)


def _sigma_factor(sigma, gap, npd):
    """Applied multiplicative sigma factor in the work dtype (mirror of
    `SigmaSchedule.updated_sigma`, incl. the [1e-3, 1e3] safeguard)."""
    one = npd(1.0)
    g = one / gap if gap < one else gap
    fac = one
    for threshold, f in _GAP_FACTORS_ASC:
        if g > npd(threshold):
            fac = npd(f)
    if gap < one:
        fac = one / fac
    new_sigma = np.clip(sigma * fac, npd(_SIGMA_LOWER), npd(_SIGMA_UPPER))
    return new_sigma / sigma


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

    The semantics of the reference's device-resident segment
    (`dots_socp_tpu/solver/step.py:221-382`): the adaptive KKT cadence
    (interval 1 at tolerance, 37 beyond 10x away, log-linear between), the
    sigma cadence and gap lookup with safeguards, the org/scaled column
    switch once the scaled errors are below 5 tol, the sticky sigma freeze,
    and the early exit at a tolerance checkpoint or convergence. Each
    validation copies the (7, 2) table to the host and decides there, in
    the config's dtype.

    aux = [last_adjust_it, is_org_kkt (0/1), tol, next_checkpoint,
    sigma_freeze]. Returns (state, packed) with packed a numpy array
      [n_checks, it_total, last_adjust_it, is_org_kkt,
       rec_0 ... rec_{max_checks-1}],
    rec = [it_offset (1-based), adjusted (0/1), sigma_factor, table.ravel()].
    """
    min_int, max_int = 1, 37  # AdaptiveKKTCadence defaults
    npd = config.np_dtype
    aux = np.asarray(aux, dtype=npd)
    it0, k_bound, j_next = int(it0), int(k_bound), int(j_first)
    last_adjust = int(aux[0])
    is_org = bool(aux[1] > 0.5)
    tol, next_checkpoint, sigma_freeze = aux[2], aux[3], aux[4]
    recs = np.full((max_checks, ADAPTIVE_REC_SIZE), np.nan, dtype=npd)

    def next_interval(err):
        # Parity with AdaptiveKKTCadence.set_error_and_tolerance.
        if not np.isfinite(err):
            return max_int
        ratio = err / np.maximum(tol, npd(1e-10))
        if ratio <= 1.0:
            return min_int
        log_ratio = np.log10(ratio)
        if log_ratio > 1.0:
            return max_int
        return max(min_int, int(min_int + log_ratio * (max_int - min_int)))

    n = it_total = 0
    frozen = done = False
    while not done and it_total < k_bound and n < max_checks:
        it_cur = it0 + it_total
        na = _next_adjust(it_cur, last_adjust)
        j = min(j_next, k_bound - it_total, max(na - it_cur + 1, 1))
        state = run_chunk(config, data, state, j)
        it_total += j
        a = it0 + it_total - 1  # absolute index of the just-finished iteration

        table = kkt_table(config, data, state).cpu().numpy().astype(npd)
        org, scaled = table[:, 0], table[:, 1]
        with np.errstate(invalid="ignore"):
            err = _nanmax(org[_STOP_IDX], npd)
            passed = bool(np.all(org < tol))
            done = passed or bool(err <= next_checkpoint)
            # org/scaled switch precedes the sigma update (host order).
            is_org = is_org or bool(_nanmax(scaled, npd) < 5 * tol)
            # Sticky tail freeze, latched before the factor at this validation.
            frozen = frozen or bool(err < sigma_freeze)

        adjust_now = a == na and not passed
        col = org if is_org else scaled
        prim_error = _nanmax(col[_PRIM_POS], npd)
        dual_error = _nanmax(col[_DUAL_POS], npd)
        gap_ok = bool(np.isfinite(prim_error) and np.isfinite(dual_error) and dual_error > 0)
        factor = npd(1.0)
        if adjust_now and gap_ok and not frozen:
            sigma = npd(state.r.item())
            factor = _sigma_factor(sigma, prim_error / dual_error, npd)
        if factor != 1.0:
            state = apply_penalty_factor(state, factor)
        if adjust_now:
            last_adjust = a

        recs[n, :3] = (it_total, float(adjust_now), factor)
        recs[n, 3:] = table.ravel()
        n += 1
        j_next = next_interval(err)

    header = np.asarray([n, it_total, last_adjust, float(is_org)], dtype=npd)
    return state, np.concatenate([header, recs.ravel()])
