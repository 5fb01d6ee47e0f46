"""One rank's shard of a problem and a state (counterpart of
`dots_socp_tpu/parallel/mesh.py`).

The JAX package hands whole arrays to `jax.device_put` with NamedShardings
over its ("time", "space") mesh. The port runs one process per (time,
space) shard: `shard_problem` / `shard_state` keep this rank's block of
every field the reference shards (`problem_shardings` / `state_shardings`,
`parallel/mesh.py:47-187`), keep the replicated fields whole, and move them
to the mesh's device. `gather_field` is the inverse, on every rank.

Layout on a (Tm, S) mesh, this process being shard (t, s):
  vertex fields (..., V)        -> (..., v_chunk)   block s
  triangle fields (F, ...)      -> (f_chunk, ...)   block s
  state (T+1, F, 3), (T, 2, F, 3, 3) -> their F block
  staggered state fields (T, ...) -> also block t of T / Tm time slices;
                   the centered (T+1, ...) fields keep every slice on every
                   time-rank (T and T+1 cannot both divide the axis)
  operators: cut over space only, the same on every time-rank
  spectral factor: s (V,) and the rows of q (V, V) -> block rank; u_time
                   and invfac (T+1, V: eigen-indices, not vertices) whole
  scalars, time operators, shifts, tolerances -> replicated
"""

from __future__ import annotations

from dots_socp_torch.ops.collectives import space_all_gather, time_all_gather
from dots_socp_torch.ops.sharded_window import shard_of

# SolverState fields by the axis that holds F (the rest hold V last, or are
# 0-d scalars).
_STATE_F_AXIS = {"B": 1, "E": 1, "dx_phi": 1, "z_mid": 2, "beta_mid": 2}
# The staggered (T, ...) fields, cut over the mesh's time axis as well (JAX
# `state_shardings`); the centered (T+1, ...) fields are not.
STAGGERED_FIELDS = frozenset(
    ("A", "lambda_c", "z_fst", "z_mid", "z_end", "mu", "beta_fst", "beta_mid", "beta_end", "dt_phi")
)


def _block(n_total, mesh):
    chunk = n_total // mesh.space
    return slice(mesh.rank * chunk, (mesh.rank + 1) * chunk)


def _take(x, axis, n_total, mesh):
    """This rank's block of `x` along `axis` (a contiguous copy on the
    mesh's device)."""
    idx = [slice(None)] * x.dim()
    idx[axis] = _block(n_total, mesh)
    return x[tuple(idx)].contiguous().to(mesh.device)


def _shard_ops(ops, v, f, mesh):
    if ops is None:
        return None
    return ops._replace(
        tri=_take(ops.tri, 0, f, mesh),
        grad_basis=_take(ops.grad_basis, 0, f, mesh),
        area_f=_take(ops.area_f, 0, f, mesh),
        av=_take(ops.av, 0, v, mesh),
        inc_table=_take(ops.inc_table, 0, v, mesh),
        inc_mask=_take(ops.inc_mask, 0, v, mesh),
        diag_soc=_take(ops.diag_soc, 0, f, mesh),
    )


def shard_problem(mesh, data):
    """This rank's shard of a problem built with space_partitions =
    mesh.space (`solver.problem.build_problem`), on mesh.device. Operators
    are cut over space only: on one space shard (a `Tx1` mesh) the problem
    stays whole, as built on mesh.device, and only learns its mesh."""
    if mesh.space == 1:
        return data._replace(mesh=mesh)
    if data.halo is None:
        raise ValueError("shard_problem needs a blocked problem (space_partitions > 1)")
    v, f = data.ops.av.shape[0], data.ops.area_f.shape[0]
    rep = lambda x: None if x is None else x.to(mesh.device)
    spectral = data.spectral
    if spectral is not None:
        # The contraction over q's rows is local per shard, then summed
        # (`ops.laplacian.spectral_solve`); JAX also cuts invfac by columns,
        # which the all-reduced coefficients here do not need.
        spectral = spectral._replace(
            u_time=rep(spectral.u_time),
            s=_take(spectral.s, 0, v, mesh),
            q=_take(spectral.q, 0, v, mesh),
            invfac=rep(spectral.invfac),
        )
    h = data.halo
    halo = type(h)(
        vtx_export=h.vtx_export[mesh.rank].to(mesh.device),
        tri_local=_take(h.tri_local, 0, f, mesh),
        slot_export=h.slot_export[mesh.rank].to(mesh.device),
        inc_local=_take(h.inc_local, 0, v, mesh),
    )
    cg = data.cg_op
    if cg is not None:
        if cg.window is not None:
            raise ValueError("a sharded problem carries the per-shard window, not B1's")
        sw = cg.swindow
        if sw is not None:
            sw = shard_of(sw, mesh.rank, mesh.device)
        opt = lambda x, axis: None if x is None else _take(x, axis, v, mesh)
        cg = cg._replace(
            shifts=rep(cg.shifts),
            jacobi=_take(cg.jacobi, 1, v, mesh),
            null_row=rep(cg.null_row),
            u_time=rep(cg.u_time),
            av_unit=_take(cg.av_unit, 0, v, mesh),
            s=_take(cg.s, 0, v, mesh),
            defl_q=_take(cg.defl_q, 0, v, mesh),
            defl_winv=rep(cg.defl_winv),
            rtol=rep(cg.rtol),
            # The ELL rows index globally; a shard never runs them (its
            # matvecs are B2 or the halo form), JAX shards them by rows too.
            ell_idx=_take(cg.ell_idx, 0, v, mesh),
            ell_w=_take(cg.ell_w, 0, v, mesh),
            swindow=sw,
            ell_w_hi=opt(cg.ell_w_hi, 0),
            av_hi=opt(cg.av_hi, 0),
            shifts_hi=rep(cg.shifts_hi),
            u_time_hi=rep(cg.u_time_hi),
            real_mask=opt(cg.real_mask, 0),
        )
    consts = {n: getattr(data, n).to(mesh.device) for n in data._fields if n.startswith("c_")}
    return data._replace(
        ops=_shard_ops(data.ops, v, f, mesh),
        spectral=spectral,
        cg_op=cg,
        halo=halo,
        ops_hi=_shard_ops(data.ops_hi, v, f, mesh),
        mesh=mesh,
        **consts,
    )


def shard_state(mesh, state):
    """This rank's shard of a whole (host) SolverState, on mesh.device."""
    v, f = state.phi.shape[-1], state.B.shape[1]
    fields = {}
    for name, x in zip(state._fields, state):
        if x.dim() == 0:
            fields[name] = x.to(mesh.device)
            continue
        if name in STAGGERED_FIELDS:
            x = x[mesh.time_block(x.shape[0])]
        if name in _STATE_F_AXIS:
            fields[name] = _take(x, _STATE_F_AXIS[name], f, mesh)
        else:
            fields[name] = _take(x, x.dim() - 1, v, mesh)
    return type(state)(**fields)


def gather_field(mesh, x, name):
    """The whole of SolverState field `name` from every rank's shard `x`
    (one all-gather over space, and one over time for a staggered field;
    every rank gets it)."""
    if x.dim() == 0:
        return x
    x = space_all_gather(x, mesh, dim=_STATE_F_AXIS.get(name, x.dim() - 1))
    return time_all_gather(x, mesh) if name in STAGGERED_FIELDS else x


def gather_state(mesh, state):
    """The whole SolverState from every rank's shard, on every rank."""
    return type(state)(*(gather_field(mesh, x, n) for n, x in zip(state._fields, state)))
