"""Explicit collectives over the mesh's "space" and "time" axes.

The JAX package gets every cross-shard movement of its sharded solve from
GSPMD (`dots_socp_tpu/parallel/mesh.py:12-14`): the weighted norms, the KKT
table, the CG dot products and the thin deflation GEMMs all reduce over the
vertex or triangle axis, the time stencils cross between the time-sharded
(T, ...) arrays and the time-replicated (T+1, ...) arrays, and jit inserts
the psums and all-gathers. The port runs one process per (time, space)
shard, so it writes them out: each function here is one `torch.distributed`
call on one of the mesh's process groups.

`mesh` is a `parallel.distributed.SolverMesh`. With `mesh=None` every
function is the identity; a space function is the identity on one space
shard, a time function on one time shard, a world function on a mesh of
one process. The single-device path therefore makes no call at all, and a
`1xS` mesh makes no time call.

Every call is counted in `COUNTS` by axis and kind with the bytes of its
result on this rank (`scripts.bench_sharded_cg` reads the counts; nothing
in the solve does). A call inside a captured segment is counted once at
the capture, where nothing runs; the count is replayed with the graph
(`ops.graphs.register_counter`), so `COUNTS` holds the calls that ran.

Every device collective can be captured into a CUDA graph over nccl: one
call on preallocated tensors, no Python list of outputs, no host read.
`space_any`, `rank0_decides` and `object_from_rank0` read the host; they
run between segments only, and raise inside one (`ops.graphs.host_side`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dots_socp_torch.ops import graphs


class CollectiveCounts:
    """Calls and result bytes of this process's collectives, by
    "<axis>_<kind>" (e.g. "space_all_gather", "time_all_gather")."""

    def __init__(self):
        self.calls: dict = {}
        self.bytes: dict = {}

    def reset(self):
        self.calls.clear()
        self.bytes.clear()

    def add(self, key: str, result):
        self.calls[key] = self.calls.get(key, 0) + 1
        self.bytes[key] = self.bytes.get(key, 0) + result.numel() * result.element_size()

    def snapshot(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes)}

    def restore(self, snapshot: dict):
        """Set the counts to a `snapshot`'s."""
        self.calls, self.bytes = dict(snapshot["calls"]), dict(snapshot["bytes"])


COUNTS = CollectiveCounts()
graphs.register_counter(COUNTS.snapshot, COUNTS.restore, "collectives")


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.space > 1


def _time_sharded(mesh) -> bool:
    return mesh is not None and mesh.time > 1


def _many(mesh) -> bool:
    return mesh is not None and mesh.space * mesh.time > 1


def _all_reduce(x, op, group, key):
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    COUNTS.add(key, y)
    return y


def _all_gather(x, n, group, dim, key):
    """The `n` ranks' `x` concatenated along `dim`: one all-gather into one
    buffer, the ranks' blocks stacked along its first axis, then moved to
    `dim` (a copy unless `dim` is the first)."""
    x = x.contiguous()
    dim = dim % x.dim()
    buf = torch.empty((n * x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(buf, x, group=group)
    out = buf.view((n,) + x.shape).movedim(0, dim)
    out = out.reshape(x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])
    COUNTS.add(key, out)
    return out


def space_sum(x, mesh):
    """Sum of `x` over the space shards (all-reduce SUM); every rank of the
    space group gets the same tensor. `x` is not modified."""
    if not _sharded(mesh):
        return x
    return _all_reduce(x, dist.ReduceOp.SUM, mesh.group, "space_all_reduce")


def space_max(x, mesh):
    """Elementwise maximum of `x` over the space shards (all-reduce MAX)."""
    if not _sharded(mesh):
        return x
    return _all_reduce(x, dist.ReduceOp.MAX, mesh.group, "space_all_reduce")


def space_any(mask, mesh) -> bool:
    """True when `mask` has a set entry on any shard. One MAX all-reduce of
    a one-element flag, then one host read: every rank reads the same value,
    so a host loop guarded by it runs the same number of times everywhere
    (where the JAX package's `lax.while_loop` predicate is global). Between
    segments only."""
    graphs.host_side("space_any")
    if not _sharded(mesh):
        return bool(mask.any())
    return bool(space_max(mask.any().to(torch.float32).reshape(1), mesh).item() > 0)


def space_all_gather(x, mesh, dim=-1):
    """The shards' `x`, concatenated along `dim` in rank order (one
    all-gather; every shard's `x` has the same shape)."""
    if not _sharded(mesh):
        return x
    return _all_gather(x, mesh.space, mesh.group, dim, "space_all_gather")


def time_all_gather(x, mesh, dim=0):
    """The time shards' blocks `x`, concatenated along `dim` in time-rank
    order: a staggered (T / Tm, ...) block becomes the whole (T, ...) array
    on every time-rank (one all-gather over the time group)."""
    if not _time_sharded(mesh):
        return x
    return _all_gather(x, mesh.time, mesh.time_group, dim, "time_all_gather")


def time_sum(x, mesh):
    """Sum of `x` over the time shards (all-reduce SUM over the time
    group). Only a quantity of the staggered (T, ...) arrays is summed so: a
    centered array is whole on every time-rank, and its sum over the time
    group would count it `mesh.time` times."""
    if not _time_sharded(mesh):
        return x
    return _all_reduce(x, dist.ReduceOp.SUM, mesh.time_group, "time_all_reduce")


def space_time_sum(x, mesh):
    """Sum of `x` over every shard of the mesh, for a quantity of the
    staggered arrays (cut over space and time): one all-reduce over all
    processes, where summing over space and then over time would be two."""
    if not _time_sharded(mesh):
        return space_sum(x, mesh)
    if not _sharded(mesh):
        return time_sum(x, mesh)
    return _all_reduce(x, dist.ReduceOp.SUM, mesh.world_group, "world_all_reduce")


def from_rank0(x, mesh):
    """World rank 0's `x` on every rank of the mesh (broadcast). Host
    decisions taken from it agree on every rank even where a reduction's
    last bits could differ between ranks or between space groups."""
    if not _many(mesh):
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=dist.get_global_rank(mesh.world_group, 0), group=mesh.world_group)
    COUNTS.add("world_broadcast", y)
    return y


def rank0_decides(flag: bool, mesh) -> bool:
    """World rank 0's host boolean on every rank (the wall-clock test).
    Between segments only."""
    graphs.host_side("rank0_decides")
    if not _many(mesh):
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    return bool(from_rank0(t, mesh).item() > 0)


def object_from_rank0(make, mesh):
    """`make()` run on world rank 0 only and its (picklable) result sent to
    every rank; the other ranks wait. With no mesh, `make()` runs here.
    Between segments only."""
    graphs.host_side("object_from_rank0")
    if not _many(mesh):
        return make()
    box = [make() if mesh.world_rank == 0 else None]
    # The backend's own device for the pickled bytes: the host for gloo,
    # the current card (set by `make_solver_mesh`) for nccl.
    group = mesh.world_group
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]
