"""Sharded execution over torch.distributed, one process per (time, space)
shard (counterpart of `dots_socp_tpu/parallel`).

  partition.py   -- host-side blocked layout and halo tables (numpy)
  distributed.py -- process-group bring-up, mesh-shape grammar, SolverMesh
  halo.py        -- shard-local gathers / reductions, one all-gather each
  mesh.py        -- cut a host problem and state into one rank's shard
  spawn.py       -- start a mesh's ranks as processes of this machine

The cross-shard sums and the time all-gathers live in `ops.collectives`. Nothing is imported here:
the submodules are imported by path, which keeps `ops` free of import
cycles through `parallel.mesh`.
"""
