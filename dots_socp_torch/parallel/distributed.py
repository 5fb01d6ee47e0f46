"""Multi-process runtime and the solver's device mesh (counterpart of
`dots_socp_tpu/parallel/distributed.py`).

The JAX package brings up `jax.distributed` and builds a ("time", "space")
`Mesh`; GSPMD then places one shard per device. The port runs one process
per (time, space) shard over `torch.distributed`, world rank = t * S + s:

  NCCL  -- one card per rank (NCCL refuses two ranks on one card);
  gloo  -- CUDA tensors on one card shared by every rank, or CPU tensors.

The caller picks the backend; nothing is inferred from a failure. Launch
under `torchrun` (its RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT env),
under SLURM's `srun` or Open MPI's `mpirun` (rank and world size from their
environment), or pass the rank, world size and rendezvous address
explicitly:

    torchrun --nproc_per_node 4 -m dots_socp_torch.cli --example plane \
        --n_space 200 --ntime 32 --mesh_shape 2x2 --dist_backend nccl

A `TxS` mesh makes two families of process groups: the S-sized "space"
groups (ranks with the same t) carry the halo exchange and every sum over
vertices or triangles; the T-sized "time" groups (ranks with the same s)
carry the all-gathers between the staggered (T, ...) arrays, which are cut
into T blocks of n_time / T slices, and the centered (T+1, ...) arrays,
which every time-rank holds whole (T and T+1 cannot both divide the axis).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re

import torch
import torch.distributed as dist

from dots_socp_torch.ops import resolve_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class SolverMesh:
    """This process's place on the solver's ("time", "space") mesh.

    space      : number of space shards (= processes in `group`)
    rank       : this process's space shard, its rank in `group`
    device     : the torch device this shard's tensors live on
    group      : the process group of the space collectives (None: none is
                 needed, e.g. to slice one shard of a problem on the host)
    time       : number of time shards (= processes in `time_group`)
    time_rank  : this process's block of the staggered time slices
    time_group : the process group of the time collectives (None with
                 time == 1)
    world_group: every process of the mesh; host decisions come from its
                 rank 0. With time == 1 it is `group`.
    """

    space: int
    rank: int
    device: torch.device
    group: object = None
    time: int = 1
    time_rank: int = 0
    time_group: object = None
    world_group: object = None

    @property
    def shape(self) -> dict:
        return {"time": self.time, "space": self.space}

    @property
    def world_rank(self) -> int:
        return self.time_rank * self.space + self.rank

    @property
    def backend(self) -> str | None:
        return dist.get_backend(self.world_group) if self.world_group is not None else None

    @property
    def capturable(self) -> bool:
        """Whether this mesh's collectives can be captured into CUDA graphs:
        nccl's can, gloo's cannot (they run on the host)."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def time_block(self, n_time: int) -> slice:
        """This time-rank's block of `n_time` staggered slices."""
        check_time_axis(n_time, self.time)
        chunk = n_time // self.time
        return slice(self.time_rank * chunk, (self.time_rank + 1) * chunk)


def check_time_axis(n_time: int, time_axis: int) -> None:
    """The staggered arrays hold n_time slices and are cut into `time_axis`
    equal blocks (JAX `parallel/mesh.py:47-83`)."""
    if n_time % time_axis:
        raise ValueError(
            f"n_time={n_time} is not a multiple of the mesh's time axis {time_axis}: "
            f"the (T, ...) arrays are cut into {time_axis} equal blocks of slices"
        )


def _first_host(nodelist: str) -> str:
    """The first host of a SLURM node list ("n[03-05,9],m1" -> "n03")."""
    head = re.match(r"([^\[,]*)(?:\[([^\]]*)\])?", nodelist.strip())
    prefix, ranges = head.group(1), head.group(2)
    if ranges is None:
        return prefix
    return prefix + re.split(r"[,-]", ranges)[0]


def cluster_environment(env=None):
    """(process_id, num_processes, "host:port") from the cluster's
    environment, or None outside one: the environments the JAX package
    detects (`dots_socp_tpu/parallel/distributed.py:47-58`).

      SLURM     SLURM_PROCID / SLURM_NTASKS; the address is the first host of
                SLURM_STEP_NODELIST (or SLURM_JOB_NODELIST) with a port
                derived from SLURM_JOB_ID
      Open MPI  OMPI_COMM_WORLD_RANK / OMPI_COMM_WORLD_SIZE; the address
                comes from COORDINATOR_ADDRESS

    COORDINATOR_ADDRESS ("host:port"), when set, is the address in both.
    """
    env = os.environ if env is None else env
    address = env.get("COORDINATOR_ADDRESS")
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        if address is None:
            nodelist = env.get("SLURM_STEP_NODELIST") or env.get("SLURM_JOB_NODELIST")
            if not nodelist:
                raise ValueError("SLURM environment without a node list: set COORDINATOR_ADDRESS")
            port = 61440 + int(env.get("SLURM_JOB_ID", 0)) % 4096
            address = f"{_first_host(nodelist)}:{port}"
        return rank, world, address
    if "OMPI_COMM_WORLD_RANK" in env and "OMPI_COMM_WORLD_SIZE" in env:
        if address is None:
            raise ValueError(
                "Open MPI environment: set COORDINATOR_ADDRESS=host:port (rank 0's host) "
                "for the rendezvous"
            )
        return int(env["OMPI_COMM_WORLD_RANK"]), int(env["OMPI_COMM_WORLD_SIZE"]), address
    if address is not None:
        raise ValueError(
            "COORDINATOR_ADDRESS is set, but neither SLURM nor Open MPI gives a rank: "
            "pass num_processes and process_id"
        )
    return None


def _local_rank() -> int:
    """This process's index among the processes of its node."""
    for key in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if key in os.environ:
            return int(os.environ[key])
    return dist.get_rank()


def _local_world_size(env=None) -> int | None:
    """The number of this job's processes on this node, as torchrun
    (LOCAL_WORLD_SIZE), SLURM (SLURM_NTASKS_PER_NODE, or this node's entry of
    SLURM_STEP_TASKS_PER_NODE / SLURM_TASKS_PER_NODE, "4(x2),3") or Open MPI
    (OMPI_COMM_WORLD_LOCAL_SIZE) says it; None where nothing does."""
    env = os.environ if env is None else env
    for key in ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE", "OMPI_COMM_WORLD_LOCAL_SIZE"):
        if key in env:
            return int(env[key])
    for key in ("SLURM_STEP_TASKS_PER_NODE", "SLURM_TASKS_PER_NODE"):
        if key in env:
            counts = []
            for count, repeat in re.findall(r"(\d+)(?:\(x(\d+)\))?", env[key]):
                counts += [int(count)] * int(repeat or 1)
            node = int(env.get("SLURM_NODEID", 0))
            return counts[node] if node < len(counts) else max(counts)
    return None


def _check_card_per_rank(backend: str, cards: int, env=None) -> None:
    """NCCL refuses two ranks on one card: raise where this node runs more
    ranks than it has cards. A `2x4` mesh on two 4-card nodes passes (4 ranks
    a node). Where the launcher does not say how many ranks the node runs
    (explicit arguments), the check is left to NCCL itself."""
    local_ranks = _local_world_size(env)
    if backend == "nccl" and local_ranks is not None and cards < local_ranks:
        raise ValueError(
            f"nccl takes one card per rank: {local_ranks} ranks on this node, {cards} cards "
            "(use --dist_backend gloo to share one card)"
        )


def initialize_distributed(
    backend: str,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    init_method: str | None = None,
) -> bool:
    """Bring up torch.distributed (idempotent); True once a group is up.

    Explicit: `num_processes`, `process_id` and a rendezvous
    (`coordinator_address` "host:port", or any `init_method` such as
    "file:///path"). Otherwise torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), then the cluster's (`cluster_environment`:
    SLURM, Open MPI). With none of them, nothing is started and False is
    returned (a single-process run).
    """
    if dist.is_initialized():
        return True
    if backend not in BACKENDS:
        raise ValueError(f"dist backend must be one of {BACKENDS}, got {backend!r}")
    explicit = (num_processes, process_id, coordinator_address, init_method)
    if any(v is not None for v in explicit):
        if num_processes is None or process_id is None or (
            coordinator_address is None and init_method is None
        ):
            raise ValueError(
                "explicit distributed setup needs num_processes, process_id and "
                "coordinator_address (or init_method)"
            )
        dist.init_process_group(
            backend,
            init_method=init_method or f"tcp://{coordinator_address}",
            world_size=int(num_processes),
            rank=int(process_id),
        )
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        dist.init_process_group(backend, init_method="env://")
    else:
        cluster = cluster_environment()
        if cluster is None:
            return False
        rank, world, address = cluster
        dist.init_process_group(
            backend, init_method=f"tcp://{address}", world_size=world, rank=rank
        )
    logging.info(
        "torch.distributed up: backend %s, rank %d of %d",
        backend, dist.get_rank(), dist.get_world_size(),
    )
    return True


def parse_mesh_shape(spec: str) -> tuple[int, int]:
    """Parse a --mesh_shape string into (time, space) axis sizes.

    Grammar: "TxS" (e.g. "1x4") or a bare count "S" meaning pure spatial
    sharding ("1xS"). Sizes must be positive.
    """
    text = str(spec).strip().lower()
    parts = text.split("x")
    if len(parts) == 1:
        sizes = (1, int(parts[0]))
    elif len(parts) == 2:
        sizes = (int(parts[0]), int(parts[1]))
    else:
        raise ValueError(f"mesh_shape must be 'TxS' or 'S', got {spec!r}")
    if min(sizes) < 1:
        raise ValueError(f"mesh_shape sizes must be positive, got {spec!r}")
    return sizes


def make_solver_mesh(mesh_shape, device="cuda") -> SolverMesh:
    """The solver's mesh over the initialized process group.

    mesh_shape : "TxS" / "S" or a (time, space) tuple; T * S must equal the
        process group's size (one process per shard). This process is shard
        (t, s) = divmod(world rank, S), as `devices.reshape(time, space)`
        places JAX's devices. With T > 1 every rank creates the T space
        groups and the S time groups (`dist.new_group` is collective).
    device : "cuda" places this rank on cuda:{local rank % device_count}
        (and makes it the current card); "cpu" keeps it on the host.
    """
    if isinstance(mesh_shape, str):
        time_axis, space_axis = parse_mesh_shape(mesh_shape)
    else:
        time_axis, space_axis = map(int, mesh_shape)
    n_shards = time_axis * space_axis
    if not dist.is_initialized():
        raise RuntimeError(
            "make_solver_mesh needs a torch.distributed process group: call "
            "initialize_distributed first (or run under torchrun)"
        )
    world = dist.get_world_size()
    if n_shards > world:
        raise ValueError(
            f"mesh_shape {time_axis}x{space_axis} needs {n_shards} devices "
            f"(one process each); only {world} are available"
        )
    if n_shards < world:
        raise ValueError(
            f"mesh_shape {time_axis}x{space_axis} takes one process per shard; "
            f"the process group has {world}"
        )
    backend = dist.get_backend()
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        _check_card_per_rank(backend, count)
        dev = torch.device("cuda", _local_rank() % count)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs CUDA tensors: pass device='cuda'")
    rank = dist.get_rank()
    if time_axis == 1:
        mesh = SolverMesh(space=space_axis, rank=rank, device=dev, group=dist.group.WORLD,
                          world_group=dist.group.WORLD)
    else:
        t, s = divmod(rank, space_axis)
        space_group = time_group = None
        for i in range(time_axis):
            if space_axis > 1:
                group = dist.new_group([i * space_axis + j for j in range(space_axis)])
                space_group = group if i == t else space_group
        for j in range(space_axis):
            group = dist.new_group([i * space_axis + j for i in range(time_axis)])
            time_group = group if j == s else time_group
        mesh = SolverMesh(space=space_axis, rank=s, device=dev, group=space_group,
                          time=time_axis, time_rank=t, time_group=time_group,
                          world_group=dist.group.WORLD)
    _open_groups(mesh)
    return mesh


def _open_groups(mesh: SolverMesh) -> None:
    """One small all-reduce on each of the mesh's process groups (space,
    time, world), on every rank: NCCL makes a group's communicator at its
    first collective, which must not fall inside a CUDA graph capture."""
    groups = {id(g): g for g in (mesh.group, mesh.time_group, mesh.world_group) if g is not None}
    for group in groups.values():
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)
