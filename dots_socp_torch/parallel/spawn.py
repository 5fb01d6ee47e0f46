"""Start the ranks of a mesh as processes of this machine and collect what
they return: for the entry points that bring their own ranks (the dry run,
the sharded-CG benchmark), where a solve is launched by torchrun, srun or
mpirun instead.
"""

from __future__ import annotations

import multiprocessing
import tempfile
import time

RANK_TIMEOUT = 600  # seconds the ranks may take together


def _rank_main(fn, rank, world, backend, init_method, args, results):
    import torch.distributed as dist

    from dots_socp_torch.parallel.distributed import initialize_distributed

    try:
        initialize_distributed(backend, init_method=init_method, num_processes=world,
                               process_id=rank)
        results.put((rank, {"result": fn(*args)}))
    except BaseException as err:  # reported to the parent, which fails
        results.put((rank, {"error": repr(err)}))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_on_ranks(fn, world: int, args=(), backend: str = "gloo", timeout: float = RANK_TIMEOUT):
    """`fn(*args)` in `world` spawned processes, each with torch.distributed
    up (`backend`, a file:// rendezvous in a temporary directory) and torn
    down around it; the results (picklable) in rank order. `fn` is a
    module-level function; it makes its mesh with `make_solver_mesh`. A rank
    that raises, exits with an error or is not done after `timeout` seconds
    raises AssertionError here, and no rank is left running."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{tmp}/rendezvous"
        procs = [
            ctx.Process(target=_rank_main,
                        args=(fn, rank, world, backend, init_method, args, results))
            for rank in range(world)
        ]
        for p in procs:
            p.start()
        ranks = {}
        try:
            deadline = time.monotonic() + timeout
            while len(ranks) < world:
                rank, out = results.get(timeout=max(deadline - time.monotonic(), 1))
                if "error" in out:
                    raise AssertionError(f"rank {rank} of {world} failed: {out['error']}")
                ranks[rank] = out["result"]
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:  # a hung or failed rank is stopped, never left behind
                if p.is_alive():
                    p.kill()
                    p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks exited {[p.exitcode for p in procs]}")
    return [ranks[r] for r in range(world)]
