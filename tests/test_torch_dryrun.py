"""The port's dry run (`dots_socp_torch.dryrun`, counterpart of
`__graft_entry__.py`): `dryrun_multichip` on spawned gloo CPU ranks passes
its own asserts on a 2x4 (the JAX package's `dryrun_multichip(8)`), a 2x2
and a 1x2 mesh, a failing rank fails the call, and `entry()`'s one
iteration agrees with the JAX package's."""

import numpy as np
import pytest
import torch

from dots_socp_torch import dryrun
from dots_socp_torch.parallel.spawn import run_on_ranks
from torch_rank_worker import one_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


@pytest.mark.parametrize("n_devices, mesh", [(8, (2, 4)), (4, (2, 2)), (2, (1, 2))])
def test_dryrun_multichip_passes_its_asserts(n_devices, mesh):
    """The sequence of `__graft_entry__.py:78-205` on `n_devices` ranks: the
    time axis is 2 from 4 ranks on; every rank validated at least once, its
    stop-set error halved over the 50 late iterations, and its refined CG
    path ran kernel B2's wrapper (the plain version here) and never B1's."""
    out = dryrun.dryrun_multichip(n_devices, device="cpu", timeout=300)
    assert out["mesh"] == mesh and len(out["ranks"]) == n_devices
    for rank in out["ranks"]:
        assert rank["n_time"] == 2 * mesh[0] and rank["n_checks"] >= 1
        assert np.isfinite(rank["err_late"]) and rank["err_late"] < rank["err_first"] / 2
        assert rank["b2_launches"] == rank["b1_launches"] == 0  # CPU tensors: no launch
    for key in ("err_first", "err_late"):  # the table is world rank 0's on every rank
        assert len({rank[key] for rank in out["ranks"]}) == 1


def _second_rank_fails():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    return dist.get_rank()


def test_a_failing_rank_fails_the_call():
    with pytest.raises(AssertionError, match="rank 1 of 2 failed.*rank 1 gives up"):
        run_on_ranks(_second_rank_fails, 2, timeout=120)


def test_entry_iteration_matches_reference():
    """`entry()`: one iteration on plane n32, ntime 31, float32, from the
    same initial state as `__graft_entry__.entry()`'s; every state field
    within 1e-4 of its largest entry (float32, spectral path; measured
    5.4e-7 on phi and 1.0e-5 on dx_phi and E, the space gradient of that
    phi on triangles 1/32 wide)."""
    import jax

    import __graft_entry__ as graft

    fn, (data, state) = dryrun.entry(device="cpu")
    after = fn(data, state)
    j_fn, (j_data, j_state) = graft.entry()
    j_after = jax.jit(j_fn)(j_data, j_state)
    assert after.phi.shape == (32, 1221) and after.phi.dtype == torch.float32
    for name in after._fields:
        got = getattr(after, name).numpy().astype(np.float64)
        ref = np.asarray(getattr(j_after, name), dtype=np.float64)
        assert got.shape == ref.shape, name
        assert np.abs(got - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1e-30), name
