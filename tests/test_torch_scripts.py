"""The port's measurement script of the sharded CG path
(`dots_socp_torch.scripts.bench_sharded_cg`, counterpart of
`scripts/bench_sharded_cg.py`) at a small size on two gloo CPU ranks."""

import json

import pytest

from dots_socp_torch.ops.collectives import COUNTS, CollectiveCounts
from dots_socp_torch.scripts import bench_sharded_cg
from torch_rank_worker import one_thread


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    import contextlib
    import io

    printed = io.StringIO()
    with one_thread(), contextlib.redirect_stdout(printed):
        out = bench_sharded_cg.main(["--n_space", "24", "--n_devices", "2", "--device", "cpu",
                                     "--repeats", "1"])
    return out, printed.getvalue().strip().splitlines()


def test_bench_sharded_cg_ends_in_one_json_line_with_both_layouts(bench):
    out, lines = bench
    last = json.loads(lines[-1])
    assert set(last["layouts"]) == {"halo_blocked", "swindow_blocked", "gspmd_raw"}
    assert "no counterpart" in last["layouts"]["gspmd_raw"]
    assert last["card"] is None and "cpu" in last["metric"]
    for label in bench_sharded_cg.LAYOUTS:
        layout = last["layouts"][label]
        assert layout == out["layouts"][label]
        assert layout["inner_iterations"] > 0 and layout["wall_sec_per_cg_solve"] > 0
        assert json.loads(lines[bench_sharded_cg.LAYOUTS.index(label)]) == {label: layout}
    # The window layout runs kernel B2's wrapper in every inner matvec; the
    # halo layout never.
    assert last["layouts"]["halo_blocked"]["window_matvecs"] == 0
    swin = last["layouts"]["swindow_blocked"]
    assert swin["window_matvecs"] >= swin["inner_iterations"] > 0


def test_counted_all_gathers_are_boundary_sized(bench):
    """The port's form of tests/test_parallel.py::
    test_halo_path_cuts_collective_bytes: the blocked layouts exchange
    boundary-sized buffers, not bulk arrays. Counted at the port's own
    collective functions, one all-gather of either layout brings back less
    than 0.35 of the bulk (T+1) x V floats on average, and the window
    layout's solve gathers fewer bytes than the halo layout's (one export
    buffer per matvec instead of two exchanges)."""
    out, _ = bench
    halo, swin = (out["layouts"][k] for k in bench_sharded_cg.LAYOUTS)
    for layout in (halo, swin):
        calls = layout["all_gather_calls_per_cg_solve"]
        assert calls > 0
        per_call = layout["all_gather_bytes_per_cg_solve"] / calls
        assert per_call < 0.35 * layout["operand_bytes"], (per_call, layout["operand_bytes"])
        # Nothing crosses time on a 1xS mesh.
        assert not any(k.startswith(("time_", "world_all_reduce"))
                       for k in layout["collective_calls_per_cg_solve"])
    assert swin["all_gather_bytes_per_cg_solve"] < halo["all_gather_bytes_per_cg_solve"]
    assert out["swindow_vs_halo_all_gather_bytes"] < 1


def test_window_traffic_accounting(bench):
    """B1's tiles on one device against the per-shard B2 tiles: each of two
    shards moves fewer bytes per matvec than the single device (more than
    half: the export buffer and the codes come on top)."""
    traffic = bench[0]["window_traffic"]
    single, sharded = traffic["single_device"]["bytes"], traffic["sharded"]
    assert len(sharded["bytes_per_shard"]) == 2
    assert all(single / 2 < b < single for b in sharded["bytes_per_shard"])
    assert 1 < traffic["kernel_speedup_vs_single"] < 2
    assert traffic["total_traffic_ratio_sharded_vs_single"] == sharded["bytes"] / single


def test_single_device_and_identity_paths_count_no_collective():
    """With no mesh, or one shard along an axis, a collective function is the
    identity and makes (and counts) no call."""
    import torch

    from dots_socp_torch.ops import collectives as c
    from dots_socp_torch.parallel.distributed import SolverMesh

    assert isinstance(COUNTS, CollectiveCounts)
    COUNTS.reset()
    x = torch.arange(6.0).reshape(2, 3)
    one = SolverMesh(space=1, rank=0, device=torch.device("cpu"))
    for mesh in (None, one):
        for fn in (c.space_sum, c.space_max, c.time_sum, c.space_time_sum, c.from_rank0):
            assert fn(x, mesh) is x
        assert c.space_all_gather(x, mesh) is x and c.time_all_gather(x, mesh) is x
        assert c.rank0_decides(True, mesh) is True and c.space_any(x > 4, mesh) is True
        assert c.object_from_rank0(lambda: 7, mesh) == 7
    assert COUNTS.snapshot() == {"calls": {}, "bytes": {}}


def test_loops_mode_reads_each_turn_per_rank_and_iteration():
    """--loops on a 1x2 gloo CPU mesh (plane n24, spectral): one line per
    rank, then one with every rank; each rank reads the turns eager,
    graphed, graphed, eager, each per outer iteration (difference of a 1-
    and a 2-iteration solve), none captured (gloo), the graphed turns'
    segments run op by op and the eager turns' not at all."""
    import contextlib
    import io

    printed = io.StringIO()
    with one_thread(), contextlib.redirect_stdout(printed):
        out = bench_sharded_cg.main(["--loops", "--n_space", "24", "--ntime", "4", "--device",
                                     "cpu", "--short", "1", "--long", "2"])
    lines = printed.getvalue().strip().splitlines()
    assert [json.loads(line) for line in lines[:-1]] == out["ranks"]
    assert json.loads(lines[-1]) == out and out["card"] is None and "gloo" in out["metric"]
    for rank, got in enumerate(out["ranks"]):
        assert got["world_rank"] == rank and got["backend"] == "gloo"
        assert [t["mode"] for t in got["turns"]] == list(bench_sharded_cg.LOOP_TURNS)
        for turn in got["turns"]:
            per_it = turn["per_iteration"]
            assert not turn["captured"] and per_it["collective_calls"] > 0
            assert per_it["b2_launches"] == per_it["window_matvecs"] == 0  # spectral
            ran = [stats["uncaptured_runs"] for stats in turn["graph_stats"]]
            assert all(stats["captures"] == 0 for stats in turn["graph_stats"])
            assert (min(ran) > 0) == (turn["mode"] == "graphed") and max(ran) >= min(ran)
