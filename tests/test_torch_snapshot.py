"""Snapshot / resume of the port (`dots_socp_torch.utils.snapshot` and the
resume path of `solver_socp`) on the conftest plane (n=12, ntime 6, f64):
a resumed run continues the uninterrupted trajectory, on the spectral path,
on the CG path with its adaptive inner tolerance, and on a 1x2 mesh of gloo
ranks; and the file is the JAX package's format, resumed across the two
packages in both directions."""

import json
import re
import shutil

import numpy as np
import pytest
import torch

from dots_socp_torch.solver import solver_socp as t_solver
from dots_socp_torch.solver.state import SolverState
from dots_socp_torch.utils import snapshot as t_snap
from dots_socp_tpu.solver import solver_socp as j_solver
from dots_socp_tpu.utils import snapshot as j_snap
from torch_rank_worker import geometry_inputs, one_thread, run_ranks

N_TIME = 6
KW = dict(tol=1e-12, time_limit=300)  # tol unreachable: a fixed iteration count


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


def _port(geometry, **kw):
    return t_solver(N_TIME, geometry, device="cpu", precision="float64", **KW, **kw)


def _assert_same_trajectory(resumed, full):
    """The bound of tests/test_solver.py::test_snapshot_resume_matches_uninterrupted."""
    for key in ("mu", "phi"):
        np.testing.assert_allclose(resumed[key], full[key], rtol=1e-8, atol=1e-12, err_msg=key)


def _meta(path):
    with np.load(path) as f:
        return json.loads(bytes(f["__meta__"]).decode())


def _rewrite_meta(path, change):
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    change(meta)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def test_format_is_the_reference_format():
    assert t_snap._STATE_FIELDS == j_snap._STATE_FIELDS == SolverState._fields
    assert t_snap.SNAPSHOT_VERSION == j_snap.SNAPSHOT_VERSION == 1


def test_resume_matches_uninterrupted_spectral(plane_geometry, tmp_path):
    """Interrupt at nit=20, resume to nit=45: the uninterrupted 45 iterations
    (rtol 1e-8, atol 1e-12); the log names the iteration the first leg ended
    on and the history goes on from it."""
    full, _ = _port(plane_geometry, nit=45)
    snap = str(tmp_path / "state.npz")
    _port(plane_geometry, nit=20, snapshot_path=snap)
    meta = _meta(snap)
    assert meta["iteration"] == 19 and meta["n_time"] == N_TIME and meta["cg_rtol"] is None
    resumed, history = _port(plane_geometry, nit=45, snapshot_path=snap)
    _assert_same_trajectory(resumed, full)
    its = history.kkt_iteration[np.isfinite(history.kkt_iteration)]
    assert its.min() >= 20 and its.max() == 44
    assert _meta(snap)["iteration"] == 44  # the forced snapshot on loop exit


def test_resume_matches_uninterrupted_cg_with_adaptive_rtol(plane_geometry, tmp_path):
    """The CG path with the adaptive inner tolerance, cut at a segment
    boundary (80 of 120 iterations, segments of 40, as a run cut by its time
    limit or a crash is): by iteration 80 the tolerance has left its
    starting value 1e-3, the snapshot carries it, and the resumed run
    equals the uninterrupted one (rtol 1e-8, atol 1e-12). Without the key
    (a file of the JAX package, which does not write it) the run starts
    again from 1e-3 and leaves the trajectory (measured 1.8e-5 relative)."""
    kw = dict(laplacian_mode="cg", max_chunk=40)
    full, _ = _port(plane_geometry, nit=120, **kw)
    snap = str(tmp_path / "state.npz")
    _port(plane_geometry, nit=80, snapshot_path=snap, **kw)
    assert 0 < _meta(snap)["cg_rtol"] < 0.9e-3
    no_key_snap = str(tmp_path / "no_key.npz")
    shutil.copy(snap, no_key_snap)
    _rewrite_meta(no_key_snap, lambda m: m.pop("cg_rtol"))

    resumed, _ = _port(plane_geometry, nit=120, snapshot_path=snap, **kw)
    _assert_same_trajectory(resumed, full)
    no_key, _ = _port(plane_geometry, nit=120, snapshot_path=no_key_snap, **kw)
    off = np.abs(no_key["mu"] - full["mu"]).max() / np.abs(full["mu"]).max()
    assert 1e-7 < off < 1e-3, off


def test_port_resumes_a_reference_snapshot(plane_geometry, tmp_path):
    """JAX writes at 20, the port resumes to 45 and matches JAX's
    uninterrupted 45 (mu within 1e-8 max|mu|, the bound of
    test_torch_solver.py::test_full_solve_matches_reference); pad_multiple 1
    on both sides."""
    full, _ = j_solver(N_TIME, plane_geometry, nit=45, pad_multiple=1, **KW)
    snap = str(tmp_path / "state.npz")
    j_solver(N_TIME, plane_geometry, nit=20, pad_multiple=1, snapshot_path=snap, **KW)
    assert "cg_rtol" not in _meta(snap)
    resumed, _ = _port(plane_geometry, nit=45, pad_multiple=1, snapshot_path=snap)
    for key in ("mu", "phi"):
        np.testing.assert_allclose(
            resumed[key], full[key], rtol=0, atol=1e-8 * np.abs(full[key]).max(), err_msg=key
        )


def test_reference_resumes_a_port_snapshot(plane_geometry, tmp_path):
    """The port writes at 20, JAX resumes to 45 (its loader ignores the
    port's extra key) and matches JAX's uninterrupted 45, same bound."""
    full, _ = j_solver(N_TIME, plane_geometry, nit=45, pad_multiple=1, **KW)
    snap = str(tmp_path / "state.npz")
    _port(plane_geometry, nit=20, pad_multiple=1, snapshot_path=snap)
    resumed, _ = j_solver(N_TIME, plane_geometry, nit=45, pad_multiple=1, snapshot_path=snap, **KW)
    for key in ("mu", "phi"):
        np.testing.assert_allclose(
            resumed[key], full[key], rtol=0, atol=1e-8 * np.abs(full[key]).max(), err_msg=key
        )


@pytest.mark.parametrize("other", [dict(n_time=5), dict(pad_multiple=8)], ids=["n_time", "V"])
def test_resume_rejects_another_shape(plane_geometry, tmp_path, other):
    """A snapshot of another n_time or padded vertex count raises the JAX
    package's ValueError (`socp.py:342-347`)."""
    snap = str(tmp_path / "state.npz")
    _port(plane_geometry, nit=5, snapshot_path=snap)
    kw = dict(device="cpu", precision="float64", nit=8, snapshot_path=snap, **KW)
    n_time = other.pop("n_time", N_TIME)
    with pytest.raises(ValueError, match="was written for n_time=6, V=182; this run"):
        t_solver(n_time, plane_geometry, **kw, **other)


@pytest.mark.parametrize("written_on", ["1x2", "one device"])
def test_resume_rejects_another_space_axis(tmp_path, written_on):
    """plane n13 has V=224, a multiple of 16: its blocked layout on 1x2
    (two chunks of 112) pads to the same V as one device, so the n_time / V
    guard passes. The file names the space axis it was written on, and a
    resume on the other one raises a ValueError naming both (on every rank
    of the mesh, before any collective: no rank hangs), in both directions."""
    from dots_socp_torch.cli import load_geometry

    geometry = load_geometry("plane", 13)
    snap = tmp_path / "state.npz"
    first = dict(KW, precision="float64", nit=5, snapshot_path=str(snap))
    inputs = lambda **kw: dict(geometry_inputs(geometry), n_time=N_TIME,
                               **{f"kw_{k}": v for k, v in kw.items()})
    (tmp_path / "first").mkdir()
    if written_on == "1x2":
        run_ranks(tmp_path / "first", "solve", 2, inputs(**first))
        written, other = {"space_axis": 2, "lane": 8}, {"space_axis": 1, "lane": None}
    else:
        t_solver(N_TIME, geometry, device="cpu", **first)
        written, other = {"space_axis": 1, "lane": None}, {"space_axis": 2, "lane": 8}
    assert _meta(snap)["space_layout"] == written
    message = (f"written on space axis {written['space_axis']} .*this run has space axis "
               f"{other['space_axis']}")
    second = dict(first, nit=8)
    if written_on == "1x2":
        with pytest.raises(ValueError, match=message):
            t_solver(N_TIME, geometry, device="cpu", **second)
    else:
        for rank in run_ranks(tmp_path, "refused", 2, inputs(**second)):
            assert re.search(message, str(rank["error"])), rank["error"]
    assert _meta(snap)["iteration"] == 4  # the file was not overwritten


def test_load_rejects_another_version(plane_geometry, tmp_path):
    snap = str(tmp_path / "state.npz")
    _port(plane_geometry, nit=3, snapshot_path=snap)
    _rewrite_meta(snap, lambda m: m.update(version=2))
    for mod in (t_snap, j_snap):
        with pytest.raises(ValueError, match="snapshot version 2"):
            mod.load_snapshot(snap)


def test_failing_write_leaves_no_temp_file_and_keeps_the_old_snapshot(
    plane_geometry, tmp_path, monkeypatch
):
    snap = tmp_path / "state.npz"
    _port(plane_geometry, nit=3, snapshot_path=str(snap))
    before = snap.read_bytes()
    arrays, meta = t_snap.load_snapshot(str(snap))
    state = t_snap.state_from_arrays(arrays, torch.float64)

    def broken_savez(file, **kw):
        file.write(b"half a snapshot")
        raise OSError("disk full")

    monkeypatch.setattr(t_snap.np, "savez", broken_savez)
    with pytest.raises(OSError, match="disk full"):
        t_snap.save_snapshot(str(snap), state, meta)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["state.npz"]
    assert snap.read_bytes() == before


def test_round_trip_keeps_values_and_casts(plane_geometry, tmp_path):
    """save -> load -> state_from_arrays: the values bit for bit; the state
    in the run dtype, `phi` in phi_dtype."""
    snap = str(tmp_path / "state.npz")
    _port(plane_geometry, nit=3, snapshot_path=snap)
    arrays, meta = t_snap.load_snapshot(snap)
    state = t_snap.state_from_arrays(arrays, torch.float32, phi_dtype=torch.float64)
    assert state.phi.dtype == torch.float64 and state.mu.dtype == state.r.dtype == torch.float32
    t_snap.save_snapshot(snap, t_snap.state_from_arrays(arrays, torch.float64), meta)
    again, meta_again = t_snap.load_snapshot(snap)
    assert meta_again == meta
    for name in t_snap._STATE_FIELDS:
        np.testing.assert_array_equal(again[name], arrays[name], err_msg=name)


def test_two_rank_resume_matches_single_device_resume(plane_geometry, tmp_path):
    """A 1x2 mesh of gloo ranks interrupted at 20 and resumed to 45 (rank 0
    writes the gathered state, both ranks read it) equals the single-device
    resume (rtol 1e-9, atol 1e-12, the bound of the sharded solve in
    tests/test_torch_parallel.py); both ranks return the same solution."""
    single_snap = str(tmp_path / "single.npz")
    _port(plane_geometry, nit=20, snapshot_path=single_snap)
    single, history = _port(plane_geometry, nit=45, snapshot_path=single_snap)

    kw = dict(KW, precision="float64", snapshot_path=str(tmp_path / "mesh.npz"))
    inputs = dict(geometry_inputs(plane_geometry), n_time=N_TIME, first_nit=20, nit=45,
                  **{f"kw_{k}": v for k, v in kw.items()})
    rank0, rank1 = run_ranks(tmp_path, "resume", 2, inputs)
    assert _meta(tmp_path / "mesh.npz")["iteration"] == 44
    for key in ("mu", "E", "phi"):
        np.testing.assert_array_equal(rank0[key], rank1[key])
        np.testing.assert_allclose(rank0[key], single[key], rtol=1e-9, atol=1e-12, err_msg=key)
    np.testing.assert_array_equal(rank0["kkt_iteration"], history.kkt_iteration)
