"""The port's adaptive segment (`solver/step.py::run_chunk_adaptive`)
against the JAX package's device-resident one on the conftest plane (n=12,
ntime 7): the same seeded state goes through both, and the packed output
must agree (header and the first three record columns exactly, the KKT
tables to the dtype's tolerance). On the CPU the port's segment runs through
the same static buffers a CUDA graph replays on the card (`ops.graphs`).
Also: the decision helpers against the JAX package's, and the segment's
traffic between host and buffers (one state load and one clone per
segment, one host read per validation and one of the records)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_socp_torch.convert import problem_from_reference, state_from_reference
from dots_socp_torch.ops import graphs
from dots_socp_torch.solver import step as t_step
from dots_socp_tpu.solver import step as j_step
from test_torch_solver import _fresh, _jax_setup, _to_numpy
from torch_rank_worker import one_thread

CONFIGS = {
    "spectral_f64": dict(dtype="float64", laplacian_mode="spectral"),
    "cg_f64": dict(dtype="float64", laplacian_mode="cg", phi_refine="off", cg_rtol=1e-10),
    "spectral_f32": dict(dtype="float32", laplacian_mode="spectral"),
}
# KKT tables, port against JAX: float64 as `test_adaptive_segment_decisions_
# match_reference`; float32 with the relative bound of
# `test_f32_production_path_matches_reference` (the two float32 iterations
# sum in other orders) over 150 iterations, where the dual-feasibility row,
# a difference of O(1) terms, carries their float32 round-off: 5.4e-7
# absolute at 1.7e-3 (iteration 150, measured); the absolute bound leaves 2x.
TABLE_TOL = {"float64": dict(rtol=1e-8, atol=1e-14), "float32": dict(rtol=1e-4, atol=1e-6)}
INF = np.inf
BASE = dict(it0=0, k_bound=150, j_first=1, aux=[-1.0, 0.0, 1e-3, -INF, -INF], max_checks=32)

# id -> (config, segment arguments, what the case must show in the packed
# output: a check of (header, records of the validations made))
CASES = {
    "spectral_f64": ("spectral_f64", {}, None),
    "cg_f64": ("cg_f64", {}, None),
    "spectral_f32": ("spectral_f32", {}, None),
    # The stop-set error crosses 0.05 at a validation: the segment ends there.
    "checkpoint": ("spectral_f64", dict(aux=[-1.0, 0.0, 1e-3, 0.05, -INF]),
                   lambda h, r: h[1] < 150 and h[0] < 32 and _err(r[-1]) <= 0.05 < _err(r[-2])),
    # The freeze latches at the first error below 0.1: sigma factors before,
    # adjustments with factor 1 after.
    "sigma_freeze": ("spectral_f64", dict(aux=[-1.0, 0.0, 1e-3, -INF, 0.1]),
                     lambda h, r: _frozen_after(r, 0.1)),
    # tol 1e-2 from the scaled column: the switch to the original one (scaled
    # errors below 5 tol) and then convergence inside the segment, through
    # cadence intervals of 1 near tolerance.
    "is_org_switch": ("spectral_f64", dict(aux=[-1.0, 0.0, 1e-2, -INF, -INF]),
                      lambda h, r: h[3] == 1 and h[1] < 150 and np.all(r[-1, 3::2] < 1e-2)
                      and 1 in np.diff(r[:, 0])),
    # Started at iteration 30 (last sigma update at 27) and cut at 40.
    "k_bound": ("spectral_f64", dict(it0=30, k_bound=40, j_first=4, aux=[27.0, 0.0, 1e-3, -INF, -INF]),
                lambda h, r: h[1] == 40 and r[-1, 0] == 40),
    "max_checks": ("spectral_f64", dict(max_checks=6),
                   lambda h, r: h[0] == 6 and h[1] < 150),
}


def _err(rec):
    """The stop-set error (original rows 0, 2, 4, 5) of one record."""
    return np.nanmax(rec[3:].reshape(7, 2)[[0, 2, 4, 5], 0])


def _frozen_after(recs, freeze):
    frozen = np.maximum.accumulate([_err(r) < freeze for r in recs])
    adjusted = recs[:, 1] > 0.5
    return (np.any(adjusted & ~frozen & (recs[:, 2] != 1.0))
            and np.any(adjusted & frozen) and np.all(recs[adjusted & frozen, 2] == 1.0))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_worker():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def setups(plane_geometry):
    """config name -> (jax config, data, numpy state; port config, data, state)."""
    out = {}
    for name, kw in CONFIGS.items():
        jc, jd, js = _jax_setup(plane_geometry, **kw)
        tc, td = problem_from_reference(jc, _to_numpy(jd))
        js = _to_numpy(js)
        out[name] = (jc, jd, js, tc, td, state_from_reference(js))
    return out


def _segments(setup, it0, k_bound, j_first, aux, max_checks):
    jc, jd, js, tc, td, ts = setup
    aux = np.asarray(aux)
    state_t, packed_t = t_step.run_chunk_adaptive(tc, td, ts, it0, k_bound, j_first, aux, max_checks)
    state_j, packed_j = j_step.run_chunk_adaptive(
        jc, jd, _fresh(js), np.int32(it0), np.int32(k_bound), np.int32(j_first), aux, max_checks)
    return (state_t, packed_t), (state_j, np.asarray(packed_j))


@pytest.mark.parametrize("case", list(CASES))
def test_segment_matches_reference(setups, case):
    """The packed output of one segment: header and (offset, adjusted,
    factor) of every record exactly as JAX's, the KKT tables within
    TABLE_TOL, the unused records NaN, and the final state's r (the sigma
    factors applied) exactly as JAX's."""
    name, overrides, shows = CASES[case]
    args = {**BASE, **overrides}
    (state_t, packed_t), (state_j, packed_j) = _segments(setups[name], **args)
    hdr, mc = t_step.ADAPTIVE_HEADER, args["max_checks"]
    assert packed_t.dtype == packed_j.dtype and packed_t.shape == packed_j.shape
    np.testing.assert_array_equal(packed_t[:hdr], packed_j[:hdr])
    n = int(packed_t[0])
    assert n >= 5
    rec_t = packed_t[hdr:].reshape(mc, -1)
    rec_j = packed_j[hdr:].reshape(mc, -1)
    np.testing.assert_array_equal(rec_t[:n, :3], rec_j[:n, :3])
    np.testing.assert_allclose(rec_t[:n, 3:], rec_j[:n, 3:], **TABLE_TOL[CONFIGS[name]["dtype"]])
    assert np.isnan(rec_t[n:]).all()
    assert rec_t[:n, 1].sum() >= 3  # sigma adjustments happened
    assert float(state_t.r) == float(np.asarray(state_j.r))
    if shows is not None:
        assert shows(packed_t[:hdr], rec_t[:n]), packed_t[:hdr]


@pytest.mark.parametrize("name", ["spectral_f64", "cg_f64"])
def test_segment_through_buffers_equals_eager(setups, name):
    """The segment through the workspace's buffers (the card's graphed
    path, run op by op on the CPU) equals the same segment inside
    `graphs.eager()` bit for bit: packed output and every state array."""
    *_, tc, td, ts = setups[name]
    args = dict(BASE, aux=np.asarray(BASE["aux"]))
    state_b, packed_b = t_step.run_chunk_adaptive(tc, td, ts, **args)
    with graphs.eager():
        state_e, packed_e = t_step.run_chunk_adaptive(tc, td, ts, **args)
    np.testing.assert_array_equal(packed_b, packed_e)
    for field, a, b in zip(state_b._fields, state_b, state_e):
        assert torch.equal(a, b), field
    graphs.release()


def test_segment_loads_once_and_reads_once_per_validation(setups, monkeypatch):
    """On one device a segment loads the state into the workspace once and
    clones it out once, runs one `validate` per validation, and reads the
    host once per validation (its flags) and once more (the records), in
    two segments in a row through the same cached workspace."""
    *_, tc, td, ts = setups["spectral_f64"]
    calls = {"load": 0, "state": 0, "validate": 0, "iteration": 0}
    cls = t_step._GraphedIteration
    real_load, real_state, real_run = cls.load, cls.state, graphs.Workspace.run

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    def run(self, name, fn):
        if name in calls:
            calls[name] += 1
        return real_run(self, name, fn)

    monkeypatch.setattr(cls, "load", count("load", real_load))
    monkeypatch.setattr(cls, "state", count("state", real_state))
    monkeypatch.setattr(graphs.Workspace, "run", run)
    graphs.release()
    state = ts
    for it0, k_bound in ((0, 60), (60, 40)):
        for key in calls:
            calls[key] = 0
        reads = graphs.HOST_READS
        state, packed = t_step.run_chunk_adaptive(
            tc, td, state, it0, k_bound, 1, np.asarray([-1.0, 0.0, 1e-3, -INF, -INF]), 32)
        n = int(packed[0])
        assert n >= 3 and int(packed[1]) == k_bound
        assert calls == {"load": 1, "state": 1, "validate": n, "iteration": k_bound}
        assert graphs.HOST_READS - reads == n + 1
    assert len(graphs._CACHE) == 1
    graphs.release()


def test_segment_with_other_max_checks_recaptures_its_validation(setups):
    """A later segment with another `max_checks` through the same cached
    workspace gets records of its own size (the validation and its
    records are made anew), and agrees with a fresh workspace's."""
    *_, tc, td, ts = setups["spectral_f64"]
    aux = np.asarray(BASE["aux"])
    graphs.release()
    t_step.run_chunk_adaptive(tc, td, ts, 0, 30, 1, aux, 32)
    _, packed = t_step.run_chunk_adaptive(tc, td, ts, 0, 30, 1, aux, 4)
    graphs.release()
    _, fresh = t_step.run_chunk_adaptive(tc, td, ts, 0, 30, 1, aux, 4)
    assert packed.shape == (t_step.ADAPTIVE_HEADER + 4 * t_step.ADAPTIVE_REC_SIZE,)
    np.testing.assert_array_equal(packed, fresh)
    graphs.release()


def test_run_chunk_kkt_matches_reference(setups):
    """`run_chunk_kkt` (the iterations and the `table` segment over the same
    buffers) against JAX's one dispatch: the table within 1e-8, and the same
    table as `run_chunk` followed by `kkt_table`."""
    jc, jd, js, tc, td, ts = setups["spectral_f64"]
    state_t, table_t = t_step.run_chunk_kkt(tc, td, ts, 7)
    _, table_j = j_step.run_chunk_kkt(jc, jd, _fresh(js), np.int32(7))
    np.testing.assert_allclose(table_t.numpy(), np.asarray(table_j), rtol=1e-8, atol=1e-14)
    from dots_socp_torch.solver.kkt import kkt_table

    state_s = t_step.run_chunk(tc, td, ts, 7)
    torch.testing.assert_close(table_t, kkt_table(tc, td, state_s), rtol=0, atol=0, equal_nan=True)
    graphs.release()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sigma_factor_matches_reference(dtype):
    """`_device_sigma_factor` against the JAX package's on a grid of gaps
    (incl. every threshold and its inverse) and sigmas (incl. both
    safeguard bounds): bit for bit, in the same dtype."""
    gaps = np.concatenate([np.geomspace(1e-3, 1e3, 801), [1.0, 1.0 / 1.2, 1.0 / 50],
                           [t for t, _ in t_step._GAP_FACTORS_ASC]])
    for sigma in (1e-3, 0.37, 1.0, 7.3, 999.0, 1e3):
        s_t = torch.full(gaps.shape, sigma, dtype=getattr(torch, dtype))
        port = t_step._device_sigma_factor(s_t, torch.tensor(gaps, dtype=s_t.dtype)).numpy()
        ref = np.asarray(jax.vmap(j_step._device_sigma_factor)(
            jnp.full(gaps.shape, sigma, dtype=dtype), jnp.asarray(gaps, dtype=dtype)))
        assert port.dtype == ref.dtype
        np.testing.assert_array_equal(port, ref, err_msg=f"sigma={sigma}")


def test_next_adjust_matches_reference():
    """`_device_next_adjust` against the JAX package's, int32, over the
    cadence's bands (gaps 3 to 43) and their edges."""
    its = np.arange(0, 700, dtype=np.int32)
    for offset in (None, 1, 3, 20, 45):
        last = np.full_like(its, -1) if offset is None else its - offset
        port = torch.stack([t_step._device_next_adjust(torch.tensor(i), torch.tensor(a))
                            for i, a in zip(its, last)]).numpy()
        ref = np.asarray(jax.vmap(j_step._device_next_adjust)(jnp.asarray(its), jnp.asarray(last)))
        assert port.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(port, ref)


def test_nanmax_is_nan_only_when_every_entry_is():
    """The masked max: NaN entries skipped, +inf kept, NaN when all are."""
    nan, inf = float("nan"), float("inf")
    for values, expect in (([1.0, nan, 3.0], 3.0), ([nan, nan], nan), ([nan, inf], inf), ([-2.0], -2.0)):
        got = float(t_step._nanmax(torch.tensor(values)))
        assert got == expect or (np.isnan(got) and np.isnan(expect)), values


def test_chip_smoke_adaptive_phase_needs_a_card(capsys):
    """`chip_smoke.py --phase adaptive` fails at the device phase without a
    card, and prints no line."""
    import chip_smoke

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chip_smoke.main(["--phase", "adaptive"])
    assert capsys.readouterr().out == ""


def test_penalty_factor_takes_a_tensor_as_it_lies(setups):
    """`apply_penalty_factor` with a 0-d tensor factor (as the validation
    computes it on the device) gives the state the Python number gives,
    and refuses a factor on another device than the state's."""
    from dots_socp_torch.solver.scaling import apply_penalty_factor

    *_, ts = setups["spectral_f64"]
    by_tensor = apply_penalty_factor(ts, torch.tensor(1.26, dtype=torch.float64))
    by_number = apply_penalty_factor(ts, 1.26)
    for field, a, b in zip(ts._fields, by_tensor, by_number):
        assert torch.equal(a, b), field
    with pytest.raises(ValueError, match="meta"):
        apply_penalty_factor(ts, torch.tensor(1.26, device="meta"))
