"""The port's stencils, mesh operators, norms and cone projection against the
JAX package, on the same seeded inputs: f64 to 1e-12 relative, f32 to 1e-5
(float32 rounding and summation order differ between the frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_socp_torch.ops import cones as t_cones
from dots_socp_torch.ops import mesh_ops as t_mesh
from dots_socp_torch.ops import norms as t_norms
from dots_socp_torch.ops import time_stencils as t_ts
from dots_socp_tpu.ops import cones as j_cones
from dots_socp_tpu.ops import mesh_ops as j_mesh
from dots_socp_tpu.ops import norms as j_norms
from dots_socp_tpu.ops import time_stencils as j_ts

DTYPES = {
    "f64": (np.float64, jnp.float64, torch.float64, 1e-12),
    "f32": (np.float32, jnp.float32, torch.float32, 1e-5),
}
T = 5


@pytest.fixture(scope="module", params=list(DTYPES))
def both(request, plane_geometry):
    np_dt, j_dt, t_dt, tol = DTYPES[request.param]
    v, tri = plane_geometry["vertices"], plane_geometry["triangles"]
    j_ops = j_mesh.build_surface_ops(v, tri, dtype=j_dt)
    t_ops = t_mesh.build_surface_ops(v, tri, dtype=t_dt)
    return j_ops, t_ops, np_dt, t_dt, tol


def _close(port, ref, tol):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(port - ref).max() <= tol * scale, np.abs(port - ref).max() / scale


def _inputs(seed, shape, np_dt, t_dt):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np_dt)
    return jnp.asarray(x), torch.from_numpy(x).to(t_dt)


def test_surface_ops_arrays_equal(both):
    j_ops, t_ops, _, _, _ = both
    for name in j_mesh.SurfaceOps._fields:
        np.testing.assert_array_equal(
            getattr(t_ops, name).numpy(), np.asarray(getattr(j_ops, name))
        )


def test_time_stencils(both):
    _, t_ops, np_dt, t_dt, tol = both
    V, F = t_ops.av.shape[0], t_ops.area_f.shape[0]
    dt = 1.0 / T
    jp, tp = _inputs(1, (T + 1, V), np_dt, t_dt)
    jm, tm = _inputs(2, (T, V), np_dt, t_dt)
    jb, tb = _inputs(3, (T + 1, F, 3), np_dt, t_dt)
    jx, tx = _inputs(4, (T, 2, F, 3, 3), np_dt, t_dt)
    _close(t_ts.grad_time(dt, tp), j_ts.grad_time(dt, jp), tol)
    _close(t_ts.div_time(dt, tm), j_ts.div_time(dt, jm), tol)
    _close(t_ts.time_center_adjoint(tm), j_ts.time_center_adjoint(jm), tol)
    for sz in (1.0, 0.7):
        _close(t_ts.decouple_space(tb, sz), j_ts.decouple_space(jb, sz), tol)
        _close(t_ts.decouple_space_adjoint(tx, sz), j_ts.decouple_space_adjoint(jx, sz), tol)


def test_mesh_ops(both):
    j_ops, t_ops, np_dt, t_dt, tol = both
    V, F = t_ops.av.shape[0], t_ops.area_f.shape[0]
    jp, tp = _inputs(5, (T + 1, V), np_dt, t_dt)
    jm, tm = _inputs(6, (T + 1, F, 3), np_dt, t_dt)
    _close(t_mesh.vertex_gather(t_ops, tp), j_mesh.vertex_gather(j_ops, jp), tol)
    _close(t_mesh.vertex_reduce(t_ops, tm), j_mesh.vertex_reduce(j_ops, jm), tol)
    _close(t_mesh.grad_space(t_ops, tp), j_mesh.grad_space(j_ops, jp), tol)
    _close(t_mesh.div_space(t_ops, tm), j_mesh.div_space(j_ops, jm), tol)
    _close(t_mesh.laplacian_apply(t_ops, tp), j_mesh.laplacian_apply(j_ops, jp), tol)
    _close(
        t_mesh.triangle_mean_gather(t_ops, tp), j_mesh.triangle_mean_gather(j_ops, jp), tol
    )
    _close(
        t_mesh.weighted_vertex_reduce(t_ops, tm),
        j_mesh.weighted_vertex_reduce(j_ops, jm),
        tol,
    )


def test_norms(both):
    j_ops, t_ops, np_dt, t_dt, tol = both
    V, F = t_ops.av.shape[0], t_ops.area_f.shape[0]
    ja, ta = _inputs(7, (T, V), np_dt, t_dt)
    jb, tb = _inputs(8, (T + 1, F, 3), np_dt, t_dt)
    jd, td = _inputs(9, (T, 2, F, 3, 3), np_dt, t_dt)
    _close(t_norms.norm_sq_vertex(t_ops.av, ta, T), j_norms.norm_sq_vertex(j_ops.av, ja, T), tol)
    _close(
        t_norms.norm_sq_triangle(t_ops.area_f, tb, T + 1),
        j_norms.norm_sq_triangle(j_ops.area_f, jb, T + 1),
        tol,
    )
    _close(
        t_norms.norm_sq_decouple(t_ops.area_f, td, T),
        j_norms.norm_sq_decouple(j_ops.area_f, jd, T),
        tol,
    )


def test_project_soc(both):
    """Random points (some inside, some outside, some in the polar cone),
    plus zero tails, where the zero-norm guard must give the identity for
    a nonnegative head and the origin for a negative one (no NaN)."""
    j_ops, t_ops, np_dt, t_dt, tol = both
    V, F = t_ops.av.shape[0], t_ops.area_f.shape[0]
    rng = np.random.default_rng(10)
    fst = (3.0 * rng.standard_normal((T, V))).astype(np_dt)
    mid = rng.standard_normal((T, 2, F, 3, 3)).astype(np_dt)
    end = rng.standard_normal((T, V)).astype(np_dt)
    # Zero tails at time 0: every incident mid slot and the end scalar.
    mid[0] = 0.0
    end[0] = 0.0
    fst[0, : V // 2] = np.abs(fst[0, : V // 2])
    fst[0, V // 2 :] = -np.abs(fst[0, V // 2 :]) - 0.1
    ref = j_cones.project_soc(j_ops, jnp.asarray(fst), jnp.asarray(mid), jnp.asarray(end))
    port = t_cones.project_soc(
        t_ops, *(torch.from_numpy(a).to(t_dt) for a in (fst, mid, end))
    )
    for p, r in zip(port, ref):
        assert torch.isfinite(p).all()
        _close(p, r, tol)
    z_fst = port[0].numpy()
    np.testing.assert_array_equal(z_fst[0, : V // 2], fst[0, : V // 2])
    np.testing.assert_array_equal(z_fst[0, V // 2 :], 0.0)
