"""Plain reference: how far a returned transport is from the optimum of the
discrete dynamic optimal transport problem, worked out again from the mesh
and the two densities alone.

The problem (the SOCP discretisation of chlhnu/DOTs-SOCP): time nodes
k = 0..T at dt = 1/T, staggered slices t = 0..T-1 between them; P1 functions
on the vertices, piecewise-constant vectors on the triangles, vertex mass
av = one-ring area / 3. The potential phi (T+1, V) maximises

    sum_v phi[T, v] mu1[v] - phi[0, v] mu0[v]
    s.t.  (phi[t+1] - phi[t]) / dt + h[t] <= 0 at every (t, v),
          h[t, v] = sum_{f at v} area_f (|grad phi[t]|_f^2 + |grad phi[t+1]|_f^2) / (12 av_v),

and its multipliers are the staggered masses M (T, V) >= 0 with momenta
m (T+1, F, 3). Optimality (KKT) reads, in mass units:

    continuity   M[0] = mu0 - dt D[0], M[k] - M[k-1] = -dt D[k], M[T-1] = mu1 + dt D[T],
                 D[k] = div(area_f m[k]) (the negative adjoint of the P1 gradient)
    momentum     m[k]_f = rho[k]_f grad phi[k]_f, rho[k]_f the triangle's mean of
                 (M[k-1] + M[k]) / (2 av) (M[-1] = M[T] = 0)
    complementarity  M >= 0, the constraint <= 0, and M (constraint) = 0
    no gap       the objective equals (dt / 2) sum_k sum_f area_f m[k]_f . grad phi[k]_f,
                 the kinetic energy of the transport.

The program returns the density on the time-centred grid (its rows 0 and T
are mu0 and mu1, row k the mean of the staggered M[k-1] and M[k]), the
momenta area_f m (T+1, F, 3) and phi. From the centred density and the
continuity equation each staggered slice has two estimates, one from each of
its nodes; their difference is twice the mean of the two nodes' continuity
residuals, their mean is the M the other conditions use.

`residuals` returns four relative numbers, each 0 at an exact optimum:

    continuity   |difference of the two estimates| / |M|
    momentum     |m - rho grad phi| / (mean area + |m| + |rho grad phi|)
    complement   |max(c + M/av, 0) - M/av| / (mean av + |M/av| + |c|), c the constraint
    cost_gap     |cost reported - kinetic energy| / the larger of the two

with the norms of the program's own KKT table: squares weighted by vertex
mass or triangle area, averaged over the slices. Float64 NumPy and SciPy; it
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class Calculus:
    """P1 calculus of one triangle mesh, from its vertices and triangles."""

    def __init__(self, vertices, triangles):
        vertices = np.asarray(vertices, dtype=np.float64)
        tri = np.asarray(triangles, dtype=np.int64)
        p = vertices[tri]  # (F, 3 corners, 3 coords)
        normal = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        twice_area = np.linalg.norm(normal, axis=-1)
        unit = normal / twice_area[:, None]
        # grad of corner k's hat function: the unit normal crossed with the
        # opposite edge (corner k+1 to k+2), over twice the area.
        opposite = p[:, [2, 0, 1]] - p[:, [1, 2, 0]]
        hat_grad = np.cross(unit[:, None, :], opposite) / twice_area[:, None, None]
        n_v, n_f = vertices.shape[0], tri.shape[0]
        self.n_vertices, self.n_triangles = n_v, n_f
        self.area_f = 0.5 * twice_area
        self.av = np.bincount(tri.reshape(-1), np.repeat(self.area_f, 3), minlength=n_v) / 3.0
        rows = (np.arange(n_f)[:, None, None] * 3 + np.arange(3)[None, None, :])
        rows = np.broadcast_to(rows, (n_f, 3, 3)).reshape(-1)
        cols = np.broadcast_to(tri[:, :, None], (n_f, 3, 3)).reshape(-1)
        #: (3F, V): phi -> the gradient's three coordinates per triangle
        self.grad_op = sp.csr_matrix((hat_grad.reshape(-1), (rows, cols)), shape=(3 * n_f, n_v))
        self.div_op = (-self.grad_op.T).tocsr()
        #: (V, F): a triangle's value to each of its three vertices
        self.incidence = sp.csr_matrix(
            (np.ones(3 * n_f), (tri.reshape(-1), np.repeat(np.arange(n_f), 3))), shape=(n_v, n_f))
        self.corner_mean = (self.incidence.T / 3.0).tocsr()

    def grad(self, phi):
        """(K, V) -> (K, F, 3)."""
        phi = np.asarray(phi, dtype=np.float64)
        return (self.grad_op @ phi.T).T.reshape(-1, self.n_triangles, 3)

    def div(self, field):
        """(K, F, 3) -> (K, V): minus the adjoint of `grad`."""
        flat = np.asarray(field, dtype=np.float64).reshape(-1, 3 * self.n_triangles)
        return (self.div_op @ flat.T).T

    def laplacian_nnz(self) -> int:
        """Nonzeros of the cotangent Laplacian div(area grad) with its
        diagonal: the stored entries of the matrix a matvec applies."""
        lap = (self.div_op @ sp.diags(np.repeat(self.area_f, 3)) @ self.grad_op).tocsr()
        lap.eliminate_zeros()
        return int(lap.nnz)


def residuals(calc: Calculus, mu0, mu1, mu_centred, momentum, phi, cost) -> dict:
    """The four relative residuals of one returned transport (module doc)."""
    mu0, mu1 = (np.asarray(a, dtype=np.float64) for a in (mu0, mu1))
    mu_c = np.asarray(mu_centred, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    m_area = np.asarray(momentum, dtype=np.float64)  # area_f m, (T+1, F, 3)
    n_nodes = mu_c.shape[0]
    T = n_nodes - 1
    dt = 1.0 / T
    av, area_f = calc.av, calc.area_f

    div = calc.div(m_area)  # (T+1, V)
    from_left = np.concatenate([(mu0 - dt * div[0])[None], mu_c[1:T] - 0.5 * dt * div[1:T]])
    from_right = np.concatenate([mu_c[1:T] + 0.5 * dt * div[1:T], (mu1 + dt * div[T])[None]])
    mass = 0.5 * (from_left + from_right)  # (T, V)

    def norm_v(a, slices):  # mass-weighted, `a` a density
        return np.sqrt(np.einsum("tv,v->", a * a, av) / slices)

    def norm_f(a, slices):  # area-weighted, `a` a vector field
        return np.sqrt(np.einsum("tfc,f->", a * a, area_f) / slices)

    continuity = norm_v((from_left - from_right) / av, T) / norm_v(mass / av, T)

    grad = calc.grad(phi)  # (T+1, F, 3)
    zero = np.zeros((1, mass.shape[1]))
    node_density = 0.5 * (np.concatenate([zero, mass]) + np.concatenate([mass, zero])) / av
    rho_f = (calc.corner_mean @ node_density.T).T  # (T+1, F)
    m = m_area / area_f[None, :, None]
    rho_grad = rho_f[:, :, None] * grad
    momentum_res = norm_f(m - rho_grad, n_nodes) / (
        area_f.mean() + norm_f(m, n_nodes) + norm_f(rho_grad, n_nodes))

    sq = (grad * grad).sum(-1) * area_f[None, :]  # (T+1, F)
    h = (calc.incidence @ (sq[:-1] + sq[1:]).T).T / (12.0 * av)
    constraint = np.diff(phi, axis=0) / dt + h  # (T, V)
    density = mass / av
    gap = np.maximum(constraint + density, 0.0) - density
    complement = norm_v(gap, T) / (av.mean() + norm_v(density, T) + norm_v(constraint, T))

    kinetic = 0.5 * dt * float(np.einsum("kfc,kfc,f->", m, grad, area_f))
    # Distinct densities cost something to transport: both zero is no solution.
    scale = max(abs(kinetic), abs(float(cost)))
    cost_gap = abs(float(cost) - kinetic) / scale if scale > 0 else float("inf")
    return {"continuity": float(continuity), "momentum": float(momentum_res),
            "complement": float(complement), "cost_gap": float(cost_gap)}


def dual_objective(phi, mu0, mu1) -> float:
    """sum_v phi[T] mu1 - phi[0] mu0: the transport cost the potential certifies."""
    phi = np.asarray(phi, dtype=np.float64)
    mu0, mu1 = (np.asarray(a, dtype=np.float64) for a in (mu0, mu1))
    return float(phi[-1] @ mu1 - phi[0] @ mu0)
