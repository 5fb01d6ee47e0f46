"""The least bytes the card must move for the work a CG phi solve needs, and
the card's published peaks: the yardstick of the roofline metrics.

A frozen copy of the arithmetic of the program's
`kernel_timing.{window_bound,cg_step_bound}`, written in terms of the
function computed rather than of one implementation of it, so that a later
kernel that fuses or replaces B1 or K4 is measured against the same bytes:

* one Laplacian matvec over `lanes` rows of a V-vertex field reads the field
  and writes the result once (2 V lanes floats) and reads each stored entry
  of the matrix once (a float32 value and an int32 column: 8 bytes); the
  entries are those of the mesh's cotangent Laplacian with its diagonal
  (`optimality.Calculus.laplacian_nnz`). `window_bound` also charges B1's
  tile starts (4 bytes per tile of rows), which belong to B1's layout, not
  to the function; they are left out (under 0.1% of the bytes).
* one inner PCG iteration after the matvec (K4's part) reads the matvec's
  result, x, r, p and the Jacobi rows (lanes x V floats each), three vertex
  vectors and eight per-row scalars, and writes x, r and p: `cg_step_bound`
  less the Ritz vectors that the deflation products (cuBLAS, outside K4)
  read.

Peaks: NVIDIA H100 SXM data sheet, 3.35 TB/s of HBM3, 67 TFLOP/s float32
outside the tensor cores, at the 700 W power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def matvec_work(n_vertices: int, lanes: int, nnz: int) -> dict:
    """Bytes and flops of one Laplacian matvec over `lanes` rows."""
    return {"bytes": 2 * n_vertices * lanes * 4 + nnz * 8, "flops": 2 * nnz * lanes}


def cg_update_work(n_vertices: int, lanes: int) -> dict:
    """Bytes and flops of one inner PCG iteration's update after the matvec,
    the deflation products aside."""
    return {"bytes": (8 * lanes * n_vertices + 3 * n_vertices + 8 * lanes) * 4,
            "flops": 20 * lanes * n_vertices}


def least_seconds(work: dict) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_flops = work["flops"] / FP32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")
