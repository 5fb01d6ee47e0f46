"""The iALM step after the phi solve, fused (kernel K6).

The JAX package's iteration runs steps 1b, 2 and 3 (the SOC projection, the
closed-form q/lambda solve and the multiplier ascent) as XLA fusions
(`dots_socp_tpu/solver/step.py`). The port's torch route of the same step,
`solver/step.py::_after_phi`, launches dozens of kernels and passes over the
(T, 2, F, 3, 3) cone blocks many times; `ialm_step` takes the
whole step as three launches of `csrc/ialm_step.cu` (which explains its
design) and writes every output once, in place, into the state's own
tensors. Its sums are PyTorch's, in PyTorch's order, so it gives the torch
route's bits.

`ialm_step(ops, state, phi, scal, dt)` updates `state`'s arrays (the names
in `OUTPUTS`) in place, given the new phi and the step's scalars `scal`
(`SCALARS`, a tensor of the work dtype computed by the torch route's own
ops). It takes contiguous CUDA tensors: float32 work with float32 or
float64 phi, or float64 throughout, and raises on anything else;
`supports` says beforehand whether a problem's arrays fit. On the CPU there
is no kernel: the solver's gate (`solver/step.py::_fused_route`) keeps the
torch route there, and `solver/step.py::_after_phi_in_place` copies the
torch route's values in where it is asked for the fused step. `KERNEL_LAUNCHES` counts its launches (three per call;
replayed with the CUDA graphs); inside `torch_route()` the solver takes the
torch route on the card too (for comparisons).
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from dots_socp_torch.ops import graphs

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch), counted through the graphs' replays.
KERNEL_LAUNCHES = 0


def _set_launches(n):
    global KERNEL_LAUNCHES
    KERNEL_LAUNCHES = n


graphs.register_counter(lambda: KERNEL_LAUNCHES, _set_launches, "ialm_step.launches")

#: The state arrays the step writes, in the kernel's order.
OUTPUTS = ("A", "B", "lambda_c", "z_fst", "z_mid", "z_end", "mu", "E", "beta_fst", "beta_mid",
           "beta_end", "dt_phi", "dx_phi")
#: The step's scalars, in `scal`'s order (`csrc/ialm_step.cu::Scalar`).
SCALARS = ("scale_z", "scale_z_sqrt3", "tau", "constant_d", "inv_a2", "a1_a2", "interior",
           "endpoint", "c_lambda")
#: Launches per call, in order (`csrc/ialm_step.cu`).
LAUNCHES = 3
STAGE_NAMES = ("cone", "vertex", "face")
#: The vertex sum holds D < 2 x 32 incidence slots.
MAX_DEGREE = 63

_FUSED = True


def enabled() -> bool:
    """False inside `torch_route()`."""
    return _FUSED


@contextlib.contextmanager
def torch_route():
    """Take the torch route on the card too, for its extent (solver runners
    made inside it; the card tests and `chip_smoke.py` hold the kernel to
    it)."""
    global _FUSED
    before = _FUSED
    _FUSED = False
    try:
        yield
    finally:
        _FUSED = before


def supports(ops, work_dtype, phi_dtype) -> bool:
    """Whether the kernel takes a problem with these operator leaves and
    dtypes: float32 work with float32 or float64 phi, or float64 throughout,
    the leaves in the work dtype, at most MAX_DEGREE incidence slots."""
    pairs = {(torch.float32, torch.float32), (torch.float32, torch.float64),
             (torch.float64, torch.float64)}
    return ((work_dtype, phi_dtype) in pairs
            and all(t.dtype == work_dtype for t in (ops.grad_basis, ops.inc_mask, ops.diag_soc))
            and ops.inc_table.shape[-1] <= MAX_DEGREE)


def inv_dt(dt, phi_dtype) -> float:
    """1 / dt as PyTorch's division of a CUDA tensor by a Python number
    takes it: the reciprocal in double, rounded to the tensor's precision,
    then a product in that precision (measured on an H100, torch 2.11: at
    dt = 1/7 the reciprocal of float32(dt) is 6.9999995, the rounded double
    reciprocal 7.0, and only the latter gives torch's bits)."""
    inv = 1.0 / float(dt)
    return float(np.float32(inv)) if phi_dtype == torch.float32 else inv


def _check(ops, state, phi, scal):
    """The kernel's input contract; returns (T, V, F, D)."""
    work = state.A.dtype
    if not supports(ops, work, phi.dtype):
        raise TypeError(f"ialm_step takes float32 work with float32 or float64 phi, or float64, "
                        f"the leaves in the work dtype and at most {MAX_DEGREE} incidence slots; "
                        f"got work {work}, phi {phi.dtype}")
    T, V = state.A.shape
    F = ops.tri.shape[0]
    D = ops.inc_table.shape[-1]
    device = state.A.device
    shapes = {
        "A": (T, V), "B": (T + 1, F, 3), "lambda_c": (T, V), "z_fst": (T, V),
        "z_mid": (T, 2, F, 3, 3), "z_end": (T, V), "mu": (T, V), "E": (T + 1, F, 3),
        "beta_fst": (T, V), "beta_mid": (T, 2, F, 3, 3), "beta_end": (T, V), "dt_phi": (T, V),
        "dx_phi": (T + 1, F, 3),
    }
    arrays = {name: (getattr(state, name), shape, work) for name, shape in shapes.items()}
    arrays.update(
        phi=(phi, (T + 1, V), phi.dtype), tri=(ops.tri, (F, 3), torch.int64),
        grad_basis=(ops.grad_basis, (F, 3, 3), work),
        inc_table=(ops.inc_table, (V, D), torch.int64), inc_mask=(ops.inc_mask, (V, D), work),
        diag_soc=(ops.diag_soc, (F, 3), work), scal=(scal, (len(SCALARS),), work))
    for name, (t, shape, dtype) in arrays.items():
        if (t.device != device or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(f"ialm_step: {name} must be contiguous {shape} {dtype} on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return T, V, F, D


def ialm_step(ops, state, phi, scal, dt):
    """Steps 1b, 2 and 3 of one iteration through the kernel, in place into
    `state`'s arrays `OUTPUTS` (see the module's docstring). A refused
    launch raises."""
    from dots_socp_torch.ops import _build

    global KERNEL_LAUNCHES
    if state.A.device.type != "cuda":
        raise ValueError(f"ialm_step runs on the card, not on {state.A.device}")
    T, V, F, _ = sizes = _check(ops, state, phi, scal)
    work = state.A.dtype
    sq = torch.empty((T, F, 3), dtype=work, device=phi.device)  # launch 1 -> 2
    lam = torch.empty((T, V), dtype=work, device=phi.device)  # launch 2 -> 3
    tensors = [getattr(state, name) for name in OUTPUTS] + [
        phi, ops.tri, ops.grad_basis, ops.inc_table, ops.inc_mask, ops.diag_soc, scal, sq, lam]
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    with torch.cuda.device(phi.device):  # the C side launches on the current device
        err = _build.load().dots_ialm_step(
            ptrs, work.itemsize, phi.dtype.itemsize, inv_dt(dt, phi.dtype),
            (ctypes.c_int * 4)(*sizes), torch.cuda.current_stream(phi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ialm_step kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += LAUNCHES
    return state
