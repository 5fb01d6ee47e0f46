"""PyTorch device operators: mesh calculus, time stencils, cones, Laplacian.

Importing this package pins full-FP32 matrix products, mirroring
`dots_socp_tpu/ops/__init__.py:24-26`: TF32 on the spectral GEMMs
(`laplacian.spectral_solve`) or on the CG preconditioner GEMMs caps the
attainable KKT residual near 1e-2. This is a KKT-driven solver, so full
float32 is the rule, not a tuning knob.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> _torch.device:
    """The torch device for `device`; asking for CUDA without it raises.

    Nothing moves silently to the CPU: a solve asked for on the card runs
    there or fails.
    """
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            "(pass device='cpu' to run on the host)"
        )
    return dev
