"""DOTs-SOCP on PyTorch and CUDA: dynamic optimal transport on surfaces.

The PyTorch port of `dots_socp_tpu`, beside it in the same repository. The
JAX package stays the reference: every module here has its counterpart at the
same path there (`ops/laplacian.py::cg_solve`, `solver/step.py::iteration`,
...), and the tests hold the two together on the same inputs.

The port runs the single-device iALM solve end to end. Plain tensor work is
PyTorch; the one TPU kernel of the JAX package (the windowed cotan-Laplacian
SpMV of the matrix-free CG phi-solve) is a hand-written CUDA C++ kernel for
Hopper (`ops/csrc/window_spmv.cu`). The jax-free host modules of the JAX
package (geometry, data, models, config, utils, interface) are reused by
import; nothing here imports `jax`.

Public API, the same contract as the JAX package:
  solver(n_time, geometry, device="cuda", **kw) -> (SolutionDotData, RunningHistory)
"""

__version__ = "0.1.0"

_LAZY = {
    "solver": "dots_socp_torch.solver",
    "solver_raw": "dots_socp_torch.solver",
    "solver_socp": "dots_socp_torch.solver",
}


def __getattr__(name):
    # Lazy top-level API: `import dots_socp_torch.ops...` stays light. Once
    # the `solver` subpackage is imported, the name resolves to the module,
    # which is callable (`dots_socp_torch/solver/__init__.py`).
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["solver_socp", "solver_raw", "solver"]
