"""DOTs-SOCP on PyTorch and CUDA: dynamic optimal transport on surfaces.

The PyTorch port of `dots_socp_tpu`, beside it in the same repository. The
JAX package stays the reference: every module here has its counterpart at the
same path there (`ops/laplacian.py::cg_solve`, `solver/step.py::iteration`,
...), and the tests hold the two together on the same inputs.

The port runs the iALM solve end to end on one device, and on a
space-sharded mesh of one process per shard (`parallel/`, over
torch.distributed), with snapshots and resume (`utils/snapshot.py`, the JAX
package's file format), and carries the run-to-completion surface: the
replication harness (`replication/`), the demo (`demo.py`) and the
large-mesh solve to tolerance (`scripts/solve_large.py`). Plain tensor work is PyTorch; the JAX package's Pallas
kernel (the windowed cotan-Laplacian SpMV of the matrix-free CG phi-solve),
in its single-device (B1) and per-shard (B2) forms, is hand-written CUDA
C++ for Hopper (`ops/csrc/window_spmv.cu`). The host modules (geometry,
data, models, config, utils, interface, the CLI's parser) are the port's own
copies of the JAX package's, under the same names; nothing here imports
`jax` or `dots_socp_tpu`. Only the data files are shared: they are read where
they lie (`config/path_config.toml`).

Public API, the same contract as the JAX package:
  solver(n_time, geometry, device="cuda", **kw) -> (SolutionDotData, RunningHistory)
"""

import os as _os

__version__ = "0.1.0"

# torch.profiler (Kineto) by default tears CUPTI down after every session and
# sets it up again at the next; a session then records no device event now
# and then, several in a row (`scripts/profiler_loss.py`). The port keeps
# CUPTI up between sessions, as PyTorch's profiler itself does beside CUDA
# graphs on older CUDA; a value the caller set stays.
_os.environ.setdefault("TEARDOWN_CUPTI", "0")

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
