"""Build and load the port's CUDA kernels (nvcc into a plain-C shared library,
bound with ctypes).

At first use, the sources under `csrc/` compile with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

into `build/kernels/libdots_torch_kernels_<sha of sources and flags>.so` at
the repository root (`.gitignore` lists `build/`). A library whose hash
matches is reused. A missing `nvcc` or a failed compile raises: there is no
fallback. `nvcc` is looked up on PATH, then under $CUDA_HOME (default
/usr/local/cuda).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("window_spmv.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the log
)

_lib = None  # the loaded library, shared by every wrapper in the process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME; the CUDA toolkit is "
        "needed to build the port's kernels"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libdots_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless a library of the same sources exists.

    Returns (library path, seconds spent compiling; 0.0 when reused). The
    compiler's output (with -Xptxas -v) goes to the same path + ".log".
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(CSRC / name) for name in SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out.with_name(out.name + ".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)
    return out, seconds


def build_log() -> str:
    """The compiler's output of the current library's build, if kept."""
    log = library_path().with_name(library_path().name + ".log")
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its entry points."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.dots_window_spmv_f32
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        _lib = lib
    return _lib
