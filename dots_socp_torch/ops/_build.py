"""Build and load the port's CUDA kernels, B1, B1-f64 and B2
(`csrc/window_spmv.cu`), K4 and K4-f64 (`csrc/cg_step.cu`) and K6
(`csrc/ialm_step.cu`): nvcc into one plain-C shared library, bound with
ctypes.

At first use, every source under `csrc/` compiles at the same time, one
nvcc each, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c

and the objects link (`nvcc -shared`) into
`libdots_torch_kernels_<sha of sources and flags>.so` under
`$DOTS_SOCP_CACHE_DIR/kernels/` when that variable is set (the root the
factor caches use, `ops/laplacian.py::_ritz_cache_dir`), else under
`build/kernels/` at the repository root (`.gitignore` lists `build/`); the
directory is resolved at each build, not at import. The compiler's log and
the temporary file of a build in progress lie beside the library. A library
whose hash matches is reused. A missing `nvcc` or a failed compile raises:
there is no fallback. `nvcc` is looked up on PATH, then under $CUDA_HOME
(default /usr/local/cuda).
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
SOURCES = ("window_spmv.cu", "cg_step.cu", "ialm_step.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def build_dir() -> Path:
    """Where the kernel library is built: `$DOTS_SOCP_CACHE_DIR/kernels` when
    the variable is set, else `<repository>/build/kernels`."""
    root = os.environ.get("DOTS_SOCP_CACHE_DIR")
    if root:
        return Path(root) / "kernels"
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return build_dir() / f"libdots_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless a library of the same sources exists.

    Returns (library path, seconds spent compiling; 0.0 when reused). The
    compilers' output (with -Xptxas -v) goes to the same path + ".log".
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    nvcc = nvcc_path()
    objects = [tmp.with_name(f"{tmp.name}.{Path(name).stem}.o") for name in SOURCES]
    t0 = time.perf_counter()
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
                for name, obj in zip(SOURCES, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    steps = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(compiles, procs)]
    if all(rc == 0 for _, _, rc in steps):
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        steps.append((link, proc.stdout, proc.returncode))
    seconds = time.perf_counter() - t0
    for obj in objects:
        obj.unlink(missing_ok=True)
    out.with_name(out.name + ".log").write_text(
        "".join(" ".join(cmd) + "\n" + text for cmd, text, _ in steps))
    failed = [(cmd, text, rc) for cmd, text, rc in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{text[-4000:]}")
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
        for fn in (lib.dots_window_spmv_f32, lib.dots_window_spmv_f64):
            fn.argtypes = [p] * 5 + [i] * 8 + [p]  # B1, B1-f64: 5 arrays, 8 sizes, the stream
            fn.restype = i
        fn = lib.dots_sharded_window_spmv_f32  # B2: 7 arrays, 9 sizes, the stream
        fn.argtypes = [p] * 7 + [i] * 9 + [p]
        fn.restype = i
        for fn in (lib.dots_cg_step_f32, lib.dots_cg_step_f64):
            # K4, K4-f64: the stage, 22 arrays, the geometry, 3 sizes, the stream
            fn.argtypes = [i] + [p] * 22 + [ctypes.POINTER(i)] + [i] * 3 + [p]
            fn.restype = i
        # K6: the 22 arrays, the element sizes, 1 / dt, the 4 sizes, the stream
        fn = lib.dots_ialm_step
        fn.argtypes = [ctypes.POINTER(p), i, i, ctypes.c_double, ctypes.POINTER(i), p]
        fn.restype = i
        _lib = lib
    return _lib
