# The port's own copy of dots_socp_tpu/geometry/native.py; only the import paths differ.
"""ctypes bindings for the native geometry runtime (native/geom_kernels.cpp).

Fast .off parsing and BFS mesh partitioning in C++; every entry point has a
pure-NumPy fallback so the package works without the compiled library. The
library is built on demand (`make -C native`, cached) the first time a
native function is requested.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_NAME = "libdots_geom.so"
_lib = None
_lib_tried = False


class _OffMesh(ctypes.Structure):
    _fields_ = [
        ("n_vertices", ctypes.c_int64),
        ("n_faces", ctypes.c_int64),
        ("vertices", ctypes.POINTER(ctypes.c_double)),
        ("faces", ctypes.POINTER(ctypes.c_int32)),
    ]


def _build_library() -> Path | None:
    """Compile the shared library if a toolchain is available."""
    src = _NATIVE_DIR / "geom_kernels.cpp"
    out = _NATIVE_DIR / _LIB_NAME
    if not src.exists():
        return None
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        logging.debug("native geometry build failed: %s", exc)
        return None
    return out if out.exists() else None


def get_library():
    """The loaded ctypes library, building it on first use; None if
    unavailable (callers fall back to NumPy)."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("DOTS_SOCP_TPU_NO_NATIVE"):
        return None
    path = _build_library()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        logging.debug("native geometry load failed: %s", exc)
        return None
    lib.parse_off.restype = ctypes.c_int
    lib.parse_off.argtypes = [ctypes.c_char_p, ctypes.POINTER(_OffMesh)]
    lib.free_off_mesh.restype = None
    lib.free_off_mesh.argtypes = [ctypes.POINTER(_OffMesh)]
    lib.bfs_partition.restype = ctypes.c_int
    lib.bfs_partition.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.halo_mark.restype = ctypes.c_int64
    lib.halo_mark.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib


def parse_off_native(path: str):
    """Parse an .off file with the C++ parser.

    Returns (vertices (V,3) float64, triangles (F,3) int32) or None when the
    native library is unavailable or parsing fails (caller falls back to the
    Python parser in `geometry.mesh_io`).
    """
    lib = get_library()
    if lib is None:
        return None
    mesh = _OffMesh()
    rc = lib.parse_off(str(path).encode(), ctypes.byref(mesh))
    if rc != 0:
        return None
    try:
        nv, nf = mesh.n_vertices, mesh.n_faces
        vertices = np.ctypeslib.as_array(mesh.vertices, shape=(nv, 3)).copy()
        triangles = np.ctypeslib.as_array(mesh.faces, shape=(nf, 3)).copy()
    finally:
        lib.free_off_mesh(ctypes.byref(mesh))
    return vertices, triangles


def bfs_partition(triangles: np.ndarray, n_vertices: int, n_parts: int):
    """Partition vertices into `n_parts` contiguous BFS blocks.

    Returns (part (V,) int32 block id per ORIGINAL vertex, perm (V,) int32 --
    new index i holds original vertex perm[i]; block b's vertices are the
    contiguous range [b*ceil(V/n_parts), ...) in the new ordering).

    Used to reorder the mesh before sharding so segment reductions stay
    local to a device (SURVEY section 7.3, mesh-dimension partitioning).
    """
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    part = np.empty(n_vertices, dtype=np.int32)
    perm = np.empty(n_vertices, dtype=np.int32)
    lib = get_library()
    if lib is not None:
        rc = lib.bfs_partition(
            n_vertices,
            triangles.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            triangles.shape[0],
            n_parts,
            part.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc == 0:
            return part, perm
    return _bfs_partition_numpy(triangles, n_vertices, n_parts)


def halo_vertices(triangles: np.ndarray, part: np.ndarray):
    """Boolean mask of vertices sharing a triangle with another partition."""
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    part = np.ascontiguousarray(part, dtype=np.int32)
    n_vertices = part.shape[0]
    lib = get_library()
    if lib is not None:
        out = np.zeros(n_vertices, dtype=np.uint8)
        lib.halo_mark(
            n_vertices,
            triangles.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            triangles.shape[0],
            part.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out.astype(bool)
    tp = part[triangles]  # (F, 3)
    cross = (tp != tp[:, :1]).any(axis=1)
    mask = np.zeros(n_vertices, dtype=bool)
    mask[triangles[cross].ravel()] = True
    return mask


def _bfs_partition_numpy(triangles, n_vertices, n_parts):
    """Pure-NumPy/Python fallback of `bfs_partition` (same output contract)."""
    from collections import deque

    adj = [[] for _ in range(n_vertices)]
    for a, b, c in triangles:
        adj[a] += [b, c]
        adj[b] += [a, c]
        adj[c] += [a, b]
    target = -(-n_vertices // n_parts)
    order = []
    seen = np.zeros(n_vertices, dtype=bool)
    for s in range(n_vertices):
        if seen[s]:
            continue
        seen[s] = True
        queue = deque([s])
        while queue:
            v = queue.popleft()
            order.append(v)
            for w in adj[v]:
                if not seen[w]:
                    seen[w] = True
                    queue.append(w)
    part = np.empty(n_vertices, dtype=np.int32)
    perm = np.asarray(order, dtype=np.int32)
    for i, v in enumerate(order):
        part[v] = min(i // target, n_parts - 1)
    return part, perm
