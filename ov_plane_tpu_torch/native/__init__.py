"""Native (C++) host-side components of the port: the Delaunay triangulation
of the host plane detector.

A copy of the Delaunay part of ``ov_plane_tpu/native``: ``delaunay.cpp`` is
compiled with ``g++`` at first use into ``build/ov_plane_tpu_torch/`` beside
the package (the library's name carries a hash of the source and the flags)
and called through ``ctypes``, which releases the GIL during the call. A
build or load that fails raises: there is no fallback to another
triangulation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ov_plane_tpu_torch"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def lib_path(name: str, src_dir: Path = SRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + (src_dir / f"{name}.cpp").read_bytes())
    return build_dir / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str = "delaunay", src_dir: Path = SRC_DIR, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Compile ``<name>.cpp`` (once per source and flags) and load it.
    Raises RuntimeError when the compiler is missing or fails."""
    with _LOCK:
        key = str(src_dir / name)
        if key in _LIBS:
            return _LIBS[key]
        out = lib_path(name, src_dir, build_dir)
        if not out.exists():
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, str(src_dir / f"{name}.cpp"), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"g++ could not be run to build {name}.cpp: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {name}.cpp:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.delaunay_triangulate.restype = ctypes.c_int
        lib.delaunay_triangulate.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _LIBS[key] = lib
        return lib


def delaunay(points_xy: np.ndarray) -> np.ndarray:
    """Delaunay-triangulate 2D points [n, 2]: [T, 3] int32 vertex indices
    (native Bowyer-Watson, ``delaunay.cpp``)."""
    pts = np.ascontiguousarray(points_xy, dtype=np.float64)
    n = len(pts)
    if n < 3:
        return np.zeros((0, 3), np.int32)
    lib = build("delaunay")
    max_tris = 3 * n
    out = np.zeros((max_tris, 3), np.int32)
    count = lib.delaunay_triangulate(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_tris)
    if count < 0:
        raise RuntimeError(f"the native Delaunay triangulation failed (code {count}) on {n} points")
    return out[:count]
