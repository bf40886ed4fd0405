"""The filter update's two dense reductions: CUDA kernels and plain versions.

Counterpart of ``ov_plane_tpu/ops/pallas_kernels.py``, whose two Pallas TPU
kernels become one CUDA C++ tile kernel (``csrc/gram_tile.cuh``) compiled
for ``sm_90a``:

* :func:`gram_reduce` — (Λ, η) = (HᵀH, Hᵀr), H [B, M, D]; replaces
  ``gram_reduce_pallas``. Compresses the stacked MSCKF rows.
* :func:`kalman_downdate` — (P − WᵀW, Wᵀu), W [B, M, D]; replaces
  ``kalman_downdate_pallas``. Closes the square-root EKF update.

Both outputs' matrices are the upper triangle mirrored, so they are bitwise
symmetric; the plain versions (:func:`gram_reduce_ref`,
:func:`kalman_downdate_ref`) compute the same function with PyTorch ops.

Dispatch is by the tensors' device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (at any row count) or
raises. The kernels are built with ``nvcc`` at first use into
``build/ov_plane_tpu_torch/`` beside the package (one shared library per
source, named by a hash of the sources and flags) and loaded through
``ctypes``. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ov_plane_tpu_torch"
SOURCES = {"gram_reduce": "gram_reduce.cu", "kalman_downdate": "kalman_downdate.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / SOURCES[name], CSRC / "gram_tile.cuh"):
        h.update(f.read_bytes())
    return BUILD_DIR / f"libovp_{name}_{h.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    n_ptr = 4 if name == "gram_reduce" else 5
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"ovp_{name}_{suffix}")
        fn.argtypes = [p] * n_ptr + [i, i, i, p]
        fn.restype = i
    return lib


def build(names=tuple(SOURCES)) -> dict[str, str]:
    """Compile the named kernels that are not built yet (one ``nvcc`` per
    source, all started together) and load them. Returns each source's
    compiler report (``-Xptxas -v``: registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _LIBS:
            continue
        out = _lib_path(name)
        if out.exists():
            _LIBS[name] = _declare(ctypes.CDLL(str(out)), name)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}:\n{reports[name]}")
            continue
        os.replace(tmp, out)
        _LIBS[name] = _declare(ctypes.CDLL(str(out)), name)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def _launch(name: str, dtype: torch.dtype, *args) -> None:
    if name not in _LIBS:
        build((name,))
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    err = getattr(_LIBS[name], f"ovp_{name}_{suffix}")(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError_t {err}")


def _check_cuda(tensors: dict[str, torch.Tensor]) -> None:
    first = next(iter(tensors.values()))
    for k, t in tensors.items():
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"{k} must lie on the same CUDA device as the other inputs")
        if t.dtype != first.dtype or t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{k} must be float32 or float64 like the other inputs, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
    if first.shape[0] > 65535:
        raise ValueError("at most 65535 streams per launch")


def _mirror_upper(A: torch.Tensor) -> torch.Tensor:
    return A.triu() + A.triu(1).transpose(-1, -2)


def gram_reduce_ref(H: torch.Tensor, r: torch.Tensor):
    """Plain version of :func:`gram_reduce`."""
    Ht = H.transpose(-1, -2)
    return _mirror_upper(Ht @ H), (Ht @ r[..., None])[..., 0]


def kalman_downdate_ref(cov: torch.Tensor, W: torch.Tensor, u: torch.Tensor):
    """Plain version of :func:`kalman_downdate`."""
    Wt = W.transpose(-1, -2)
    return _mirror_upper(cov - Wt @ W), (Wt @ u[..., None])[..., 0]


def gram_reduce(H: torch.Tensor, r: torch.Tensor):
    """(Λ [B, D, D], η [B, D]) = (HᵀH, Hᵀr) for H [B, M, D], r [B, M].

    Zero (masked) rows contribute nothing. Λ is bitwise symmetric.
    """
    if H.dim() != 3 or r.shape != H.shape[:2]:
        raise ValueError(f"expected H [B, M, D] and r [B, M], got {tuple(H.shape)}, {tuple(r.shape)}")
    if H.device.type == "cpu" and r.device.type == "cpu":
        return gram_reduce_ref(H, r)
    _check_cuda({"H": H, "r": r})
    B, M, D = H.shape
    lam = torch.empty(B, D, D, dtype=H.dtype, device=H.device)
    eta = torch.empty(B, D, dtype=H.dtype, device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("gram_reduce", H.dtype, H.data_ptr(), r.data_ptr(), lam.data_ptr(),
                eta.data_ptr(), B, M, D, stream)
    gram_reduce.launches += 1
    return lam, eta


def kalman_downdate(cov: torch.Tensor, W: torch.Tensor, u: torch.Tensor):
    """(P' [B, D, D], dx [B, D]) = (cov − WᵀW, Wᵀu) for W [B, M, D], u [B, M].

    P' is the upper triangle of cov − WᵀW mirrored, so it is bitwise
    symmetric whatever the rounding.
    """
    B, M, D = W.shape
    if cov.shape != (B, D, D) or u.shape != (B, M):
        raise ValueError(f"expected cov [B, D, D], W [B, M, D], u [B, M], got "
                         f"{tuple(cov.shape)}, {tuple(W.shape)}, {tuple(u.shape)}")
    if all(t.device.type == "cpu" for t in (cov, W, u)):
        return kalman_downdate_ref(cov, W, u)
    _check_cuda({"cov": cov, "W": W, "u": u})
    new_cov = torch.empty(B, D, D, dtype=W.dtype, device=W.device)
    dx = torch.empty(B, D, dtype=W.dtype, device=W.device)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("kalman_downdate", W.dtype, cov.data_ptr(), W.data_ptr(), u.data_ptr(),
                new_cov.data_ptr(), dx.data_ptr(), B, M, D, stream)
    kalman_downdate.launches += 1
    return new_cov, dx


gram_reduce.launches = 0
kalman_downdate.launches = 0


def reset_launch_counts() -> None:
    gram_reduce.launches = 0
    kalman_downdate.launches = 0
