"""The filter update's two dense reductions: CUDA kernels and plain versions.

Counterpart of ``ov_plane_tpu/ops/pallas_kernels.py``, whose two Pallas TPU
kernels become the Gram kernels of ``csrc/gram_tile.cuh``, compiled for
``sm_90a``:

* :func:`gram_reduce` — (Λ, η) = (HᵀH, Hᵀr), H [B, M, D]; replaces
  ``gram_reduce_pallas``. Compresses the stacked MSCKF rows.
* :func:`kalman_downdate` — (P − WᵀW, Wᵀu), W [B, M, D]; replaces
  ``kalman_downdate_pallas``. Closes the square-root EKF update.

Both outputs' matrices are the upper triangle mirrored, so they are bitwise
symmetric, and two calls give the same bits; the plain versions
(:func:`gram_reduce_ref`, :func:`kalman_downdate_ref`) compute the same
function with PyTorch ops.

Dispatch is by the tensors' device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernels (at any row count) or
raises. How a call divides the work is a pure function: :func:`launch_plan`
for the gram (row ranges, tile groups, chunk rows, shared memory, the
partials' workspace, which the wrapper allocates with ``torch.empty``) and
:func:`stream_plan` for the downdate (tile groups, staging). The kernels
are built with ``nvcc`` at first use into ``build/ov_plane_tpu_torch/``
beside the package (one shared library per source, named by a hash of the
flags and of every ``csrc/`` file the source includes) and loaded through
``ctypes``. Each wrapper counts its calls in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ov_plane_tpu_torch"
SOURCES = {"gram_reduce": "gram_reduce.cu", "kalman_downdate": "kalman_downdate.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}

TILE = 32            # warp tile edge of csrc/gram_tile.cuh
STAGES = 3           # its ring of bulk-copy buffers, at most
MAX_WARPS = 6        # warp tiles per block
BLOCKS_PER_SM = 3    # gram_rows_kernel's launch bounds
MIN_ROWS = 32        # rows per block, at least
STAGE_BYTES = 12288  # padded rows staged per chunk, at most
BAR_BYTES = 128      # the ring's mbarriers
STAGE_PAD = TILE + 1  # row length of the epilogue's padded shared tile
MAX_SMEM = 227 * 1024  # dynamic shared memory of one block, at most
STREAM_WARPS = 8     # gram_stream_kernel's warps per block, at most (launch bounds 256 threads)


class LaunchPlan(NamedTuple):
    """How one call divides its work (``csrc/gram_tile.cuh``).
    ``gram_rows_kernel`` runs on grid (blocks, groups) with ``32·warps``
    threads and ``smem_bytes`` of dynamic shared memory per block. Block i
    takes rows [i·rows_per_block, (i+1)·rows_per_block) of the B·M rows, in
    chunks of at most ``chunk_rows`` rows (a chunk also ends at its stream's
    end) through a ring of ``stages`` copy buffers. Group g computes upper
    warp tiles [g·warps, (g+1)·warps), numbered row by row. The partials fill
    a workspace of ``workspace`` values, [B, max_parts, upper tiles, 32, 32]:
    block i writes stream b's partial as part i − ⌊b·M / rows_per_block⌋.
    Then ``gram_out_kernel`` runs one block per (upper tile, stream)."""
    blocks: int
    groups: int
    warps: int
    chunk_rows: int
    stages: int
    max_parts: int
    smem_bytes: int
    rows_per_block: int
    workspace: int


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, M: int, D: int, itemsize: int, n_sm: int = 132) -> LaunchPlan:
    """The launch for X [B, M, D] of ``itemsize``-byte floats on a card of
    ``n_sm`` SMs.

    The (D+1)×(D+1) augmented Gram has ⌈(D+1)/32⌉ column tiles; at most 6 of
    its upper tiles go to a block, one warp each. The B·M rows are cut into
    equal ranges of at least 32 rows, at most three blocks per SM (one wave):
    every SM does the same work whatever B and M are, and each stream's
    partials number at most ⌈M / range⌉ + 1."""
    ntc = (D + TILE) // TILE
    ld = TILE * ntc
    n_upper = ntc * (ntc + 1) // 2
    groups = -(-n_upper // MAX_WARPS)
    warps = -(-n_upper // groups)
    groups = -(-n_upper // warps)
    chunk_rows = max(1, min(TILE, STAGE_BYTES // (ld * itemsize), M))
    rows = B * M
    if rows == 0:
        return LaunchPlan(0, groups, warps, chunk_rows, 1, 0, 0, 1, 0)
    blocks = max(1, min(-(-rows // MIN_ROWS), BLOCKS_PER_SM * n_sm // groups))
    rows_per_block = -(-rows // blocks)
    blocks = -(-rows // rows_per_block)
    max_parts = min(blocks, -(-M // rows_per_block) + 1)
    stages = min(STAGES, -(-rows_per_block // chunk_rows) + -(-rows_per_block // M) + 1)
    raw = -(-chunk_rows * D * itemsize // 128) * 128
    smem = BAR_BYTES + stages * raw + 2 * chunk_rows * ld * itemsize
    return LaunchPlan(blocks, groups, warps, chunk_rows, stages, max_parts, smem, rows_per_block,
                      B * max_parts * n_upper * TILE * TILE)


class StreamPlan(NamedTuple):
    """How one call of ``gram_stream_kernel`` (``csrc/gram_tile.cuh``)
    divides its work: grid (groups, B), ``threads`` per block and
    ``smem_bytes`` of dynamic shared memory. Block (g, b) runs every row of
    stream b, in chunks of ``chunk_rows`` through a ring of ``stages`` copy
    buffers, for the upper warp tiles [g·tiles, (g+1)·tiles), numbered row by
    row. Each tile has threads / (32·tiles) warps, one per row slice of a
    chunk."""
    groups: int
    tiles: int
    threads: int
    chunk_rows: int
    stages: int
    smem_bytes: int


def _staging_bytes(rows: int, M: int, D: int, ld: int, itemsize: int, stages: int) -> int:
    """Shared memory of ``for_each_chunk`` for chunks of ``rows`` rows: the
    barriers, ``stages`` raw spans, and the padded tiles (one when the M rows
    of a stream are a single chunk, else two)."""
    raw = -(-rows * D * itemsize // 128) * 128
    pads = 1 if 0 < M <= rows else 2
    return BAR_BYTES + stages * raw + pads * rows * ld * itemsize


@functools.lru_cache(maxsize=256)
def stream_plan(B: int, M: int, D: int, itemsize: int, n_sm: int = 132) -> StreamPlan:
    """The launch for X [B, M, D] of ``itemsize``-byte floats on a card of
    ``n_sm`` SMs, one stream per block and no split of rows.

    The upper tiles are spread over groups of 1 to 6 tiles, enough of them
    that B·groups ≥ ``n_sm`` blocks where the tiles allow. A stream's M rows are staged as one chunk, one bulk copy, when
    they fit in a block's shared memory, else in chunks as in
    :func:`launch_plan`. Each tile's rows are cut into as many slices (one
    warp each) as fit in 8 warps. The epilogue reuses the staging memory for
    a padded 32×33 tile per warp."""
    ntc = (D + TILE) // TILE
    ld = TILE * ntc
    n_upper = ntc * (ntc + 1) // 2
    want = max(-(-n_upper // MAX_WARPS), -(-n_sm // max(B, 1)))
    tiles = max(1, min(MAX_WARPS, n_upper // want))
    groups = -(-n_upper // tiles)
    threads = TILE * tiles * max(1, STREAM_WARPS // tiles)
    rows, stages = max(M, 1), 1
    if _staging_bytes(rows, M, D, ld, itemsize, 1) > MAX_SMEM:
        rows = max(1, min(TILE, STAGE_BYTES // (ld * itemsize), M))
        stages = min(STAGES, -(-M // rows))
    smem = max(_staging_bytes(rows, M, D, ld, itemsize, stages),
               BAR_BYTES + threads * STAGE_PAD * itemsize)
    return StreamPlan(groups, tiles, threads, rows, stages, smem)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """The kernel's source and every file under ``csrc/`` that it includes,
    directly or through another header (quoted ``#include`` lines)."""
    todo, seen = [CSRC / SOURCES[name]], []
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        for inc in _INCLUDE.findall(f.read_bytes()):
            g = (f.parent / inc.decode()).resolve()
            if g.is_relative_to(CSRC) and g.exists():
                todo.append(g)
    return seen


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in source_files(name):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libovp_{name}_{h.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "gram_reduce":  # H, r, Λ, η, the workspace; B, M, D, the plan, the stream
        args = [p] * 5 + [i] * 10 + [ctypes.c_longlong, p]
    else:  # P, W, u, P', dx; B, M, D, the plan, the stream
        args = [p] * 5 + [i] * 9 + [p]
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"ovp_{name}_{suffix}")
        fn.argtypes = args
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


def _plan_args(plan: LaunchPlan) -> tuple:
    return (plan.blocks, plan.groups, plan.warps, plan.chunk_rows, plan.stages, plan.max_parts,
            plan.smem_bytes, plan.rows_per_block)


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
    plan = launch_plan(B, M, D, H.element_size(), _sm_count(H.device.index))
    ws = torch.empty(plan.workspace, dtype=H.dtype, device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("gram_reduce", H.dtype, H.data_ptr(), r.data_ptr(), lam.data_ptr(), eta.data_ptr(),
                ws.data_ptr(), B, M, D, *_plan_args(plan), stream)
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
    plan = stream_plan(B, M, D, W.element_size(), _sm_count(W.device.index))
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("kalman_downdate", W.dtype, cov.data_ptr(), W.data_ptr(), u.data_ptr(), new_cov.data_ptr(),
                dx.data_ptr(), B, M, D, *plan, stream)
    kalman_downdate.launches += 1
    return new_cov, dx


gram_reduce.launches = 0
kalman_downdate.launches = 0


def reset_launch_counts() -> None:
    gram_reduce.launches = 0
    kalman_downdate.launches = 0
