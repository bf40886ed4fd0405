"""The port's hand-written CUDA kernels and their plain versions.

Counterpart of ``ov_plane_tpu/ops/pallas_kernels.py``, whose two Pallas TPU
kernels become Gram kernels compiled for ``sm_90a``: in f32 those of
``csrc/gram_tile.cuh`` (FMA pipes), in f64 those of ``csrc/gram_dmma.cuh``
(the f64 tensor cores):

* :func:`gram_reduce` — (Λ, η) = (HᵀH, Hᵀr), H [B, M, D]; replaces
  ``gram_reduce_pallas``. Compresses the stacked MSCKF rows.
* :func:`kalman_downdate` — (P − WᵀW, Wᵀu), W [B, M, D]; replaces
  ``kalman_downdate_pallas``. Closes the square-root EKF update.

Both outputs' matrices are the upper triangle mirrored, so they are bitwise
symmetric, and two calls give the same bits; the plain versions
(:func:`gram_reduce_ref`, :func:`kalman_downdate_ref`) compute the same
function with PyTorch ops.

* :func:`imu_propagate` (``csrc/imu_propagate.cu``, replacing no TPU kernel)
  — the IMU window's mean, Φ and Qd for B streams in one launch; its plain
  version is ``state/propagator.propagate_mean_cov_ref``.

Dispatch is by the tensors' device and type and nothing else: a CPU tensor
takes the plain version, a CUDA tensor launches the kernels of its type (at
any row count) or raises. How a call divides the work is a pure function:
:func:`launch_plan` (f32) and :func:`gram_f64_plan` (f64) for the gram (row
ranges, tile groups, chunk rows, shared memory, the partials' workspace,
which the wrapper allocates with ``torch.empty``), :func:`stream_plan` (f32)
and :func:`downdate_f64_plan` (f64: tile groups, row slices per cluster,
staging) for the downdate. The kernels
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
SOURCES = {"gram_reduce": "gram_reduce.cu", "kalman_downdate": "kalman_downdate.cu",
           "imu_propagate": "imu_propagate.cu"}
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

# The f64 path (csrc/gram_dmma.cuh): 16×8 fragments of the augmented Gram on
# mma.m16n8k8.f64, warp items of at most F64_FRAGS fragments.
F64_K = 8            # rows per MMA step; chunks are multiples of it
F64_FRAGS = 8        # fragments per warp item, at most
F64_MAX_WARPS = 8    # warps per block, at most (launch bounds 256 threads: 255 registers a thread)
F64_MIN_WARPS = 4    # warps per gram block, at least (they stage the rows)
F64_STAGES = 3       # the ring of bulk-copy buffers, at most
F64_MAX_CHUNK = 48   # rows per chunk of the gram, at most
F64_MIN_ROWS = 64    # rows per block of the gram, at least (fewer partials for gram_out_kernel)
F64_CLUSTER = 8      # blocks that share a tile group's stores in the downdate, at most
F64_RANKS = 4        # blocks of one cluster (the downdate's row slices), at most
F64_PRE = 4          # elements of the downdate's share a thread stores at once (kPre)
F64_TAB = 256        # the downdate's fragment table, bytes (8 warps' fragments)
F64_SHORT = 64       # rows of a stream that every block of the downdate takes whole, at most


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
def launch_plan(B: int, M: int, D: int, n_sm: int = 132) -> LaunchPlan:
    """The f32 launch for X [B, M, D] on a card of ``n_sm`` SMs.

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
    chunk_rows = max(1, min(TILE, STAGE_BYTES // (ld * 4), M))
    rows = B * M
    if rows == 0:
        return LaunchPlan(0, groups, warps, chunk_rows, 1, 0, 0, 1, 0)
    blocks = max(1, min(-(-rows // MIN_ROWS), BLOCKS_PER_SM * n_sm // groups))
    rows_per_block = -(-rows // blocks)
    blocks = -(-rows // rows_per_block)
    max_parts = min(blocks, -(-M // rows_per_block) + 1)
    stages = min(STAGES, -(-rows_per_block // chunk_rows) + -(-rows_per_block // M) + 1)
    raw = -(-chunk_rows * D * 4 // 128) * 128
    smem = BAR_BYTES + stages * raw + 2 * chunk_rows * ld * 4
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


def _staging_bytes(rows: int, M: int, D: int, ld: int, stages: int) -> int:
    """Shared memory of ``for_each_chunk`` (f32) for chunks of ``rows`` rows:
    the barriers, ``stages`` raw spans, and the padded tiles (one when the M
    rows of a stream are a single chunk, else two)."""
    raw = -(-rows * D * 4 // 128) * 128
    pads = 1 if 0 < M <= rows else 2
    return BAR_BYTES + stages * raw + pads * rows * ld * 4


@functools.lru_cache(maxsize=256)
def stream_plan(B: int, M: int, D: int, n_sm: int = 132) -> StreamPlan:
    """The f32 launch for X [B, M, D] on a card of ``n_sm`` SMs, one stream
    per block and no split of rows.

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
    if _staging_bytes(rows, M, D, ld, 1) > MAX_SMEM:
        rows = max(1, min(TILE, STAGE_BYTES // (ld * 4), M))
        stages = min(STAGES, -(-M // rows))
    smem = max(_staging_bytes(rows, M, D, ld, stages), BAR_BYTES + threads * STAGE_PAD * 4)
    return StreamPlan(groups, tiles, threads, rows, stages, smem)


class F64Geometry(NamedTuple):
    """The augmented (D+1)×(D+1) Gram in 16×8 fragments (``csrc/gram_dmma.cuh``
    ``Geom``): ``nfi`` bands of 16 rows, ``nfj`` columns of 8; band fi holds
    fragments fj = 2·fi … nfj−1 (those that reach the upper triangle). Bands p
    and nfi−1−p form a pair of ``lp`` fragments, cut into ``wpp`` warp items;
    ``items`` in all. ``ldy``: the staged tile's row-pair stride in doubles."""
    nfi: int
    nfj: int
    npairs: int
    lp: int
    wpp: int
    items: int
    ldy: int


def f64_geometry(D: int) -> F64Geometry:
    nfi, nfj = (D + 16) // 16, (D + 8) // 8
    lp = 2 * nfj - 2 * nfi + 2
    wpp = -(-lp // F64_FRAGS)
    lm = nfj - 2 * (nfi // 2)
    items = nfi // 2 * wpp + (-(-lm // F64_FRAGS) if nfi % 2 else 0)
    return F64Geometry(nfi, nfj, nfi // 2, lp, wpp, items, 2 * 16 * nfi + 4)


def f64_item_fragments(D: int, w: int) -> list[tuple[int, int]]:
    """The fragments (fi, fj) of warp item w, in the kernel's order
    (``gram_dmma.cuh`` ``item``, ``frag_of``): a run of a band pair's list,
    band p's fragments then band nfi−1−p's, or of the middle band's."""
    g = f64_geometry(D)
    if w < g.npairs * g.wpp:
        p, k = divmod(w, g.wpp)
        q, la = g.nfi - 1 - p, g.nfj - 2 * p
        pair = [(p, 2 * p + f) for f in range(la)] + [(q, 2 * q + f) for f in range(g.lp - la)]
        return pair[k * F64_FRAGS:(k + 1) * F64_FRAGS]
    m, s = g.nfi // 2, (w - g.npairs * g.wpp) * F64_FRAGS
    return [(m, 2 * m + s + f) for f in range(min(F64_FRAGS, g.nfj - 2 * m - s))]


def _f64_staging_bytes(kc: int, D: int, ldy: int, stages: int, npad: int) -> int:
    """Shared memory of ``for_each_chunk_y`` for chunks of ``kc`` rows: the
    barriers, ``stages`` raw spans, ``npad`` staged row-pair tiles."""
    return BAR_BYTES + stages * (-(-kc * D * 8 // 128) * 128) + npad * (kc // 2) * ldy * 8


class GramF64Plan(NamedTuple):
    """How one f64 call of the gram divides its work (``csrc/gram_dmma.cuh``).
    ``gram_dmma_rows_kernel`` runs on grid (groups, blocks) with ``32·warps``
    threads and ``smem_bytes`` of dynamic shared memory, one block per SM.
    Block (g, i) takes rows [i·rows_per_block, (i+1)·rows_per_block) of the
    B·M rows, in chunks of at most ``chunk_rows`` rows through a ring of
    ``stages`` copy buffers; its warp w computes warp item
    g·items_per_group + w. Partials and ``gram_out_kernel`` as in
    :class:`LaunchPlan`."""
    blocks: int
    groups: int
    warps: int
    items_per_group: int
    chunk_rows: int
    stages: int
    max_parts: int
    smem_bytes: int
    rows_per_block: int
    workspace: int


@functools.lru_cache(maxsize=256)
def gram_f64_plan(B: int, M: int, D: int, n_sm: int = 132) -> GramF64Plan:
    """The f64 launch for H [B, M, D] on a card of ``n_sm`` SMs.

    The warp items go to as few groups of at most 8 warps as hold them all
    (one group up to D = 127: H is read from device memory once; the groups
    of a row range run side by side and share it through L2). The B·M rows
    are cut into equal ranges of at least 64 rows, one wave of one block
    per SM, and each range is staged in chunks of up to 48 rows."""
    g = f64_geometry(D)
    ntc = (D + TILE) // TILE
    n_upper = ntc * (ntc + 1) // 2
    groups = -(-g.items // F64_MAX_WARPS)
    ipg = -(-g.items // groups)
    groups = -(-g.items // ipg)
    warps = max(ipg, F64_MIN_WARPS)
    rows = B * M
    if rows == 0:
        return GramF64Plan(0, groups, warps, ipg, F64_K, 1, 0, 0, 1, 0)
    blocks = max(1, min(-(-rows // F64_MIN_ROWS), max(1, n_sm // groups)))
    rows_per_block = -(-rows // blocks)
    blocks = -(-rows // rows_per_block)
    max_parts = min(blocks, -(-M // rows_per_block) + 1)
    kc = min(F64_MAX_CHUNK, 2 * 32 * warps, -(-rows_per_block // F64_K) * F64_K)
    stages = max(1, min(F64_STAGES, -(-rows_per_block // kc) + -(-rows_per_block // M) + 1))
    while kc > F64_K and _f64_staging_bytes(kc, D, g.ldy, stages, 2) > MAX_SMEM:
        kc -= F64_K
    return GramF64Plan(blocks, groups, warps, ipg, kc, stages, max_parts,
                       _f64_staging_bytes(kc, D, g.ldy, stages, 2), rows_per_block,
                       B * max_parts * n_upper * TILE * TILE)


class DowndateF64Plan(NamedTuple):
    """How one f64 call of the downdate divides its work
    (``csrc/gram_dmma.cuh``, ``downdate_dmma_kernel``): grid (groups ·
    slices, B), clusters of ``ranks`` blocks (1 or ``slices``),
    ``32·warps`` threads and ``smem_bytes`` of dynamic shared memory per
    block (a table of the group's fragments, then the warps' fragment
    sums). Block x stores share x mod slices of the sums of the warp items
    of group x div slices (``items_per_group`` of them). With a cluster,
    block rank s takes the rows [s·slice_rows, (s+1)·slice_rows) ∩ [0, M)
    of its stream; without, every block takes all M = slice_rows rows. An
    item's warps / items_per_group warps take its 8-row steps in turn."""
    groups: int
    slices: int
    ranks: int
    warps: int
    items_per_group: int
    slice_rows: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def downdate_f64_plan(B: int, M: int, D: int, n_sm: int = 132) -> DowndateF64Plan:
    """The f64 launch for W [B, M, D] on a card of ``n_sm`` SMs.

    The warp items are spread over as many groups as keep B·groups ≤
    ``n_sm`` (one block per SM: a thread takes 255 registers) where the
    items allow. Where B·groups still leaves most SMs idle (one stream),
    each group's sums are stored by up to 8 blocks, B·groups·slices ≤
    ``n_sm`` (2·``n_sm`` where the blocks need at most 4 warps). A stream
    of more than 64 rows has its rows cut into up to 4 slices, one block of
    a cluster each (the clusters of a group store disjoint shares), the
    slices' sums added through distributed shared memory; a shorter one is
    taken whole by every block (its few steps cost less than the cluster).
    Within a block, each item has as many warps as its rows have 8-row
    steps, or as its share needs for 4 elements a thread, up to 8 warps in
    all."""
    g = f64_geometry(D)
    # As many groups as keep B·groups within one block per SM (a block's
    # threads take 255 registers each), down to one warp item a group.
    want = max(-(-g.items // F64_MAX_WARPS), min(g.items, max(1, n_sm // max(B, 1))))
    ipg = -(-g.items // want)
    groups = -(-g.items // ipg)

    def split(per_sm: int) -> tuple[int, int, int, int]:
        """(slices, ranks, slice_rows, parts) for up to per_sm blocks an SM."""
        slices = 1 if B * groups >= n_sm // 2 else max(1, min(F64_CLUSTER, per_sm * n_sm // (B * groups)))
        ranks = min(slices, F64_RANKS) if M > F64_SHORT else 1
        slices -= slices % ranks
        slice_rows = -(-M // ranks)
        # A warp per 8-row step of an item, and enough threads that each
        # stores at most F64_PRE elements of the block's share at once.
        share = -(-ipg * F64_FRAGS * 128 // slices)
        parts = max(1, min(F64_MAX_WARPS // ipg, max(-(-slice_rows // F64_K), -(-share // (32 * ipg * F64_PRE)))))
        return slices, ranks, slice_rows, parts

    # Two blocks an SM where each needs at most 4 warps (an SM sub-partition
    # holds two warps of 255 registers), else one.
    slices, ranks, slice_rows, parts = split(2)
    if ipg * parts > F64_MAX_WARPS // 2:
        slices, ranks, slice_rows, parts = split(1)
    return DowndateF64Plan(groups, slices, ranks, ipg * parts, ipg, slice_rows,
                           F64_TAB + parts * ipg * F64_FRAGS * 128 * 8)


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
        args = {"f32": [p] * 5 + [i] * 10 + [ctypes.c_longlong, p],
                "f64": [p] * 5 + [i] * 11 + [ctypes.c_longlong, p]}
    elif name == "imu_propagate":  # the 9 inputs, the 5 outputs; B, W, the variant, the stream
        args = dict.fromkeys(("f32", "f64"), [p] * 14 + [i] * 3 + [p])
    else:  # P, W, u, P', dx; B, M, D, the plan, the stream
        args = {"f32": [p] * 5 + [i] * 9 + [p], "f64": [p] * 5 + [i] * 10 + [p]}
    for suffix, types in args.items():
        fn = getattr(lib, f"ovp_{name}_{suffix}")
        fn.argtypes = types
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


def _plan_args(plan: LaunchPlan | GramF64Plan) -> tuple:
    """The gram launcher's plan arguments (the workspace size is the wrapper's)."""
    return tuple(plan[:-1])


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
    n_sm = _sm_count(H.device.index)
    plan = gram_f64_plan(B, M, D, n_sm) if H.dtype == torch.float64 else launch_plan(B, M, D, n_sm)
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
    n_sm = _sm_count(W.device.index)
    plan = downdate_f64_plan(B, M, D, n_sm) if W.dtype == torch.float64 else stream_plan(B, M, D, n_sm)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("kalman_downdate", W.dtype, cov.data_ptr(), W.data_ptr(), u.data_ptr(), new_cov.data_ptr(),
                dx.data_ptr(), B, M, D, *plan, stream)
    kalman_downdate.launches += 1
    return new_cov, dx


def imu_propagate(imu, imu_fej, imu_t, imu_w, imu_a, t0, t1, noises, gravity,
                  use_rk4: bool, do_fej: bool, imu_avg: bool):
    """(imu [B, 16], imu_fej [B, 16], Φ [B, 15, 15], Qd [B, 15, 15], last_w [B, 3])
    of ``state/propagator.propagate_mean_cov_ref`` for contiguous CUDA
    tensors of one type (imu_t [B, W], imu_w / imu_a [B, W, 3], t0 / t1
    [B], noises [4], gravity [3]): one launch walks every stream's window,
    in the kernel compiled for these options."""
    B, W = imu_t.shape
    ins = {"imu": imu, "imu_fej": imu_fej, "imu_t": imu_t, "imu_w": imu_w, "imu_a": imu_a, "t0": t0, "t1": t1,
           "noises": noises, "gravity": gravity}
    want = dict(zip(ins, ((B, 16), (B, 16), (B, W), (B, W, 3), (B, W, 3), (B,), (B,), (4,), (3,))))
    for k, x in ins.items():
        if tuple(x.shape) != want[k]:
            raise ValueError(f"expected {k} of shape {want[k]}, got {tuple(x.shape)}")
    _check_cuda(ins)
    outs = [torch.empty(shape, dtype=imu.dtype, device=imu.device)
            for shape in ((B, 16), (B, 16), (B, 15, 15), (B, 15, 15), (B, 3))]
    variant = 4 * bool(use_rk4) + 2 * bool(do_fej) + (bool(imu_avg) and not use_rk4)
    with torch.cuda.device(imu.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("imu_propagate", imu.dtype, *(x.data_ptr() for x in (*ins.values(), *outs)), B, W, variant, stream)
    imu_propagate.launches += 1
    return tuple(outs)


gram_reduce.launches = 0
kalman_downdate.launches = 0
imu_propagate.launches = 0


def reset_launch_counts() -> None:
    gram_reduce.launches = 0
    kalman_downdate.launches = 0
    imu_propagate.launches = 0
