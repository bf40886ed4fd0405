#!/usr/bin/env python3
"""Where a block of each Gram kernel spends its time, on one CUDA card.

    python3 tools/kernel_phases.py

Builds ``ov_plane_tpu_torch/csrc/`` into ``build/kernel_phases/`` with
``-DOVP_PHASE_MARKS`` (thread 0 of every block writes a ``%globaltimer`` mark
at each phase boundary and sums ``clock64`` cycles per part of the chunk
loop; see ``gram_tile.cuh``) and, for the f32 kernels, with marks added to a
copy of ``gram_tile.cuh``; checks that the marked build gives the package
kernels' bits, and runs it at every shape of ``chip_smoke.PATH_SHAPES`` in
the type it launches in, each call after the L2 flush of
``chip_smoke.device_ms``:

* f64 ``kalman_downdate`` (``downdate_dmma_kernel``,
  ``kernels.downdate_f64_plan``): per block, the set-up with the issue of
  the epilogue's P loads, the rows (operand loads and MMA), the cluster
  barrier (the wait for the slowest block of the cluster), the reduction
  over the cluster and the stores of P'; median and largest over the
  blocks.
* f64 ``gram_reduce`` (``gram_dmma_rows_kernel``, ``kernels.gram_f64_plan``):
  the same marks up to the end of the chunk loop, and its cycles per block
  split into the MMA loop (thread 0's warp), the repack, the copy wait within
  it, and the barrier; ``gram_out_kernel``'s device time beside it.
* f32 ``kalman_downdate`` (``gram_stream_kernel``): a mark at six points:
  the start, after the set-up, when the stream's bulk copy has arrived,
  after the repack, after the FMA loop, after the stores.
* f32 ``gram_reduce`` (``gram_rows_kernel``): the cycles of the chunk loop
  split into FMA loop, repack, copy wait, barrier, and thread 0's proxy
  fence and copy issue.

The f64 kernels run at every f64 shape; ``--f32`` adds the f32 kernels at
every f32 shape. Also prints the card and the device time of each package
kernel and of its marked build (the marks cost a little).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ov_plane_tpu_torch.ops import kernels  # noqa: E402

OUT = ROOT / "build" / "kernel_phases"
PHASES = ("set-up", "copy", "repack", "FMA loop", "stores")
F64_DOWNDATE_PHASES = ("set-up and loads issued", "rows and MMA", "cluster barrier", "reduction and stores")
# (text of gram_tile.cuh, its marked form) for the f32 kernels; each text occurs once.
EDITS = [
    # gram_stream_kernel: marks 0 and 4, 5.
    ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, slices",
     "  OVP_MARK(0);\n  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, slices"),
    ("  T (*stage)[kStagePad] = reinterpret_cast<T (*)[kStagePad]>(smem + kBarBytes);",
     "  OVP_MARK(4);\n  T (*stage)[kStagePad] = reinterpret_cast<T (*)[kStagePad]>(smem + kBarBytes);"),
    ("bb, out + b * D * D, vec + b * D, ti, tj, D);\n", "bb, out + b * D * D, vec + b * D, ti, tj, D);\n  OVP_MARK(5);\n"),
    # for_each_chunk: marks 1-3; the wait for a copy, timed.
    ("    pad[(i / w) * ld + D + 1 + i % w] = T(0);\n  __syncthreads();\n",
     "    pad[(i / w) * ld + D + 1 + i % w] = T(0);\n  __syncthreads();\n  OVP_MARK(1);\n"),
    ("  auto chunk_end = [&](long long m, long long s) { return min(min(m + kc, r_end), s); };\n"
     "  const long long s_begin = r_begin < r_end ? (r_begin / M + 1) * M : r_end;\n"
     "  const int npad",
     "  long long c_wait = 0;\n"
     "  auto chunk_end = [&](long long m, long long s) { return min(min(m + kc, r_end), s); };\n"
     "  const long long s_begin = r_begin < r_end ? (r_begin / M + 1) * M : r_end;\n"
     "  const int npad"),
    ("    mbar_wait(&bars[st], (l / stages) & 1);\n    const T* rw",
     "    const long long w0 = clock64();\n    mbar_wait(&bars[st], (l / stages) & 1);\n"
     "    c_wait += clock64() - w0;\n    if (l == 0) OVP_MARK(2);\n    const T* rw"),
    ("  if (m < r_end) repack(0, m, chunk_end(m, s), pad);\n  __syncthreads();\n",
     "  if (m < r_end) repack(0, m, chunk_end(m, s), pad);\n  __syncthreads();\n  OVP_MARK(3);\n"),
    # for_each_chunk's loop: cycles per part.
    ("""  for (int l = 0; m < r_end; ++l) {
    const long long m1 = chunk_end(m, s), s1 = m1 == s ? s + M : s;
    consume(pad + (l & 1) * kc * ld, m, m1);
    if (m1 < r_end) repack(l + 1, m1, chunk_end(m1, s1), pad + ((l + 1) & 1) * kc * ld);
    __syncthreads();
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_next();
    }
""", """  long long c_fma = 0, c_rep = 0, c_bar = 0, c_fence = 0, c_issue = 0, c_begin = clock64();
  for (int l = 0; m < r_end; ++l) {
    const long long m1 = chunk_end(m, s), s1 = m1 == s ? s + M : s;
    const long long c0 = clock64();
    consume(pad + (l & 1) * kc * ld, m, m1);
    const long long c1 = clock64();
    if (m1 < r_end) repack(l + 1, m1, chunk_end(m1, s1), pad + ((l + 1) & 1) * kc * ld);
    const long long c2 = clock64();
    __syncthreads();
    const long long c3 = clock64();
    c_fma += c1 - c0, c_rep += c2 - c1, c_bar += c3 - c2;
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const long long c4 = clock64();
      issue_next();
      c_fence += c4 - c3, c_issue += clock64() - c4;
    }
"""),
    ("    m = m1;\n    s = s1;\n  }\n}\n\n// Upper tile", """    m = m1;
    s = s1;
  }
  if (threadIdx.x == 0) {
    long long* c = g_cycles[blockIdx.y * gridDim.x + blockIdx.x];
    c[0] = clock64() - c_begin, c[1] = c_fma, c[2] = c_rep, c[3] = c_wait, c[4] = c_bar;
    c[5] = c_fence, c[6] = c_issue;
  }
}

// Upper tile"""),
]
READ = """
extern "C" int ovp_marks_read(unsigned long long* marks, long long* cycles, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(marks, ovp::g_marks, (size_t)n * 8 * sizeof(unsigned long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cycles, ovp::g_cycles, (size_t)n * 8 * sizeof(long long));
  static long long zeros[1 << 16][8];
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ovp::g_cycles, zeros, sizeof(zeros));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ovp::g_marks, zeros, sizeof(zeros));
  return (int)e;
}
"""


def build_marked() -> dict[str, ctypes.CDLL]:
    src = (kernels.CSRC / "gram_tile.cuh").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"the text to mark is not found once in gram_tile.cuh: {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "gram_tile.cuh").write_text(src)
    (OUT / "gram_dmma.cuh").write_text((kernels.CSRC / "gram_dmma.cuh").read_text())
    procs = {}
    for name in ("gram_reduce", "kalman_downdate"):  # the sources that include gram_tile.cuh
        cu = OUT / kernels.SOURCES[name]
        cu.write_text((kernels.CSRC / kernels.SOURCES[name]).read_text() + READ)
        procs[name] = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-DOVP_PHASE_MARKS", "-o",
                                        str(OUT / f"{name}.so"), str(cu)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the marked {name}:\n{report}")
        libs[name] = kernels._declare(ctypes.CDLL(str(OUT / f"{name}.so")), name)
        libs[name].ovp_marks_read.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    return libs


def marked_calls(lib, fn, n_blocks: int, calls: int = 3):
    """The marks and cycles of ``calls`` calls of ``fn``, each after the flush."""
    flush = torch.empty(chip_smoke.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    marks, cycles = np.zeros((n_blocks, 8), dtype=np.uint64), np.zeros((n_blocks, 8), dtype=np.int64)
    if lib.ovp_marks_read(marks.ctypes.data, cycles.ctypes.data, n_blocks) != 0:  # zeroes them
        raise RuntimeError("reading the marks failed")
    for _ in range(calls):
        flush.bitwise_not_()
        flush.amax()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        if lib.ovp_marks_read(marks.ctypes.data, cycles.ctypes.data, n_blocks) != 0:
            raise RuntimeError("reading the marks failed")
        yield marks.astype(np.int64), cycles.copy()


def _per_phase(marks: np.ndarray, names) -> str:
    """Median / largest µs per phase over the blocks that reached each mark."""
    out = []
    for i, p in enumerate(names):
        ok = (marks[:, i] > 0) & (marks[:, i + 1] > 0)
        d = (marks[ok, i + 1] - marks[ok, i]) / 1e3
        out.append(f"{p} {np.median(d):.2f} / {d.max():.2f}" if ok.any() else f"{p} -")
    return ", ".join(out)


def downdate_phases(lib, B: int, M: int, D: int, dtype, g, n_sm: int, stream: int) -> None:
    P, W, u = chip_smoke._inputs("kalman_downdate", B, M, D, dtype, g, zero_rows=False)
    f64 = dtype == torch.float64
    plan = kernels.downdate_f64_plan(B, M, D, n_sm) if f64 else kernels.stream_plan(B, M, D, n_sm)
    out, dx = torch.empty(B, D, D, device="cuda", dtype=dtype), torch.empty(B, D, device="cuda", dtype=dtype)
    fn = lib.ovp_kalman_downdate_f64 if f64 else lib.ovp_kalman_downdate_f32

    def downdate():
        if fn(P.data_ptr(), W.data_ptr(), u.data_ptr(), out.data_ptr(), dx.data_ptr(), B, M, D, *plan, stream):
            raise RuntimeError("marked downdate launch failed")

    downdate()
    if not all(map(torch.equal, (out, dx), kernels.kalman_downdate(P, W, u))):
        raise RuntimeError("the marked downdate does not give the package kernel's bits")
    tname = str(dtype)[6:]
    print(f"[phases] kalman_downdate {tname} B={B} M={M} D={D} {plan}")
    print(f"[phases] kalman_downdate {tname} device ms, cold L2: package kernel "
          f"{chip_smoke.device_ms(lambda: kernels.kalman_downdate(P, W, u)):.5f}, marked build "
          f"{chip_smoke.device_ms(downdate):.5f}")
    n_blocks = plan.groups * (plan.slices if f64 else 1) * B
    for rep, (marks, cyc) in enumerate(marked_calls(lib, downdate, n_blocks)):
        if f64:
            t = marks[:, [0, 1, 3, 4, 5]]
            print(f"[phases] kalman_downdate f64 call {rep}, {len(t)} blocks, us per phase (median / largest): "
                  + _per_phase(t, F64_DOWNDATE_PHASES)
                  + f"; last block done {(t[:, 4].max() - t[:, 0].min()) / 1e3:.2f} us after the first began")
        else:
            t = marks[:, :6]
            print(f"[phases] kalman_downdate f32 call {rep}, {len(t)} blocks, us per phase (median / largest): "
                  + _per_phase(t, PHASES)
                  + f"; last block done {(t[:, 5].max() - t[:, 0].min()) / 1e3:.2f} us after the first began")


def gram_phases(lib, B: int, M: int, D: int, dtype, g, n_sm: int, stream: int) -> None:
    H, r = chip_smoke._inputs("gram_reduce", B, M, D, dtype, g, zero_rows=False)
    f64 = dtype == torch.float64
    gplan = kernels.gram_f64_plan(B, M, D, n_sm) if f64 else kernels.launch_plan(B, M, D, n_sm)
    lam, eta = torch.empty(B, D, D, device="cuda", dtype=dtype), torch.empty(B, D, device="cuda", dtype=dtype)
    ws = torch.empty(gplan.workspace, device="cuda", dtype=dtype)
    fn = lib.ovp_gram_reduce_f64 if f64 else lib.ovp_gram_reduce_f32

    def gram():
        if fn(H.data_ptr(), r.data_ptr(), lam.data_ptr(), eta.data_ptr(), ws.data_ptr(), B, M, D,
              *kernels._plan_args(gplan), stream):
            raise RuntimeError("marked gram launch failed")

    gram()
    if not all(map(torch.equal, (lam, eta), kernels.gram_reduce(H, r))):
        raise RuntimeError("the marked gram does not give the package kernel's bits")
    tname = str(dtype)[6:]
    parts = {}
    print(f"[phases] gram_reduce {tname} B={B} M={M} D={D} {gplan}")
    k_ms = chip_smoke.device_ms(lambda: kernels.gram_reduce(H, r), parts=parts)
    print(f"[phases] gram_reduce {tname} device ms, cold L2: package kernels {k_ms:.5f} ("
          + ", ".join(f"{k.split('<')[0].split('(')[0].split()[-1]} {v:.5f}" for k, v in parts.items())
          + f"), marked build {chip_smoke.device_ms(gram):.5f}")
    for rep, (marks, cyc) in enumerate(marked_calls(lib, gram, gplan.blocks * gplan.groups)):
        if f64:
            t = marks[:, :4]
            med = np.median(cyc[:, 1:5], axis=0)
            print(f"[phases] gram_reduce f64 call {rep}, {len(t)} blocks, us per phase (median / largest): "
                  + _per_phase(t, ("set-up", "first copy", "chunk loop"))
                  + f"; chunk loop cycles per block (median): MMA {med[0]:.0f}, repack {med[1]:.0f} of which "
                  f"waiting for the copy {med[2]:.0f}, barrier {med[3]:.0f}; last block done "
                  f"{(t[:, 3].max() - t[:, 0].min()) / 1e3:.2f} us after the first began")
        else:
            med = np.median(cyc[:, :7], axis=0)
            print(f"[phases] gram_reduce f32 call {rep}, {len(cyc)} blocks, gram_rows_kernel cycles per block "
                  f"(median): chunk loop {med[0]:.0f} (largest {cyc[:, 0].max()}), FMA loop {med[1]:.0f}, "
                  f"repack {med[2]:.0f} of which waiting for the copy {med[3]:.0f}, barrier {med[4]:.0f}, "
                  f"thread 0's proxy fence {med[5]:.0f} and copy issue {med[6]:.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    libs = build_marked()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    phases = {"kalman_downdate": downdate_phases, "gram_reduce": gram_phases}
    dtypes = [torch.float64, torch.float32] if "--f32" in sys.argv else [torch.float64]
    for dtype in dtypes:
        for name, fn in phases.items():
            for B, M, D, _ in chip_smoke.path_shapes(name, dtype):
                fn(libs[name], B, M, D, dtype, g, n_sm, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
