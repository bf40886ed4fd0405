#!/usr/bin/env python3
"""Where a block of each Gram kernel spends its time, on one CUDA card.

    python3 tools/kernel_phases.py

Copies ``ov_plane_tpu_torch/csrc/`` into ``build/kernel_phases/`` with
instrumentation written by thread 0 of every block, builds the copy with the
package's nvcc flags, checks that it gives the package kernels' bits, and
runs it at every path's f32 shapes (``chip_smoke.PATH_SHAPES``: D = 93 on
the point path, D = 114 on the plane path), each call after the L2 flush of
``chip_smoke.device_ms``:

* ``kalman_downdate`` (B=64, M=D=93; M=114 and 115 at D=114;
  ``kernels.stream_plan``): a
  ``%globaltimer`` mark at six points of ``gram_stream_kernel``: the start,
  after the set-up (first copy issued, padding zeroed), when the stream's
  bulk copy has arrived, after the repack, after the FMA loop, after the
  stores. Prints per phase the median and largest time over the blocks.
* ``gram_reduce`` (B=64, M=1320, D=93 and 114, ``kernels.launch_plan``): the
  ``clock64`` cycles of ``gram_rows_kernel``'s chunk loop, summed per block
  into the FMA loop (thread 0's warp), the repack with its wait for the bulk
  copy, that wait alone, the barrier, and thread 0's proxy fence and issue
  of the next copy. Prints the median per block.

Also prints the card and the device time of each package kernel and of its
marked copy (the marks cost a little).
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
INSTRUMENT = """namespace ovp {
__device__ unsigned long long g_marks[1 << 16][8];
__device__ long long g_cycles[1 << 16][8];
#define MARK(i)                                                               \\
  do {                                                                        \\
    if (threadIdx.x == 0) {                                                   \\
      unsigned long long t_;                                                  \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                  \\
      g_marks[blockIdx.y * gridDim.x + blockIdx.x][i] = t_;                   \\
    }                                                                         \\
  } while (0)
"""
# (text of gram_tile.cuh, its instrumented form); each text occurs once.
EDITS = [
    ("namespace ovp {\n", INSTRUMENT),
    # gram_stream_kernel: marks 0 and 4, 5.
    ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, slices",
     "  MARK(0);\n  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, slices"),
    ("  T (*stage)[kStagePad] = reinterpret_cast<T (*)[kStagePad]>(smem + kBarBytes);",
     "  MARK(4);\n  T (*stage)[kStagePad] = reinterpret_cast<T (*)[kStagePad]>(smem + kBarBytes);"),
    ("bb, out + b * D * D, vec + b * D, ti, tj, D);\n", "bb, out + b * D * D, vec + b * D, ti, tj, D);\n  MARK(5);\n"),
    # for_each_chunk: marks 1-3; the wait for a copy, timed.
    ("    pad[(i / w) * ld + D + 1 + i % w] = T(0);\n  __syncthreads();\n",
     "    pad[(i / w) * ld + D + 1 + i % w] = T(0);\n  __syncthreads();\n  MARK(1);\n"),
    ("  auto chunk_end = [&](long long m, long long s) {",
     "  long long c_wait = 0;\n  auto chunk_end = [&](long long m, long long s) {"),
    ("    mbar_wait(&bars[st], (l / stages) & 1);\n",
     "    const long long w0 = clock64();\n    mbar_wait(&bars[st], (l / stages) & 1);\n"
     "    c_wait += clock64() - w0;\n    if (l == 0) MARK(2);\n"),
    ("  if (m < r_end) repack(0, m, chunk_end(m, s), pad);\n  __syncthreads();\n",
     "  if (m < r_end) repack(0, m, chunk_end(m, s), pad);\n  __syncthreads();\n  MARK(3);\n"),
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
    ("    m = m1;\n    s = s1;\n  }\n}\n", """    m = m1;
    s = s1;
  }
  if (threadIdx.x == 0) {
    long long* c = g_cycles[blockIdx.y * gridDim.x + blockIdx.x];
    c[0] = clock64() - c_begin, c[1] = c_fma, c[2] = c_rep, c[3] = c_wait, c[4] = c_bar;
    c[5] = c_fence, c[6] = c_issue;
  }
}
"""),
]
READ = """
extern "C" int ovp_marks_read(unsigned long long* marks, long long* cycles, int n) {
  const cudaError_t e = cudaMemcpyFromSymbol(marks, ovp::g_marks, (size_t)n * 8 * sizeof(unsigned long long));
  return (int)(e != cudaSuccess ? e : cudaMemcpyFromSymbol(cycles, ovp::g_cycles, (size_t)n * 8 * sizeof(long long)));
}
"""


def build_marked() -> dict[str, ctypes.CDLL]:
    src = (kernels.CSRC / "gram_tile.cuh").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"the text to instrument is not found once in gram_tile.cuh: {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "gram_tile.cuh").write_text(src)
    procs = {}
    for name, source in kernels.SOURCES.items():
        cu = OUT / source
        cu.write_text((kernels.CSRC / source).read_text() + READ)
        procs[name] = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
                                        str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
    for _ in range(calls):
        flush.bitwise_not_()
        flush.amax()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        marks, cycles = np.zeros((n_blocks, 8), dtype=np.uint64), np.zeros((n_blocks, 8), dtype=np.int64)
        if lib.ovp_marks_read(marks.ctypes.data, cycles.ctypes.data, n_blocks) != 0:
            raise RuntimeError("reading the marks failed")
        yield marks.astype(np.int64), cycles


def downdate_phases(lib, B: int, M: int, D: int, g, n_sm: int, stream: int) -> None:
    P, W, u = chip_smoke._inputs("kalman_downdate", B, M, D, torch.float32, g, zero_rows=False)
    plan = kernels.stream_plan(B, M, D, 4, n_sm)
    out, dx = torch.empty(B, D, D, device="cuda"), torch.empty(B, D, device="cuda")

    def downdate():
        if lib.ovp_kalman_downdate_f32(P.data_ptr(), W.data_ptr(), u.data_ptr(), out.data_ptr(),
                                       dx.data_ptr(), B, M, D, *plan, stream):
            raise RuntimeError("marked downdate launch failed")

    downdate()
    if not all(map(torch.equal, (out, dx), kernels.kalman_downdate(P, W, u))):
        raise RuntimeError("the marked downdate does not give the package kernel's bits")
    print(f"[phases] kalman_downdate f32 B={B} M={M} D={D} {plan}")
    print(f"[phases] kalman_downdate device ms, cold L2: package kernel "
          f"{chip_smoke.device_ms(lambda: kernels.kalman_downdate(P, W, u)):.5f}, marked copy "
          f"{chip_smoke.device_ms(downdate):.5f}")
    for rep, (marks, _) in enumerate(marked_calls(lib, downdate, plan.groups * B)):
        t = marks[:, :6]
        d = np.diff(t, axis=1) / 1e3
        print(f"[phases] kalman_downdate call {rep}, {len(t)} blocks, us per phase (median / largest): "
              + ", ".join(f"{p} {np.median(d[:, i]):.2f} / {d[:, i].max():.2f}" for i, p in enumerate(PHASES))
              + f"; last block done {(t[:, 5].max() - t[:, 0].min()) / 1e3:.2f} us after the first began")


def gram_phases(lib, B: int, M: int, D: int, g, n_sm: int, stream: int) -> None:
    H, r = chip_smoke._inputs("gram_reduce", B, M, D, torch.float32, g, zero_rows=False)
    gplan = kernels.launch_plan(B, M, D, 4, n_sm)
    lam, eta = torch.empty(B, D, D, device="cuda"), torch.empty(B, D, device="cuda")
    ws = torch.empty(gplan.workspace, device="cuda")

    def gram():
        if lib.ovp_gram_reduce_f32(H.data_ptr(), r.data_ptr(), lam.data_ptr(), eta.data_ptr(),
                                   ws.data_ptr(), B, M, D, *kernels._plan_args(gplan), stream):
            raise RuntimeError("marked gram launch failed")

    gram()
    if not all(map(torch.equal, (lam, eta), kernels.gram_reduce(H, r))):
        raise RuntimeError("the marked gram does not give the package kernel's bits")
    print(f"[phases] gram_reduce f32 B={B} M={M} D={D} {gplan}")
    print(f"[phases] gram_reduce device ms, cold L2: package kernels "
          f"{chip_smoke.device_ms(lambda: kernels.gram_reduce(H, r)):.5f}, marked copy {chip_smoke.device_ms(gram):.5f}")
    for rep, (_, cyc) in enumerate(marked_calls(lib, gram, gplan.blocks * gplan.groups)):
        med = np.median(cyc[:, :7], axis=0)
        print(f"[phases] gram_reduce call {rep}, {len(cyc)} blocks, gram_rows_kernel cycles per block (median): "
              f"chunk loop {med[0]:.0f} (largest {cyc[:, 0].max()}), FMA loop {med[1]:.0f}, repack {med[2]:.0f} "
              f"of which waiting for the copy {med[3]:.0f}, barrier {med[4]:.0f}, thread 0's proxy fence "
              f"{med[5]:.0f} and copy issue {med[6]:.0f}")


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
    for name, fn in phases.items():
        for B, M, D in sorted({sh for p in chip_smoke.PATH_SHAPES.values() for sh in p[name]}):
            fn(libs[name], B, M, D, g, n_sm, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
