// Shared body of the two Gram-family kernels of the filter update, for Hopper
// (sm_90a): their f32 path, and the staging helpers that the f64 path
// (gram_dmma.cuh, on the f64 tensor cores) shares.
//
// Both TPU kernels of the JAX package (ov_plane_tpu/ops/pallas_kernels.py)
// contract a tall matrix with itself and with one extra column:
//   gram_reduce      (Λ, η)       = (HᵀH, Hᵀr)
//   kalman_downdate  (P', dx)     = (P − WᵀW, Wᵀu)
// Written once here as G = AᵀA for the augmented A = [X | x] (x folded in as
// column D), so η / Wᵀu come out of the same pass as the Gram.
//
// Two designs share the tile body below.
//
// gram_reduce (long inputs, M = 1320 on the filter's path), two kernels.
// gram_rows_kernel: the B·M rows of all streams, one contiguous run of
// memory, are cut into equal ranges, one per block, so every SM gets the
// same work whatever B and M are. The upper 32×32 tiles of the (D+1)×(D+1)
// Gram are numbered row by row; tile group g (blockIdx.y) takes `warps`
// consecutive ones, one warp per tile, and each lane owns a 4×8 block of its
// tile (three 16-byte shared loads feed 32 FMAs). At the end of each
// stream's rows in its range, a block writes its partial tiles to the
// workspace and starts again from zero. gram_out_kernel: one block per
// (upper tile, stream) sums the stream's partials in the fixed order of the
// row ranges (no float atomics: two calls give the same bits) and stores it.
//
// kalman_downdate (short inputs, M = D = 93), one kernel, no partials.
// gram_stream_kernel: block (g, b) runs every row of stream b for the upper
// tiles of group g, the groups chosen so that B·groups fills the SMs. The
// stream's whole X | x is staged by one bulk copy when it fits in shared
// memory (else it goes through the ring of chunks below), and the block's
// epilogue reads the base tile, subtracts, and stores.
//
// Both store a tile row-major and, through a padded shared tile, transposed,
// so both stores coalesce and the outputs are bitwise symmetric (the
// square-root Kalman update relies on that to keep P PSD).
//
// Staging: a chunk of rows is one contiguous span of X. Thread 0 copies its
// 16-byte-aligned middle with one bulk asynchronous copy (cp.async.bulk onto
// an mbarrier) into a ring of raw buffers, so that copies run ahead of the
// math; the block then repacks the span into a padded row-major tile (the
// misaligned head and tail read with plain loads, x folded in as column D,
// the columns past D zero) and computes from that, double-buffered, one
// __syncthreads per chunk.
//
// Numerics of this f32 path: plain IEEE FMA (no TF32, no tensor cores), one
// accumulator per output over a range's rows in row order. The launch plans
// are computed by ops/kernels.launch_plan (gram_rows_kernel) and
// ops/kernels.stream_plan (gram_stream_kernel). The f64 calls take
// gram_dmma.cuh instead.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks of a block, read by tools/kernel_phases.py: compiled only with
// -DOVP_PHASE_MARKS. Thread 0 writes the %globaltimer at mark i, and adds
// clock64 cycles to counter i.
#ifdef OVP_PHASE_MARKS
namespace ovp {
__device__ unsigned long long g_marks[1 << 16][8];
__device__ long long g_cycles[1 << 16][8];
}  // namespace ovp
#define OVP_BLOCK (blockIdx.y * gridDim.x + blockIdx.x)
#define OVP_MARK(i)                                                     \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      unsigned long long t_;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \
      ::ovp::g_marks[OVP_BLOCK][i] = t_;                                \
    }                                                                   \
  } while (0)
#define OVP_CYCLES() clock64()
#define OVP_COUNT(i, v)                                                 \
  do {                                                                  \
    if (threadIdx.x == 0) ::ovp::g_cycles[OVP_BLOCK][i] += (v);         \
  } while (0)
#else
#define OVP_MARK(i) \
  do {              \
  } while (0)
#define OVP_CYCLES() 0LL
#define OVP_COUNT(i, v) \
  do {                  \
  } while (0)
#endif

namespace ovp {

constexpr int kTile = 32;         // warp tile edge
constexpr int kBarBytes = 128;    // the ring's mbarriers, at the start of shared memory
constexpr int kStagePad = kTile + 1;
constexpr int kMaxThreads = 192;  // six warp tiles
constexpr int kStreamThreads = 256;  // gram_stream_kernel: warp tiles × row slices

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };

// N consecutive values from 16-byte-aligned shared memory into registers.
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[N]) {
  using V = typename Vec16<T>::type;
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < N / per; ++i) *reinterpret_cast<V*>(&v[i * per]) = reinterpret_cast<const V*>(p)[i];
}

template <int N, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[N]) {
  using V = typename Vec16<T>::type;
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < N / per; ++i) reinterpret_cast<V*>(p)[i] = *reinterpret_cast<const V*>(&v[i * per]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The bytes [lo, hi) of a span, both ends rounded inward to 16 bytes: what
// one bulk copy moves. Empty (lo = hi) when the span holds no aligned block.
template <typename T>
__device__ __forceinline__ void aligned_window(const T* span, int n, int& head, int& nwin) {
  const uintptr_t gs = reinterpret_cast<uintptr_t>(span);
  const uintptr_t ge = gs + (uintptr_t)n * sizeof(T);
  const uintptr_t lo = (gs + 15) & ~uintptr_t(15), hi = ge & ~uintptr_t(15);
  head = hi > lo ? (int)((lo - gs) / sizeof(T)) : 0;
  nwin = hi > lo ? (int)((hi - lo) / sizeof(T)) : 0;
}

// Thread 0: start the copy of the aligned window of a chunk's span.
template <typename T>
__device__ __forceinline__ void issue_chunk(const T* span, int n, T* raw, uint64_t* bar) {
  int head, nwin;
  aligned_window(span, n, head, nwin);
  const uint32_t b = smem_addr(bar);
  if (nwin > 0) {
    const uint32_t bytes = nwin * sizeof(T);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_addr(raw)),
        "l"(reinterpret_cast<uint64_t>(span + head)), "r"(bytes), "r"(b)
        : "memory");
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(b) : "memory");
  }
}

// The rows [r_begin, r_end) of X | x, chunk by chunk through shared memory:
// a chunk is at most kc rows and ends at its stream's end. For each chunk,
// every thread calls consume(tile, m0, m1) with the chunk's padded rows
// (tile[k·ld + c], c ≤ D, zero past D). Layout of smem: the ring's barriers,
// `stages` raw buffers, two padded tiles (one when the rows are one chunk).
// Returns after a __syncthreads with no copy in flight: smem is free.
template <typename T, typename Consume>
__device__ __forceinline__ void for_each_chunk(const T* __restrict__ X, const T* __restrict__ x,
                                               long long r_begin, long long r_end, int M, int D, int kc,
                                               int stages, float inv_d, unsigned char* smem,
                                               Consume consume) {
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int ld = ((D + kTile) / kTile) * kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int raw_elems = ((kc * D * (int)sizeof(T) + 127) / 128) * 128 / (int)sizeof(T);
  T* raw = reinterpret_cast<T*>(smem + kBarBytes);
  T* pad = raw + stages * raw_elems;  // [2][kc][ld]
  // The end of the chunk that starts at row m of a stream that ends at row s
  // (each stream's end is carried along: no 64-bit division per chunk).
  auto chunk_end = [&](long long m, long long s) { return min(min(m + kc, r_end), s); };
  const long long s_begin = r_begin < r_end ? (r_begin / M + 1) * M : r_end;
  const int npad = r_begin < r_end && chunk_end(r_begin, s_begin) == r_end ? 1 : 2;

  long long m_issue = r_begin, s_issue = s_begin;  // thread 0: the next chunk to copy, and its number
  int l_issue = 0;
  auto issue_next = [&]() {
    if (m_issue >= r_end) return;
    const long long m1 = chunk_end(m_issue, s_issue);
    const int st = l_issue % stages, n = (int)(m1 - m_issue) * D;
    issue_chunk(X + m_issue * D, n, raw + st * raw_elems, &bars[st]);
    // What repack reads with plain loads (x, the span's misaligned ends)
    // comes into L2 meanwhile.
    for (long long k = m_issue; k < m1; k += 128 / sizeof(T)) prefetch_l2(x + k);
    prefetch_l2(x + m1 - 1);
    prefetch_l2(X + m_issue * D);
    prefetch_l2(X + m_issue * D + n - 1);
    if (m1 == s_issue) s_issue += M;
    m_issue = m1;
    ++l_issue;
  };
  if (tid == 0) {  // the first chunk's copy alone, at once
    for (int i = 0; i < stages; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue_next();
  }
  for (int i = tid, w = ld - D - 1; i < npad * kc * w; i += nthreads)  // the columns past x
    pad[(i / w) * ld + D + 1 + i % w] = T(0);
  __syncthreads();

  // Chunk l = rows [m0, m1), once arrived, into the padded tile dst: rows × [X row | x | 0…].
  auto repack = [&](int l, long long m0, long long m1, T* dst) {
    const int st = l % stages;
    const T* span = X + m0 * D;
    const int rows = (int)(m1 - m0), n = rows * D;
    int head, nwin;
    aligned_window(span, n, head, nwin);
    // The plain loads first (a thread's first x and misaligned end element),
    // so that their latency overlaps the wait and the window's repack.
    const int e0 = tid < head ? tid : tid + nwin;
    const T x0 = tid < rows ? x[m0 + tid] : T(0), s0 = tid < n - nwin ? span[e0] : T(0);
    mbar_wait(&bars[st], (l / stages) & 1);
    const T* rw = raw + st * raw_elems;
    constexpr int V = 16 / sizeof(T);
    for (int q = tid; q * V < nwin; q += nthreads) {
      T v[V];
      load_vec(rw + q * V, v);
      const int e = head + q * V;
      int k = __float2int_rz(__fmul_rn((float)e + 0.5f, inv_d));
      int c = e - k * D;
#pragma unroll
      for (int u = 0; u < V; ++u) {
        dst[k * ld + c] = v[u];
        if (++c == D) {
          c = 0;
          ++k;
        }
      }
    }
    for (int i = tid; i < n - nwin; i += nthreads) {  // the misaligned head and tail
      const int e = i < head ? i : i + nwin;
      const int k = __float2int_rz(__fmul_rn((float)e + 0.5f, inv_d));
      dst[k * ld + e - k * D] = i == tid ? s0 : span[e];
    }
    for (int k = tid; k < rows; k += nthreads) dst[k * ld + D] = k == tid ? x0 : x[m0 + k];
  };

  long long m = r_begin, s = s_begin;
  if (m < r_end) repack(0, m, chunk_end(m, s), pad);
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int i = 0; i < stages; ++i) issue_next();
  }
  for (int l = 0; m < r_end; ++l) {
    const long long m1 = chunk_end(m, s), s1 = m1 == s ? s + M : s;
    consume(pad + (l & 1) * kc * ld, m, m1);
    if (m1 < r_end) repack(l + 1, m1, chunk_end(m1, s1), pad + ((l + 1) & 1) * kc * ld);
    __syncthreads();
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_next();
    }
    m = m1;
    s = s1;
  }
}

// Upper tile t of ntc column tiles, numbered row by row: (row tile, column tile).
__device__ __forceinline__ void upper_tile(int t, int ntc, int& ti, int& tj) {
  ti = 0;
  while (ti < ntc && t >= ntc - ti) {
    t -= ntc - ti;
    ++ti;
  }
  tj = ti + t;
}

// acc[i][j] += A[k][ci + i] · A[k][cj + j] over the rows k < rows of a padded tile.
template <typename T>
__device__ __forceinline__ void mac_rows(const T* tile, int ld, int rows, int ci, int cj, T (&acc)[4][8]) {
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    T a[4], bv[8];
    load_vec(tile + k * ld + ci, a);
    load_vec(tile + k * ld + cj, bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fma_rn(a[i], bv[j], acc[i][j]);
  }
}

// Rows r0..r0+7 of an upper tile whose columns start at q0, one warp: lane
// holds v[q] = G[r0 + q][q0 + lane]. Writes them row-major and, through the
// padded shared tile stage, transposed; both stores coalesce.
//   out[i][j] = out[j][i] = base ? base[i][j] − G[i][j] : G[i][j]   (i ≤ j < D)
//   vec[i]    = G[i][D]                                             (i < D)
template <typename T>
__device__ __forceinline__ void store_band(const T (&v)[8], const T* bb, T* ob, T* vb, int r0, int q0, int D,
                                           T (*stage)[kStagePad]) {
  const int lane = threadIdx.x % 32, j = q0 + lane;
  T bv[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    bv[q] = bb != nullptr && r0 + q <= j && j < D ? bb[(size_t)(r0 + q) * D + j] : T(0);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = r0 + q;
    T val = v[q];
    if (i <= j && j < D) {
      if (bb != nullptr) val = bv[q] - val;
      ob[(size_t)i * D + j] = val;
    } else if (j == D && i < D) {
      vb[i] = val;
    }
    stage[q][lane] = val;
  }
  __syncwarp();
  // Transposed: lane = (column jj of 4, row ii of 8); writes (j, i).
  const int ii = lane % 8, i = r0 + ii;
#pragma unroll
  for (int jg = 0; jg < 8; ++jg) {
    const int jl = 4 * jg + lane / 8, j2 = q0 + jl;
    if (i <= j2 && j2 < D) ob[(size_t)j2 * D + i] = stage[ii][jl];
  }
}

// Long inputs. X [B, M, D] and x [B, M] as n_rows = B·M rows; ws [B,
// max_parts, n_upper, 32, 32]. Block i takes rows [i·rows_per_block, …) and
// writes the partial of stream b to part i − ⌊b·M / rows_per_block⌋.
// Grid (blocks, groups); block 32·warps ≤ 192, three to an SM (at most 112
// registers a thread).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 3)
gram_rows_kernel(const T* __restrict__ X, const T* __restrict__ x, T* __restrict__ ws, int M, int D,
                 long long n_rows, long long rows_per_block, int chunk_rows, int stages, int max_parts,
                 float inv_d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int blk = blockIdx.x, nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntc = (D + kTile) / kTile, ld = ntc * kTile, n_upper = ntc * (ntc + 1) / 2;
  const int t = blockIdx.y * nwarps + warp;  // this warp's tile
  int ti, tj;
  upper_tile(t, ntc, ti, tj);
  const int ci = ti * kTile + 4 * (lane / 4), cj = tj * kTile + 8 * (lane % 4);  // this lane's 4×8 block
  T acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);

  const long long r_begin = (long long)blk * rows_per_block, r_end = min(r_begin + rows_per_block, n_rows);
  for_each_chunk(X, x, r_begin, r_end, M, D, chunk_rows, stages, inv_d, smem,
                 [&](const T* tile, long long m0, long long m1) {
                   if (t >= n_upper) return;
                   mac_rows(tile, ld, (int)(m1 - m0), ci, cj, acc);
                   if (m1 == r_end || m1 % M == 0) {  // the end of a stream's rows in this range
                     const long long b = m0 / M, part = blk - (b * M) / rows_per_block;
                     T* dst = ws + ((b * max_parts + part) * n_upper + t) * (kTile * kTile) +
                              (ci - ti * kTile) * kTile + cj - tj * kTile;
#pragma unroll
                     for (int i = 0; i < 4; ++i) {
                       store_vec(dst + i * kTile, acc[i]);
#pragma unroll
                       for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
                     }
                   }
                 });
}

// The partials of the long inputs: one block of 4 warps per (upper tile,
// stream); warp w sums the tile's rows 8w..8w+7 over the stream's parts, in
// part order, and stores them. Grid (n_upper, B).
template <typename T>
__global__ void __launch_bounds__(128)
gram_out_kernel(const T* __restrict__ ws, T* __restrict__ out, T* __restrict__ vec, int M, int D,
                long long rows_per_block, int max_parts) {
  __shared__ T stage[4][8][kStagePad];
  const int tg = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = blockIdx.y;
  const int ntc = (D + kTile) / kTile, n_upper = ntc * (ntc + 1) / 2;
  int ti, tj;
  upper_tile(tg, ntc, ti, tj);
  const int n_parts = M > 0 ? (int)(((b + 1) * M - 1) / rows_per_block - (b * M) / rows_per_block + 1) : 0;
  // The partials four at a time, every load of a group in flight at once; the
  // sums still run in part order.
  T v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = T(0);
  const T* src = ws + (b * max_parts * n_upper + tg) * (kTile * kTile) + 8 * warp * kTile + lane;
  const size_t part_stride = (size_t)n_upper * kTile * kTile;
  for (int part = 0; part < n_parts; part += 4) {
    T w[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        w[u][q] = part + u < n_parts ? src[(part + u) * part_stride + q * kTile] : T(0);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (part + u < n_parts) v[q] = part + u == 0 ? w[u][q] : v[q] + w[u][q];
  }
  store_band<T>(v, nullptr, out + b * D * D, vec + b * D, ti * kTile + 8 * warp, tj * kTile, D, stage[warp]);
}

// The bands 8·band … 8·band+7 (band = slice, slice + slices, … < 4) of
// tile (ti, tj): the sum of its row slices, st + s·slice_stride for s = 0 …
// slices−1, added in that order, stored by store_band. Out of line: the FMA
// loop's registers stay its own.
template <typename T>
__device__ __noinline__ void store_tile(T (*st)[kStagePad], int slice_stride, int slices, int slice,
                                        const T* bb, T* ob, T* vb, int ti, int tj, int D) {
  const int lane = threadIdx.x % 32;
#pragma unroll 1
  for (int band = slice; band < 4; band += slices) {
    T v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = st[8 * band + q][lane];
#pragma unroll 1
    for (int s = 1; s < slices; ++s)
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = v[q] + st[s * slice_stride + 8 * band + q][lane];
    store_band(v, bb, ob, vb, ti * kTile + 8 * band, tj * kTile, D, st + 8 * band);
  }
}

// Short inputs. X [B, M, D], x [B, M], base [B, D, D]. Block (g, b) takes
// every row of stream b, in chunks of chunk_rows (all M rows in one chunk
// when they fit), for the upper tiles [g·tiles, (g+1)·tiles). Warp w works
// on tile w mod tiles over row slice w / tiles of each chunk (the rows cut
// in `slices` equal runs), so a tile's row chain is M / slices long. At the
// start, the first slice's warps prefetch their tile of the base into L2.
// At the end every warp moves its 4×8 blocks into a padded shared tile; the
// slices' sums are added in slice order and stored, out = base − G (G
// without a base) and vec, one band of 8 rows per warp. Grid (groups, B),
// block 32·tiles·slices threads.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads, 2)
gram_stream_kernel(const T* __restrict__ X, const T* __restrict__ x, const T* __restrict__ base,
                   T* __restrict__ out, T* __restrict__ vec, int M, int D, int tiles, int chunk_rows,
                   int stages, float inv_d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, slices = blockDim.x / 32 / tiles;
  const int tl = warp % tiles, slice = warp / tiles;
  const int ntc = (D + kTile) / kTile, ld = ntc * kTile, n_upper = ntc * (ntc + 1) / 2;
  const int t = blockIdx.x * tiles + tl;
  const bool active = t < n_upper;
  int ti = 0, tj = 0;
  if (active) upper_tile(t, ntc, ti, tj);
  const int li = 4 * (lane / 4), lj = 8 * (lane % 4);  // this lane's 4×8 block of the tile
  const int ci = ti * kTile + li, cj = tj * kTile + lj;
  const long long b = blockIdx.y;
  const T* bb = base != nullptr ? base + b * D * D : nullptr;
  if (active && bb != nullptr && slice == 0 && ti * kTile + lane < D) {
    const T* row = bb + (size_t)(ti * kTile + lane) * D;
    prefetch_l2(row + min(tj * kTile, D - 1));
    prefetch_l2(row + min(tj * kTile + kTile - 1, D - 1));
  }
  T acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);

  for_each_chunk(X, x, b * M, (b + 1) * M, M, D, chunk_rows, stages, inv_d, smem,
                 [&](const T* tile, long long m0, long long m1) {
                   if (!active) return;
                   const int rows = (int)(m1 - m0), k0 = slice * rows / slices;
                   mac_rows(tile + k0 * ld, ld, (slice + 1) * rows / slices - k0, ci, cj, acc);
                 });
  T (*stage)[kStagePad] = reinterpret_cast<T (*)[kStagePad]>(smem + kBarBytes);  // [warps·32][33]
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) stage[warp * kTile + li + i][lj + j] = acc[i][j];
  }
  __syncthreads();
  if (active)
    store_tile<T>(stage + tl * kTile, tiles * kTile, slices, slice, bb, out + b * D * D, vec + b * D, ti, tj, D);
}

// Each shared library keeps its own record of the shared memory it allowed
// a kernel: the launchers are `static` (a local static of an inline function
// would be one object across every library loaded in the process).
template <typename K>
static cudaError_t allow_smem(K kernel, int smem_bytes, int& allowed) {
  if (smem_bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess) allowed = smem_bytes;
  return e;
}

// gram_rows_kernel over `blocks` row ranges, then gram_out_kernel.
template <typename T>
static int launch_gram_rows(const T* X, const T* x, T* out, T* vec, T* ws, int B, int M, int D, int blocks,
                            int groups, int warps, int chunk_rows, int stages, int max_parts, int smem_bytes,
                            long long rows_per_block, cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  static int smem_allowed = 0;
  const int ntc = (D + kTile) / kTile;
  if (blocks > 0) {
    cudaError_t e = allow_smem(gram_rows_kernel<T>, smem_bytes, smem_allowed);
    if (e != cudaSuccess) return (int)e;
    gram_rows_kernel<T><<<dim3(blocks, groups), 32 * warps, smem_bytes, stream>>>(
        X, x, ws, M, D, (long long)B * M, rows_per_block, chunk_rows, stages, max_parts, 1.0f / (float)D);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  gram_out_kernel<T><<<dim3(ntc * (ntc + 1) / 2, B), 128, 0, stream>>>(ws, out, vec, M, D, rows_per_block,
                                                                      max_parts);
  return (int)cudaGetLastError();
}

// gram_stream_kernel on grid (groups, B), `threads` = 32·tiles·slices per block.
template <typename T>
static int launch_gram_stream(const T* X, const T* x, const T* base, T* out, T* vec, int B, int M, int D,
                              int groups, int tiles, int threads, int chunk_rows, int stages, int smem_bytes,
                              cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  static int smem_allowed = 0;
  const cudaError_t e = allow_smem(gram_stream_kernel<T>, smem_bytes, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  gram_stream_kernel<T><<<dim3(groups, B), threads, smem_bytes, stream>>>(X, x, base, out, vec, M, D, tiles,
                                                                         chunk_rows, stages, 1.0f / (float)D);
  return (int)cudaGetLastError();
}

}  // namespace ovp
