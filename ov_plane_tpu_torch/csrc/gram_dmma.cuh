// The f64 path of the two Gram-family kernels, on Hopper's f64 tensor cores
// (DMMA: mma.sync.aligned.m16n8k8.row.col.f64), for sm_90a.
//
// Replaces, in f64, the two TPU kernels of ov_plane_tpu/ops/pallas_kernels.py:
//   gram_reduce_pallas      (:138, body _gram_kernel_batched :43)    (Λ, η) = (HᵀH, Hᵀr)
//   kalman_downdate_pallas  (:249, body _downdate_kernel_batched :162) (P', dx) = (P − WᵀW, Wᵀu)
// As in gram_tile.cuh (the f32 path), G = AᵀA for the augmented A = [X | x],
// x folded in as column D, and only the upper triangle is computed and then
// mirrored, so Λ and P' are bitwise symmetric; no float atomics, so two
// calls give the same bits.
//
// Bounds on an H100 SXM at its 700 W limit: f64 products at 67 TFLOP/s on
// the tensor cores, 34 TFLOP/s on the FMA pipes; memory at 3.35 TB/s. The
// filter's gram (B=64, M=1320, D=114) reads 84.4 MB (25.2 µs) and needs
// 1.127 GFLOP of upper triangle: 16.8 µs on the tensor cores, 33.1 µs on the
// FMA pipes, above the byte bound, hence the tensor cores. The replay's
// downdate (B=1, M=D=156) moves 0.59 MB (0.18 µs) for 0.004 GFLOP: its time
// is a chain of latencies (launch, W's rows, the sums, the stores of P'),
// each code region fetched anew when the L2 is cold.
//
// Fragments. The augmented Gram is cut into 16×8 fragments (fi, fj), the
// MMA's output tile; fragment (fi, fj) is computed iff it reaches the upper
// triangle (8·fj + 7 ≥ 16·fi), so band fi holds fragments fj = 2·fi … nfj−1.
// Band p and band nfi−1−p are paired: together they hold the same number of
// fragments for every p, so cutting each pair's list into runs of kF
// fragments gives warps of equal work (a middle band, when nfi is odd, is
// cut alone). A warp item is such a run: at most two bands, so a warp loads
// at most two A operands per step and one B operand per fragment. The items'
// order is fixed (item()); ops/kernels.f64_item_fragments mirrors it. The
// MMA's k slots are assigned to physical rows by the same bijection in A
// and B, so any assignment sums every row once.
//
// gram_reduce: gram_dmma_rows_kernel runs the equal row ranges of
// gram_rows_kernel (gram_tile.cuh), one block of 8 warps per range and tile
// group, one block per SM (a thread holds 8 fragments' sums, 255 registers
// at most). A chunk of rows, sized in rows by the plan, is one bulk
// asynchronous copy (cp.async.bulk onto an mbarrier) into a ring that runs
// ahead of the math; the block repacks it into a row-pair layout Y[q][c] =
// (X[2q][c], X[2q+1][c]) (x as column D, zeros past D and past the last
// row), row-pair stride ldy ≡ 4 (mod 16) doubles: a lane's A operand is
// loaded straight into the MMA's register order, its B operand is one
// 16-byte load, and a quarter warp hits eight distinct 16-byte banks. Half
// the warps repack the next chunk before their MMAs, half after, so that
// the two warps of an SM sub-partition take turns at the tensor core. Each
// item's split between its bands has its own code: a predicated-off DMMA
// still holds the tensor pipe, and ptxas fails on an f64 operand chosen by
// selection. At the end of each stream's rows in its range a block writes
// its fragments into the 32×32-tile workspace of the f32 path, and
// gram_out_kernel sums the partials in the fixed order of the ranges.
//
// kalman_downdate: downdate_dmma_kernel. Its rows are few, so its warps load
// their MMA operands straight from device memory (no staging) and take the
// rows' 8-row steps in turn. When B·groups would leave most SMs idle (one
// stream: B = 1), several blocks share a tile group's stores. A stream of
// more than 64 rows has its rows cut into slices over a thread-block
// cluster of those blocks: each block leaves its slice's sums in its shared
// memory and, after a cluster barrier, sums its share of the group's
// fragments over the cluster's blocks in rank order through distributed
// shared memory, subtracts from P and stores P' and its transpose. A
// shorter stream is taken whole by every block, which stores its share: a
// cluster launch costs more than the few steps. One launch, no workspace.
#pragma once

#include <cooperative_groups.h>

#include "gram_tile.cuh"

namespace ovp {
namespace dmma {

namespace cg = cooperative_groups;

constexpr int kK = 8;           // rows per MMA step (m16n8k8)
constexpr int kF = 8;           // fragments per warp item, at most
constexpr int kMaxThreads = 256;  // 8 warps: 255 registers a thread at one block per SM

// The augmented Gram of D + 1 columns in 16×8 fragments.
struct Geom {
  int nfi, nfj;      // fragment bands (16 rows each), fragment columns (8 each)
  int npairs, lp;    // band pairs, fragments per pair
  int wpp, items;    // warp items per pair, in all
  int ldy;           // row-pair stride of the staged tile, in doubles
};

__host__ __device__ inline Geom geom(int D) {
  Geom g;
  g.nfi = (D + 16) / 16;
  g.nfj = (D + 8) / 8;
  g.npairs = g.nfi / 2;
  g.lp = 2 * g.nfj - 2 * g.nfi + 2;
  g.wpp = (g.lp + kF - 1) / kF;
  const int lm = g.nfj - 2 * (g.nfi / 2);  // the middle band's fragments, when nfi is odd
  g.items = g.npairs * g.wpp + (g.nfi % 2 ? (lm + kF - 1) / kF : 0);
  g.ldy = 2 * 16 * g.nfi + 4;
  return g;
}

// A warp item: fragments f < na are (fa, ja + f), the rest up to n are (fb, jb + f − na).
struct Item {
  int fa, ja, na, fb, jb, n;
};

__device__ __forceinline__ Item item(const Geom& g, int w) {
  Item it;
  if (w < g.npairs * g.wpp) {
    const int p = w / g.wpp, k = w - p * g.wpp, q = g.nfi - 1 - p, la = g.nfj - 2 * p;
    const int s = k * kF, e = min(s + kF, g.lp);
    it.fa = p, it.ja = 2 * p + s, it.na = max(0, min(e, la) - s);
    it.fb = q, it.jb = 2 * q + max(s, la) - la, it.n = e - s;
    if (it.na == 0) it.fa = it.fb, it.ja = it.jb, it.na = it.n;
  } else {
    const int m = g.nfi / 2, s = (w - g.npairs * g.wpp) * kF;
    it.fa = it.fb = m, it.ja = it.jb = 2 * m + s;
    it.na = it.n = min(kF, g.nfj - 2 * m - s);
  }
  return it;
}

__device__ __forceinline__ void frag_of(const Item& it, int f, int& fi, int& fj) {
  fi = f < it.na ? it.fa : it.fb;
  fj = f < it.na ? it.ja + f : it.jb + f - it.na;
}

__device__ __forceinline__ void mma8(double (&c)[4], double a0, double a1, double a2, double a3, double b0,
                                     double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

__device__ __forceinline__ double2 ld2(const double* p) { return *reinterpret_cast<const double2*>(p); }

// One warp's item and sums. Lane (g, t) = (lane / 4, lane % 4). The
// m16n8k8 layouts: A a0..a3 = (row g, k t), (g+8, t), (g, t+4), (g+8, t+4);
// B b0, b1 = (k t, col g), (t+4, g); C c0..c3 = (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1). k slots t and t+4 are the physical rows 2t and 2t+1 of the
// step (one element pair Y[4·step + t][c] of a staged tile).
struct WarpTile {
  Item it;
  double acc[kF][4];

  __device__ __forceinline__ void init(const Item& item_) {
    it = item_;
#pragma unroll
    for (int f = 0; f < kF; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][i] = 0.0;
  }

  // The sums over `steps` steps of 8 rows of a staged tile Y, by the code for
  // the item's split between its bands (no MMA predicated).
  __device__ __forceinline__ void mac(const double* Y, int ldy, int steps) {
    switch (it.na) {
      case 1: return mac_steps<1>(Y, ldy, steps);
      case 2: return mac_steps<2>(Y, ldy, steps);
      case 3: return mac_steps<3>(Y, ldy, steps);
      case 4: return mac_steps<4>(Y, ldy, steps);
      case 5: return mac_steps<5>(Y, ldy, steps);
      case 6: return mac_steps<6>(Y, ldy, steps);
      case 7: return mac_steps<7>(Y, ldy, steps);
      default: return mac_steps<8>(Y, ldy, steps);
    }
  }

  // All kF fragments, the first kNa in band a; an item of fewer fragments
  // repeats its last one, never stored. Each band's A operand is loaded
  // straight into the MMA's register order and every B operand of a step
  // before its first MMA.
  template <int kNa>
  __device__ __forceinline__ void mac_steps(const double* Y, int ldy, int steps) {
    const int lane = threadIdx.x % 32;
    const double* row = Y + (lane % 4) * ldy + 2 * (lane / 4);  // lane's row pair and column
#pragma unroll 1
    for (int s = 0; s < steps; ++s, row += 4 * ldy) {
      const double* pa = row + 32 * it.fa;
      const double* pb = row + 32 * it.fb;
      const double a0 = pa[0], a1 = pa[16], a2 = pa[1], a3 = pa[17];
      const double b0 = pb[0], b1 = pb[16], b2 = pb[1], b3 = pb[17];
      double2 bv[kF];
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const int fc = min(f, it.n - 1);
        bv[f] = ld2(row + 16 * (fc < it.na ? it.ja + fc : it.jb + fc - it.na));
      }
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        if (f < kNa)
          mma8(acc[f], a0, a1, a2, a3, bv[f].x, bv[f].y);
        else
          mma8(acc[f], b0, b1, b2, b3, bv[f].x, bv[f].y);
      }
    }
  }
};

// The rows [r_begin, r_end) of X | x chunk by chunk, as for_each_chunk
// (gram_tile.cuh) but into the row-pair layout: a chunk is at most kc rows
// (kc a multiple of 8) and ends at its stream's end; consume(Y, m0, m1) gets
// each staged chunk. Warps 0-3 stage chunk l + 1 before they consume chunk
// l, the others after, so that the two warps of an SM sub-partition take
// turns at the tensor core. Layout of smem: the ring's barriers, `stages`
// raw spans, one or two staged tiles of kc / 2 row pairs
// (ops/kernels._f64_staging_bytes). Returns after a __syncthreads with no
// copy in flight: smem is free.
template <typename Consume>
__device__ __forceinline__ void for_each_chunk_y(const double* __restrict__ X, const double* __restrict__ x,
                                                 long long r_begin, long long r_end, int M, int D, int kc,
                                                 int stages, int ldy, unsigned char* smem, Consume consume) {
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int ncols = (ldy - 4) / 2;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int raw_elems = ((kc * D * 8 + 127) / 128) * 16;
  double* raw = reinterpret_cast<double*>(smem + kBarBytes);
  double* ybuf = raw + stages * raw_elems;  // [2][kc / 2][ldy]
  const int ysize = kc / 2 * ldy;
  auto chunk_end = [&](long long m, long long s) { return min(min(m + kc, r_end), s); };
  const long long s_begin = r_begin < r_end ? (r_begin / M + 1) * M : r_end;

  long long m_issue = r_begin, s_issue = s_begin;  // thread 0: the next chunk to copy, and its number
  int l_issue = 0;
  auto issue_next = [&]() {
    if (m_issue >= r_end) return;
    const long long m1 = chunk_end(m_issue, s_issue);
    const int st = l_issue % stages, n = (int)(m1 - m_issue) * D;
    issue_chunk(X + m_issue * D, n, raw + st * raw_elems, &bars[st]);
    for (long long k = m_issue; k < m1; k += 16) prefetch_l2(x + k);
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
  // This thread's first (row pair, column) of a repack, and its step.
  const int q0 = tid / ncols, c0 = tid - q0 * ncols, dq = nthreads / ncols, dc = nthreads - dq * ncols;
  __syncthreads();
  OVP_MARK(1);

  // Chunk l = rows [m0, m1), once arrived, into the staged tile dst.
  auto repack = [&](int l, long long m0, long long m1, double* dst) {
    const int st = l % stages;
    const double* span = X + m0 * D;
    const int rows = (int)(m1 - m0), n = rows * D, pairs = (rows + kK - 1) / kK * (kK / 2);
    int head, nwin;
    aligned_window(span, n, head, nwin);
    // Column D (x) by the first `pairs` threads, loaded before the wait.
    double x0 = 0.0, x1 = 0.0;
    if (tid < pairs) {
      if (2 * tid < rows) x0 = x[m0 + 2 * tid];
      if (2 * tid + 1 < rows) x1 = x[m0 + 2 * tid + 1];
    }
    const long long w0 = OVP_CYCLES();
    mbar_wait(&bars[st], (l / stages) & 1);
    OVP_COUNT(3, OVP_CYCLES() - w0);
    if (l == 0) OVP_MARK(2);
    const double* rw = raw + st * raw_elems - head;  // rw[e]: element e of the span, inside the window
    if (head == 0 && nwin == n && rows % 2 == 0) {  // the whole span in the window, whole row pairs: shared loads only
      for (int q = q0, c = c0; q < pairs;) {
        double2 v = make_double2(0.0, 0.0);
        if (c < D && 2 * q < rows) v = make_double2(rw[2 * q * D + c], rw[(2 * q + 1) * D + c]);
        if (c != D) *reinterpret_cast<double2*>(dst + q * ldy + 2 * c) = v;
        q += dq, c += dc;
        if (c >= ncols) c -= ncols, ++q;
      }
    } else {  // the misaligned ends of the span by plain loads, rows past the chunk's end as zeros
      auto elem = [&](int k, int c) {
        if (k >= rows) return 0.0;
        const int e = k * D + c;
        return (unsigned)(e - head) < (unsigned)nwin ? rw[e] : span[e];
      };
      for (int q = q0, c = c0; q < pairs;) {
        if (c < D) *reinterpret_cast<double2*>(dst + q * ldy + 2 * c) = make_double2(elem(2 * q, c), elem(2 * q + 1, c));
        else if (c > D) *reinterpret_cast<double2*>(dst + q * ldy + 2 * c) = make_double2(0.0, 0.0);
        q += dq, c += dc;
        if (c >= ncols) c -= ncols, ++q;
      }
    }
    if (tid < pairs) *reinterpret_cast<double2*>(dst + tid * ldy + 2 * D) = make_double2(x0, x1);
  };

  long long m = r_begin, s = s_begin;
  const int npad = r_begin < r_end && chunk_end(r_begin, s_begin) == r_end ? 1 : 2;
  if (m < r_end) repack(0, m, chunk_end(m, s), ybuf);
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int i = 0; i < stages; ++i) issue_next();
  }
  const bool stage_first = tid / 128 == 0;
  for (int l = 0; m < r_end; ++l) {
    const long long m1 = chunk_end(m, s), s1 = m1 == s ? s + M : s;
    auto stage_next = [&]() {
      const long long c0_ = OVP_CYCLES();
      if (m1 < r_end) repack(l + 1, m1, chunk_end(m1, s1), ybuf + ((l + 1) & 1) * (npad - 1) * ysize);
      OVP_COUNT(2, OVP_CYCLES() - c0_);
    };
    if (stage_first) stage_next();
    const long long c1_ = OVP_CYCLES();
    consume(ybuf + (l & 1) * (npad - 1) * ysize, m, m1);
    OVP_COUNT(1, OVP_CYCLES() - c1_);
    if (!stage_first) stage_next();
    const long long c2_ = OVP_CYCLES();
    __syncthreads();
    OVP_COUNT(4, OVP_CYCLES() - c2_);
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue_next();
    }
    m = m1;
    s = s1;
  }
}

// Long inputs, f64. X [B, M, D] and x [B, M] as n_rows = B·M rows; ws [B,
// max_parts, n_upper, 32, 32] as for gram_rows_kernel. Grid (groups,
// blocks): the tile groups of one row range run side by side, so that the
// later ones find the range in L2; warp w of block (g, i) computes item
// g·items_per_group + w. (A template, so that only the source that launches
// it compiles it.)
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
gram_dmma_rows_kernel(const double* __restrict__ X, const double* __restrict__ x, double* __restrict__ ws, int M,
                      int D, long long n_rows, long long rows_per_block, int chunk_rows, int stages, int max_parts,
                      int items_per_group) {
  extern __shared__ __align__(128) unsigned char smem[];
  OVP_MARK(0);
  const Geom gm = geom(D);
  const int blk = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = blockIdx.x * items_per_group + warp;
  const bool active = warp < items_per_group && w < gm.items;
  const int ntc = (D + kTile) / kTile, n_upper = ntc * (ntc + 1) / 2;
  WarpTile wt;
  wt.init(item(gm, active ? w : 0));
  const long long r_begin = (long long)blk * rows_per_block, r_end = min(r_begin + rows_per_block, n_rows);
  for_each_chunk_y(X, x, r_begin, r_end, M, D, chunk_rows, stages, gm.ldy, smem,
                   [&](const double* Y, long long m0, long long m1) {
                     if (!active) return;
                     wt.mac(Y, gm.ldy, (int)(m1 - m0 + kK - 1) / kK);
                     if (m1 == r_end || m1 % M == 0) {  // the end of a stream's rows in this range
                       const long long b = m0 / M, part = blk - (b * M) / rows_per_block;
                       double* base = ws + (b * max_parts + part) * n_upper * (kTile * kTile);
                       const int g = lane / 4, t = lane % 4;
#pragma unroll
                       for (int f = 0; f < kF; ++f) {
                         if (f < wt.it.n) {
                           int fi, fj;
                           frag_of(wt.it, f, fi, fj);
                           const int ti = fi / 2, tj = fj / 4;
                           const int tt = ti * ntc - ti * (ti - 1) / 2 + tj - ti;
                           double* dst = base + tt * (kTile * kTile) + ((fi & 1) * 16 + g) * kTile + (fj & 3) * 8 + 2 * t;
                           *reinterpret_cast<double2*>(dst) = make_double2(wt.acc[f][0], wt.acc[f][1]);
                           *reinterpret_cast<double2*>(dst + 8 * kTile) = make_double2(wt.acc[f][2], wt.acc[f][3]);
                         }
#pragma unroll
                         for (int i = 0; i < 4; ++i) wt.acc[f][i] = 0.0;
                       }
                     }
                   });
  OVP_MARK(3);
}

constexpr int kPre = 4;  // epilogue elements a thread has in flight

// The MMA operands of rows [k0, k0 + 8) of one stream straight from device
// memory (no staging: a short slice is a few steps), as the staged tile Y
// gives them: lane (g, t) reads rows k0 + 2t and k0 + 2t + 1 of column c;
// column D is x (for B operands; A's rows past D−1 are never stored), rows
// past `rows` and columns past D are zeros.
__device__ __forceinline__ double2 direct_pair(const double* __restrict__ X, const double* __restrict__ x, int D,
                                               int rows, int k, int c, bool with_x) {
  // One address and stride for the column, two predicated loads (no branch: less code).
  const bool in = c < D, col_x = with_x && c == D;
  const double* p = in ? X + (size_t)k * D + c : x + k;
  const int step = in ? D : 1;
  double v0 = 0.0, v1 = 0.0;
  if ((in || col_x) && k < rows) v0 = p[0];
  if ((in || col_x) && k + 1 < rows) v1 = p[step];
  return make_double2(v0, v1);
}

constexpr int kTab = 64;  // the downdate's fragment table: items_per_group · kF entries, at most

// Short inputs, f64. W [B, M, D], u [B, M], P [B, D, D]. Grid (groups ·
// slices, B): block x is share x % slices of tile group x / slices, and
// stores the elements [share·E / slices, (share+1)·E / slices) of E =
// items_per_group · kF · 128. Clusters of `ranks` blocks along x, 1 or
// slices: with a cluster, block rank s takes the stream's rows [s·
// slice_rows, (s+1)·slice_rows) ∩ [0, M) (possibly none) and the ranks'
// sums are added in rank order through distributed shared memory; without
// (slice_rows = M, a short stream), every block takes all the rows and
// stores its share. Warp w computes item group · items_per_group + w %
// items_per_group over the 8-row steps w / items_per_group, + parts, … of
// its rows (parts = warps / items_per_group), its operands loaded straight
// from device memory (the first step's before anything else, the next
// step's during the MMAs). Shared memory: a table of the group's fragments
// (fi << 16 | fj, or −1; none for one item a group), then the warps' sums
// [parts][items_per_group · kF][16][8], added over the parts in order into
// the first. A thread loads the P of its share's first kPre elements first
// (the rest into L2), and after a cluster barrier stores out = P − G, out' =
// out and vec = G[·][D]. (A template, so that only the source that launches
// it compiles it.)
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
downdate_dmma_kernel(const double* __restrict__ W, const double* __restrict__ u, const double* __restrict__ P,
                     double* __restrict__ out, double* __restrict__ vec, int M, int D, int slices,
                     int items_per_group, int slice_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);
  double* part = reinterpret_cast<double*>(smem + kTab * sizeof(int));
  OVP_MARK(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks(), share = blockIdx.x % slices, rank = share % ranks;
  const Geom gm = geom(D);
  const int grp = blockIdx.x / slices, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int parts = (int)(blockDim.x / 32) / items_per_group, piece = warp / items_per_group;
  const int w = grp * items_per_group + warp % items_per_group;
  const bool active = w < gm.items;
  const long long b = blockIdx.y;
  const double* Pb = P + b * D * D;
  const int E = items_per_group * kF * 128, e_begin = (int)((long long)share * E / slices),
            e_end = (int)((long long)(share + 1) * E / slices);
  // This warp's first step of operands, in flight during the table and the P loads.
  const int k_begin = min(rank * slice_rows, M), rows = min((rank + 1) * slice_rows, M) - k_begin;
  const double* Wk = W + (b * M + k_begin) * (long long)D;
  const double* uk = u + b * M + k_begin;
  const int g = lane / 4, t = lane % 4;
  WarpTile wt;
  wt.init(item(gm, active ? w : 0));
  double2 a0, a1, b0, b1, bv[kF];
  auto load_step = [&](int k0) {
    const int k = k0 + 2 * t, ca = 16 * wt.it.fa + g, cb = 16 * wt.it.fb + g;
    a0 = direct_pair(Wk, uk, D, rows, k, ca, false), a1 = direct_pair(Wk, uk, D, rows, k, ca + 8, false);
    b0 = direct_pair(Wk, uk, D, rows, k, cb, false), b1 = direct_pair(Wk, uk, D, rows, k, cb + 8, false);
#pragma unroll
    for (int f = 0; f < kF; ++f)
      if (f < wt.it.n)
        bv[f] = direct_pair(Wk, uk, D, rows, k, 8 * (f < wt.it.na ? wt.it.ja + f : wt.it.jb + f - wt.it.na) + g, true);
  };
  int k0 = 8 * piece;
  if (active && k0 < rows) load_step(k0);
  // The group's fragments: this warp's own item when the group has one (no
  // barrier), else a table that the first threads fill.
  if (items_per_group > 1) {
    if (threadIdx.x < items_per_group * kF) {
      const int wi = grp * items_per_group + threadIdx.x / kF, f = threadIdx.x % kF;
      int fij = -1;
      if (wi < gm.items) {
        const Item it = item(gm, wi);
        int fi, fj;
        frag_of(it, f, fi, fj);
        if (f < it.n) fij = fi << 16 | fj;
      }
      tab[threadIdx.x] = fij;
    }
    __syncthreads();
  }
  auto fragment = [&](int slot) {
    if (items_per_group > 1) return tab[slot];
    int fi, fj;
    frag_of(wt.it, slot, fi, fj);
    return active && slot < wt.it.n ? fi << 16 | fj : -1;
  };
  int ij[kPre];
  double pv[kPre];
  // The elements e0 + k·blockDim.x, k < kPre: their (i, j), or −1, and P (a
  // predicated load, waited for only where the value is used).
  auto load_batch = [&](int e0) {
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int e = e0 + k * blockDim.x, fij = e < e_end ? fragment(e / 128) : -1;
      const int i = 16 * (fij >> 16) + (e / 8) % 16, j = 8 * (fij & 0xffff) + e % 8;
      ij[k] = fij >= 0 && i <= j && j <= D && i < D ? i << 16 | j : -1;
      pv[k] = 0.0;
      if (ij[k] >= 0 && j < D) pv[k] = Pb[(size_t)i * D + j];
    }
  };
  // The later batches' P into L2 meanwhile.
  for (int e = e_begin + threadIdx.x + kPre * blockDim.x; e < e_end; e += blockDim.x) {
    const int fij = fragment(e / 128), i = 16 * (fij >> 16) + (e / 8) % 16, j = 8 * (fij & 0xffff) + e % 8;
    if (fij >= 0 && i <= j && j < D) prefetch_l2(Pb + (size_t)i * D + j);
  }
  load_batch(e_begin + threadIdx.x);
  OVP_MARK(1);
  for (; active && k0 < rows; k0 += 8 * parts) {
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      if (f < wt.it.n) {
        if (f < wt.it.na)
          mma8(wt.acc[f], a0.x, a1.x, a0.y, a1.y, bv[f].x, bv[f].y);
        else
          mma8(wt.acc[f], b0.x, b1.x, b0.y, b1.y, bv[f].x, bv[f].y);
      }
    }
    if (k0 + 8 * parts < rows) load_step(k0 + 8 * parts);
  }
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    double* dst = part + piece * E + ((warp % items_per_group) * kF + f) * 128 + g * 8 + 2 * t;
    *reinterpret_cast<double2*>(dst) = make_double2(wt.acc[f][0], wt.acc[f][1]);
    *reinterpret_cast<double2*>(dst + 64) = make_double2(wt.acc[f][2], wt.acc[f][3]);
  }
  if (parts > 1) {  // the parts' sums, in part order, into the first
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      double sum = part[e];
      for (int r = 1; r < parts; ++r) sum = sum + part[r * E + e];
      part[e] = sum;
    }
  }
  OVP_MARK(3);
  if (ranks > 1)
    cluster.sync();
  else
    __syncthreads();
  OVP_MARK(4);
  const double* src[8];  // the ranks' sums, in rank order
#pragma unroll
  for (int s = 0; s < 8; ++s) src[s] = cluster.map_shared_rank(part, min(s, ranks - 1));
  double* ob = out + b * D * D;
  double* vb = vec + b * D;
#pragma unroll 1
  for (int e0 = e_begin + threadIdx.x;;) {
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      if (ij[k] < 0) continue;
      const int e = e0 + k * blockDim.x;
      double v[8];
#pragma unroll
      for (int s = 0; s < 8; ++s) v[s] = s < ranks ? src[s][e] : 0.0;
      double sum = v[0];
#pragma unroll
      for (int s = 1; s < 8; ++s)
        if (s < ranks) sum = sum + v[s];
      const int i = ij[k] >> 16, j = ij[k] & 0xffff;
      if (j == D) {
        vb[i] = sum;
      } else {
        const double val = pv[k] - sum;
        ob[(size_t)i * D + j] = val;
        ob[(size_t)j * D + i] = val;
      }
    }
    e0 += kPre * blockDim.x;
    if (e0 >= e_end) break;
    load_batch(e0);
  }
  OVP_MARK(5);
  if (ranks > 1) cluster.sync();  // no block leaves while another of its cluster reads its sums
}

// gram_dmma_rows_kernel over `blocks` row ranges, then gram_out_kernel.
static int launch_gram_rows(const double* X, const double* x, double* out, double* vec, double* ws, int B, int M,
                            int D, int blocks, int groups, int warps, int items_per_group, int chunk_rows,
                            int stages, int max_parts, int smem_bytes, long long rows_per_block,
                            cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  static int smem_allowed = 0;
  const int ntc = (D + kTile) / kTile;
  if (blocks > 0) {
    cudaError_t e = allow_smem(gram_dmma_rows_kernel<kMaxThreads>, smem_bytes, smem_allowed);
    if (e != cudaSuccess) return (int)e;
    gram_dmma_rows_kernel<kMaxThreads><<<dim3(groups, blocks), 32 * warps, smem_bytes, stream>>>(
        X, x, ws, M, D, (long long)B * M, rows_per_block, chunk_rows, stages, max_parts, items_per_group);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  gram_out_kernel<double><<<dim3(ntc * (ntc + 1) / 2, B), 128, 0, stream>>>(ws, out, vec, M, D, rows_per_block,
                                                                           max_parts);
  return (int)cudaGetLastError();
}

// downdate_dmma_kernel on grid (groups · slices, B), clusters of `ranks`.
static int launch_downdate(const double* W, const double* u, const double* P, double* out, double* vec, int B,
                           int M, int D, int groups, int slices, int ranks, int warps, int items_per_group,
                           int slice_rows, int smem_bytes, cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  static int smem_allowed = 0;
  const auto kernel = downdate_dmma_kernel<kMaxThreads>;
  cudaError_t e = allow_smem(kernel, smem_bytes, smem_allowed);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * slices, B);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;  // no cluster for one rank
  e = cudaLaunchKernelEx(&cfg, kernel, W, u, P, out, vec, M, D, slices, items_per_group, slice_rows);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace dmma
}  // namespace ovp
