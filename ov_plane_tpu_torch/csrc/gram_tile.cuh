// Shared body of the two Gram-family kernels of the filter update.
//
// Both TPU kernels of the JAX package (ov_plane_tpu/ops/pallas_kernels.py)
// contract a tall matrix with itself and with one extra column:
//   gram_reduce      (Λ, η)       = (HᵀH, Hᵀr)
//   kalman_downdate  (P', dx)     = (P − WᵀW, Wᵀu)
// Written once here as G = AᵀA for the augmented A = [X | x] (x folded in as
// column D), so η / Wᵀu come out of the same pass as the Gram.
//
// Layout of the work (Hopper, not the Pallas grid): the TPU kernel carried a
// VMEM accumulator across a sequential grid axis of row tiles. Here one
// thread block owns one (stream, 32×32 output tile) pair and runs the whole
// row loop itself, staging 32-row chunks of the two column slabs it needs in
// shared memory. Only tiles on or above the diagonal are computed; each
// value is written to (i, j) and mirrored to (j, i), so the outputs are
// bitwise symmetric (the square-root Kalman update relies on that to keep P
// PSD). Accumulation is plain IEEE FMA in the working type (no TF32, no
// tensor cores), one accumulator per output in row order.
#pragma once

#include <cuda_runtime.h>

namespace ovp {

constexpr int kTile = 32;      // output tile edge
constexpr int kChunk = 32;     // input rows staged per step
constexpr int kThreadsX = 16;  // each thread owns a 2×2 block of the tile
constexpr int kThreadsY = 16;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// Element (m, c) of the augmented row block [X | x] of one stream.
template <typename T>
__device__ __forceinline__ T aug_load(const T* __restrict__ X, const T* __restrict__ x,
                                      int m, int c, int M, int D) {
  if (m >= M || c > D) return T(0);
  return c < D ? X[(size_t)m * D + c] : x[m];
}

// X [B, M, D], x [B, M], base [B, D, D] or nullptr; out [B, D, D], vec [B, D].
//   out[i][j] = out[j][i] = base ? base[i][j] − G[i][j] : G[i][j]   (i ≤ j < D)
//   vec[i]    = G[i][D]                                             (i < D)
// Grid: (number of upper tile pairs, B); block: (16, 16).
template <typename T>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
gram_upper_kernel(const T* __restrict__ X, const T* __restrict__ x, const T* __restrict__ base,
                  T* __restrict__ out, T* __restrict__ vec, int M, int D, int ntiles) {
  int p = blockIdx.x, ti = 0;
  while (p >= ntiles - ti) {
    p -= ntiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const size_t b = blockIdx.y;
  X += b * (size_t)M * D;
  x += b * (size_t)M;

  __shared__ T Ai[kChunk][kTile];
  __shared__ T Aj[kChunk][kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int ci0 = ti * kTile, cj0 = tj * kTile;

  T acc00 = T(0), acc01 = T(0), acc10 = T(0), acc11 = T(0);
  for (int m0 = 0; m0 < M; m0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += kThreadsX * kThreadsY) {
      const int k = e / kTile, c = e % kTile;
      Ai[k][c] = aug_load(X, x, m0 + k, ci0 + c, M, D);
      Aj[k][c] = aug_load(X, x, m0 + k, cj0 + c, M, D);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const T a0 = Ai[k][ty], a1 = Ai[k][ty + 16];
      const T b0 = Aj[k][tx], b1 = Aj[k][tx + 16];
      acc00 = fma_rn(a0, b0, acc00);
      acc01 = fma_rn(a0, b1, acc01);
      acc10 = fma_rn(a1, b0, acc10);
      acc11 = fma_rn(a1, b1, acc11);
    }
    __syncthreads();
  }

  const T acc[2][2] = {{acc00, acc01}, {acc10, acc11}};
  out += b * (size_t)D * D;
  vec += b * (size_t)D;
  if (base != nullptr) base += b * (size_t)D * D;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = ci0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = cj0 + tx + 16 * c;
      if (i > j || i >= D) continue;
      const T g = acc[a][c];
      if (j < D) {
        const T v = base != nullptr ? base[(size_t)i * D + j] - g : g;
        out[(size_t)i * D + j] = v;
        out[(size_t)j * D + i] = v;
      } else if (j == D) {
        vec[i] = g;
      }
    }
  }
}

template <typename T>
int launch_gram_upper(const T* X, const T* x, const T* base, T* out, T* vec,
                      int B, int M, int D, cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  const int ntiles = (D + 1 + kTile - 1) / kTile;
  const dim3 grid(ntiles * (ntiles + 1) / 2, B);
  const dim3 block(kThreadsX, kThreadsY);
  gram_upper_kernel<T><<<grid, block, 0, stream>>>(X, x, base, out, vec, M, D, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace ovp
