// The simple 32×32 shared-memory tile kernel that first ported both Gram-family
// TPU kernels, kept only as a yardstick outside the package: chip_smoke.py
// builds it and times it beside the kernels of
// ov_plane_tpu_torch/csrc/gram_tile.cuh on the same inputs (its
// "earlier_device_ms"). Nothing in the filter calls it.
//
// One thread block owns one (stream, 32×32 upper output tile) pair and runs
// the whole row loop, staging 32-row chunks of its two column slabs element
// by element; each thread owns a 2×2 block (4 shared loads for 4 FMAs), and
// the mirrored store writes a strided column.
//   out[i][j] = out[j][i] = base ? base[i][j] − G[i][j] : G[i][j]   (i ≤ j < D)
//   vec[i]    = G[i][D],   G = AᵀA for A = [X | x]
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kChunk = 32;
constexpr int kThreads = 16;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__device__ __forceinline__ T aug_load(const T* __restrict__ X, const T* __restrict__ x,
                                      int m, int c, int M, int D) {
  if (m >= M || c > D) return T(0);
  return c < D ? X[(size_t)m * D + c] : x[m];
}

template <typename T>
__global__ void __launch_bounds__(kThreads * kThreads)
gram_simple_kernel(const T* __restrict__ X, const T* __restrict__ x, const T* __restrict__ base,
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
  const int tid = ty * kThreads + tx;
  const int ci0 = ti * kTile, cj0 = tj * kTile;

  T acc00 = T(0), acc01 = T(0), acc10 = T(0), acc11 = T(0);
  for (int m0 = 0; m0 < M; m0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += kThreads * kThreads) {
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
int launch(const T* X, const T* x, const T* base, T* out, T* vec, int B, int M, int D,
           cudaStream_t stream) {
  if (B <= 0 || D <= 0) return 0;
  const int ntiles = (D + 1 + kTile - 1) / kTile;
  gram_simple_kernel<T><<<dim3(ntiles * (ntiles + 1) / 2, B), dim3(kThreads, kThreads), 0, stream>>>(
      X, x, base, out, vec, M, D, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ovp_gram_simple_f32(const float* X, const float* x, const float* base, float* out, float* vec,
                        int B, int M, int D, void* stream) {
  return launch<float>(X, x, base, out, vec, B, M, D, (cudaStream_t)stream);
}

int ovp_gram_simple_f64(const double* X, const double* x, const double* base, double* out,
                        double* vec, int B, int M, int D, void* stream) {
  return launch<double>(X, x, base, out, vec, B, M, D, (cudaStream_t)stream);
}

}  // extern "C"
