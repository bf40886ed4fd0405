// (Λ, η) = (HᵀH, Hᵀr) for B independent streams; replaces the Pallas kernel
// gram_reduce_pallas (ov_plane_tpu/ops/pallas_kernels.py:137, kernel body
// _gram_kernel_batched :43). Tile layout and numerics: gram_tile.cuh.
//
// Bound on an H100 SXM at the filter's shapes (B=64, M=1320, D=93, f32):
// reading H once is 31.4 MB, ≈ 9.4 µs at 3.35 TB/s; the upper triangle plus
// η is 0.74 GFLOP, ≈ 11 µs at the 67 TFLOP/s f32 rate outside the tensor
// cores. Each block re-reads its two 32-column slabs of H (the column tiles
// of the upper triangle share slabs), so the kernel moves about 4× the
// minimal bytes, mostly out of L2.
#include "gram_tile.cuh"

extern "C" {

int ovp_gram_reduce_f32(const float* H, const float* r, float* lam, float* eta,
                        int B, int M, int D, void* stream) {
  return ovp::launch_gram_upper<float>(H, r, nullptr, lam, eta, B, M, D, (cudaStream_t)stream);
}

int ovp_gram_reduce_f64(const double* H, const double* r, double* lam, double* eta,
                        int B, int M, int D, void* stream) {
  return ovp::launch_gram_upper<double>(H, r, nullptr, lam, eta, B, M, D, (cudaStream_t)stream);
}

}  // extern "C"
