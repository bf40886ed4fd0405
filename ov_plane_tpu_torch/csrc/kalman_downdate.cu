// (P', dx) = (P − WᵀW, Wᵀu) for B independent streams; replaces the Pallas
// kernel kalman_downdate_pallas (ov_plane_tpu/ops/pallas_kernels.py:248,
// kernel body _downdate_kernel_batched :162). It closes the square-root EKF
// update (ops/ekf.kalman_update) after the triangular solves give
// W = L⁻¹(HP) and u = L⁻¹res. Tile layout and numerics: gram_tile.cuh; the
// upper triangle of P − WᵀW is mirrored, so P' is bitwise symmetric.
//
// Bound on an H100 SXM at the filter's shapes (B=64, M=D=93, f32): P, W and
// P' are 6.6 MB, ≈ 2 µs at 3.35 TB/s; the work is 0.05 GFLOP. Launch
// overhead dominates at this size.
#include "gram_tile.cuh"

extern "C" {

int ovp_kalman_downdate_f32(const float* cov, const float* W, const float* u, float* new_cov,
                            float* dx, int B, int M, int D, void* stream) {
  return ovp::launch_gram_upper<float>(W, u, cov, new_cov, dx, B, M, D, (cudaStream_t)stream);
}

int ovp_kalman_downdate_f64(const double* cov, const double* W, const double* u, double* new_cov,
                            double* dx, int B, int M, int D, void* stream) {
  return ovp::launch_gram_upper<double>(W, u, cov, new_cov, dx, B, M, D, (cudaStream_t)stream);
}

}  // extern "C"
