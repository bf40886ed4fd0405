// (P', dx) = (P − WᵀW, Wᵀu) for B independent streams; replaces the Pallas
// kernel kalman_downdate_pallas (ov_plane_tpu/ops/pallas_kernels.py:249,
// kernel body _downdate_kernel_batched :162). It closes the square-root EKF
// update (ops/ekf.kalman_update) after the triangular solves give
// W = L⁻¹(HP) and u = L⁻¹res. Design and numerics: gram_tile.cuh; the upper
// triangle of P − WᵀW is mirrored, so P' is bitwise symmetric.
//
// Bound on an H100 SXM at its 700 W limit, at the filter's shapes (B=64,
// M=D=93, f32): P, W, u, P' and dx are 6.7 MB, 2.0 µs at 3.35 TB/s; the work
// is 0.053 GFLOP. At so few rows the time is a chain of latencies (launch,
// one copy, a stream's 93 rows, the stores), not bytes. So the design keeps
// the chain to one launch and one copy: rows are not split, the upper tiles
// of a stream are spread over enough blocks that B·groups fills the SMs,
// each block stages the stream's whole W with one bulk copy, and its
// epilogue reads P's tile and writes P' and its transpose, both coalesced.
#include "gram_tile.cuh"

// Launch arguments: ops/kernels.stream_plan (gram_stream_kernel).
extern "C" {

int ovp_kalman_downdate_f32(const float* cov, const float* W, const float* u, float* new_cov,
    float* dx, int B, int M, int D, int groups, int tiles, int threads, int chunk_rows, int stages,
    int smem_bytes, void* stream) {
  return ovp::launch_gram_stream<float>(W, u, cov, new_cov, dx, B, M, D, groups, tiles, threads,
                                        chunk_rows, stages, smem_bytes, (cudaStream_t)stream);
}

int ovp_kalman_downdate_f64(const double* cov, const double* W, const double* u, double* new_cov,
    double* dx, int B, int M, int D, int groups, int tiles, int threads, int chunk_rows, int stages,
    int smem_bytes, void* stream) {
  return ovp::launch_gram_stream<double>(W, u, cov, new_cov, dx, B, M, D, groups, tiles, threads,
                                         chunk_rows, stages, smem_bytes, (cudaStream_t)stream);
}

}  // extern "C"
