// (Λ, η) = (HᵀH, Hᵀr) for B independent streams; replaces the Pallas kernel
// gram_reduce_pallas (ov_plane_tpu/ops/pallas_kernels.py:138, kernel body
// _gram_kernel_batched :43). f32: gram_tile.cuh; f64: gram_dmma.cuh (the
// f64 tensor cores, with its own bound and design notes).
//
// f32 bound on an H100 SXM at its 700 W limit, at the filter's shapes (B=64,
// M=1320, D=93): the upper triangle plus η is 0.754 GFLOP, 11.3 µs at
// the 67 TFLOP/s f32 rate outside the tensor cores; reading H once is
// 34.0 MB, 10.1 µs at 3.35 TB/s. So the FMA pipes bound it. The f32 design
// feeds them: every SM gets the same number of rows (equal row ranges, one
// wave of three blocks per SM), H is read once from device memory by bulk
// copies that run ahead of the math, and each lane holds a 4×8 block of its
// warp's tile. The full 32×32 warp tiles on the diagonal compute 6144
// products per row for 4464 needed, which caps the f32 kernel at 73 % of the
// bound; PERF.md has what it reaches.
#include "gram_dmma.cuh"

// Launch arguments: ops/kernels.launch_plan (f32: gram_rows_kernel, then
// gram_out_kernel) and ops/kernels.gram_f64_plan (f64: gram_dmma_rows_kernel,
// then gram_out_kernel).
extern "C" {

int ovp_gram_reduce_f32(const float* H, const float* r, float* lam, float* eta, float* ws,
    int B, int M, int D, int blocks, int groups, int warps, int chunk_rows, int stages,
    int max_parts, int smem_bytes, long long rows_per_block, void* stream) {
  return ovp::launch_gram_rows<float>(H, r, lam, eta, ws, B, M, D, blocks, groups, warps,
                                   chunk_rows, stages, max_parts, smem_bytes, rows_per_block,
                                   (cudaStream_t)stream);
}

int ovp_gram_reduce_f64(const double* H, const double* r, double* lam, double* eta, double* ws,
    int B, int M, int D, int blocks, int groups, int warps, int items_per_group, int chunk_rows,
    int stages, int max_parts, int smem_bytes, long long rows_per_block, void* stream) {
  return ovp::dmma::launch_gram_rows(H, r, lam, eta, ws, B, M, D, blocks, groups, warps,
                                     items_per_group, chunk_rows, stages, max_parts, smem_bytes,
                                     rows_per_block, (cudaStream_t)stream);
}

}  // extern "C"
