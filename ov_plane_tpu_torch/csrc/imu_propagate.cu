// The IMU window's mean and covariance propagation for B independent
// streams (ops/kernels.imu_propagate): the function of
// state/propagator.propagate_mean_cov_ref in one launch. It replaces no TPU
// kernel. The JAX package scans the window inside one XLA program
// (ov_plane_tpu/state/propagator.py); the port's plain version walks it as a
// Python loop over the sample pairs, some 630 small launches a pair, 40
// thousand a frame at 64 samples.
//
// Per valid sample pair (clipped to [t0, t1]; a pair whose clipped dt is not
// finite or not > 0 leaves every output untouched): the RK4 or discrete mean,
// the FEJ or standard Φ factor F and noise Jacobian G (Propagator.cpp:343-569),
// Qd_s = sym(G Qc Gᵀ) with Qc = diag(σ_w²/dt, σ_a²/dt, σ_wb²·dt, σ_ab²·dt),
// then Φ ← FΦ and Qd ← F Qd Fᵀ + Qd_s.
//
// Bound on an H100 SXM at its 700 W limit, at the benchmark's shape (B =
// 1024, W = 64, f32): the samples, states and outputs are 3.96 MB, 1.2 µs at
// 3.35 TB/s; with F's and G's zero blocks skipped a pair is about 7 kFLOP a
// stream (the plain loop's dense products take 26 k), 0.45 GFLOP a call, 6.7
// µs at 67 TFLOP/s. Neither binds: each stream is a chain of 63 dependent
// steps (four RK4 stages of normalisations and divisions, the Jacobian's
// sines), so the chain's latency sets the time. The design keeps that chain
// on chip and short: one warp per stream; its window staged in shared memory
// by one coalesced load per 64 pairs; every lane computes the mean and F's
// and G's blocks redundantly in registers (no broadcast); lane j < 15 keeps
// column j of Φ and of Qd in registers, so FΦ and F·Qd are register
// products, and the second product of F Qd Fᵀ reads rows of F·Qd from a
// 15×15 tile in shared memory between two __syncwarp. No atomics, and every
// sum in a fixed order, so two calls give the same bits.
#include <cuda_runtime.h>

namespace ovp_imu {

constexpr int kWarps = 4;           // streams per block, one warp each
constexpr int kChunk = 64;          // sample pairs staged per pass
constexpr int kLd = 17;             // row stride of the exchange tile: lane j reads row j without conflicts
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float vsin(float x) { return sinf(x); }
__device__ __forceinline__ double vsin(double x) { return sin(x); }
__device__ __forceinline__ float vcos(float x) { return cosf(x); }
__device__ __forceinline__ double vcos(double x) { return cos(x); }

// torch.maximum / torch.minimum: a NaN on either side gives NaN.
template <typename T> __device__ __forceinline__ T tmax(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T> __device__ __forceinline__ T tmin(T a, T b) { return (a < b || a != a) ? a : b; }
// Finite: x − x is 0 for a finite x and NaN for ±inf and NaN.
template <typename T> __device__ __forceinline__ bool finite(T x) { return x - x == T(0); }

// ⌊v⌋ with ⌊v⌋u = v × u (ops/quat.skew).
template <typename T> __device__ __forceinline__ void skew(const T v[3], T S[3][3]) {
  S[0][0] = T(0);  S[0][1] = -v[2]; S[0][2] = v[1];
  S[1][0] = v[2];  S[1][1] = T(0);  S[1][2] = -v[0];
  S[2][0] = -v[1]; S[2][1] = v[0];  S[2][2] = T(0);
}

// C = A B for 3×3 blocks.
template <typename T> __device__ __forceinline__ void mm3(const T A[3][3], const T B[3][3], T C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) C[i][k] = A[i][0] * B[0][k] + A[i][1] * B[1][k] + A[i][2] * B[2][k];
}

// q / ‖q‖, its scalar part made non-negative (ops/quat.quat_norm).
template <typename T> __device__ __forceinline__ void quat_norm(T q[4]) {
  const T n = vsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
  if (q[3] < T(0)) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = -q[k];
  }
}

// R_GtoL = (2w² − 1) I − 2w ⌊q_v⌋ + 2 q_v q_vᵀ (ops/quat.quat_2_rot).
template <typename T> __device__ __forceinline__ void quat_2_rot(const T q[4], T R[3][3]) {
  const T d = T(2) * (q[3] * q[3]) - T(1);
  const T w2 = T(2) * q[3];
  T S[3][3];
  skew(q, S);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) R[i][k] = ((i == k ? d : T(0)) - w2 * S[i][k]) + T(2) * (q[i] * q[k]);
}

// The normalised JPL product q ⊗ p (ops/quat.quat_multiply).
template <typename T> __device__ __forceinline__ void quat_multiply(const T q[4], const T p[4], T o[4]) {
  o[0] = q[3] * p[0] + q[2] * p[1] - q[1] * p[2] + q[0] * p[3];
  o[1] = -q[2] * p[0] + q[3] * p[1] + q[0] * p[2] + q[1] * p[3];
  o[2] = q[1] * p[0] - q[0] * p[1] + q[3] * p[2] + q[2] * p[3];
  o[3] = -q[0] * p[0] - q[1] * p[1] - q[2] * p[2] + q[3] * p[3];
  quat_norm(o);
}

// Ω(ω) q with q̇ = ½ Ω(ω) q (ops/quat.omega).
template <typename T> __device__ __forceinline__ void omega_mv(const T w[3], const T q[4], T o[4]) {
  const T O[4][4] = {{T(0), w[2], -w[1], w[0]}, {-w[2], T(0), w[0], w[1]},
                     {w[1], -w[0], T(0), w[2]}, {-w[0], -w[1], -w[2], T(0)}};
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = O[i][0] * q[0] + O[i][1] * q[1] + O[i][2] * q[2] + O[i][3] * q[3];
}

// Rᵀ a for R [3][3].
template <typename T> __device__ __forceinline__ void mtv3(const T R[3][3], const T a[3], T o[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = R[0][i] * a[0] + R[1][i] * a[1] + R[2][i] * a[2];
}

// The SO(3) right Jacobian and exponential, guarded on θ² < 1e-14 (ops/quat.jr_so3, exp_so3).
template <typename T> __device__ __forceinline__ void jr_exp(const T w[3], T J[3][3], T E[3][3], bool want_exp) {
  const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < T(1e-14);
  const T th2s = small ? T(1) : th2;
  const T th = vsqrt(th2s);
  const T s = vsin(th), c = vcos(th);
  const T Bc = small ? T(0.5) - th2 / T(24) : (T(1) - c) / th2s;
  const T Cc = small ? T(1.0 / 6.0) - th2 / T(120) : (th - s) / (th2s * th);
  T W[3][3], W2[3][3];
  skew(w, W);
  mm3(W, W, W2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) J[i][k] = ((i == k ? T(1) : T(0)) - Bc * W[i][k]) + Cc * W2[i][k];
  if (want_exp) {
    const T Ac = small ? T(1) - th2 / T(6) : s / th;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) E[i][k] = ((i == k ? T(1) : T(0)) + Ac * W[i][k]) + Bc * W2[i][k];
  }
}

// q̇ ⊗ … and v̇ of one RK4 stage, each times dt.
template <typename T>
__device__ __forceinline__ void rk4_stage(const T dq[4], const T w[3], const T a[3], const T q0[4], const T g[3],
                                          T dt, T kq[4], T kv[3]) {
  T o[4], qq[4], R[3][3], ra[3];
  omega_mv(w, dq, o);
#pragma unroll
  for (int k = 0; k < 4; ++k) kq[k] = (T(0.5) * o[k]) * dt;
  quat_multiply(dq, q0, qq);
  quat_2_rot(qq, R);
  mtv3(R, a, ra);
#pragma unroll
  for (int k = 0; k < 3; ++k) kv[k] = (ra[k] - g[k]) * dt;
}

// RK4 over one interval (state/propagator.predict_mean_rk4); w1..a2 without bias.
template <typename T>
__device__ __forceinline__ void mean_rk4(const T imu[16], T dt, const T w1[3], const T a1[3], const T w2[3],
                                         const T a2[3], const T g[3], T nq[4], T np[3], T nv[3]) {
  const T* q0 = imu;
  const T* p0 = imu + 4;
  const T* v0 = imu + 7;
  T w_alpha[3], a_jerk[3], wh[3], ah[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w_alpha[k] = (w2[k] - w1[k]) / dt;
    a_jerk[k] = (a2[k] - a1[k]) / dt;
  }
  const T dq0[4] = {T(0), T(0), T(0), T(1)};
  T k1q[4], k1v[3], k2q[4], k2v[3], k3q[4], k3v[3], k4q[4], k4v[3], dq[4], vs[3];
  T k1p[3], k2p[3], k3p[3], k4p[3];
  rk4_stage(dq0, w1, a1, q0, g, dt, k1q, k1v);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    k1p[k] = v0[k] * dt;
    wh[k] = w1[k] + (T(0.5) * w_alpha[k]) * dt;
    ah[k] = a1[k] + (T(0.5) * a_jerk[k]) * dt;
    vs[k] = v0[k] + T(0.5) * k1v[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dq[k] = dq0[k] + T(0.5) * k1q[k];
  quat_norm(dq);
  rk4_stage(dq, wh, ah, q0, g, dt, k2q, k2v);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    k2p[k] = vs[k] * dt;
    vs[k] = v0[k] + T(0.5) * k2v[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dq[k] = dq0[k] + T(0.5) * k2q[k];
  quat_norm(dq);
  rk4_stage(dq, wh, ah, q0, g, dt, k3q, k3v);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    k3p[k] = vs[k] * dt;
    wh[k] = w1[k] + w_alpha[k] * dt;
    ah[k] = a1[k] + a_jerk[k] * dt;
    vs[k] = v0[k] + k3v[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dq[k] = dq0[k] + k3q[k];
  quat_norm(dq);
  rk4_stage(dq, wh, ah, q0, g, dt, k4q, k4v);
#pragma unroll
  for (int k = 0; k < 3; ++k) k4p[k] = vs[k] * dt;
#pragma unroll
  for (int k = 0; k < 4; ++k) dq[k] = dq0[k] + (((k1q[k] + T(2) * k2q[k]) + T(2) * k3q[k]) + k4q[k]) / T(6);
  quat_norm(dq);
  quat_multiply(dq, q0, nq);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    np[k] = p0[k] + (((k1p[k] + T(2) * k2p[k]) + T(2) * k3p[k]) + k4p[k]) / T(6);
    nv[k] = v0[k] + (((k1v[k] + T(2) * k2v[k]) + T(2) * k3v[k]) + k4v[k]) / T(6);
  }
}

// Constant-measurement integration (state/propagator.predict_mean_discrete).
template <typename T, bool kAvg>
__device__ __forceinline__ void mean_discrete(const T imu[16], T dt, const T w1[3], const T a1[3], const T w2[3],
                                              const T a2[3], const T g[3], T nq[4], T np[3], T nv[3]) {
  const T* q0 = imu;
  const T* p0 = imu + 4;
  const T* v0 = imu + 7;
  T wh[3], ah[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    wh[k] = kAvg ? T(0.5) * (w1[k] + w2[k]) : w1[k];
    ah[k] = kAvg ? T(0.5) * (a1[k] + a2[k]) : a1[k];
  }
  const T wn = vsqrt(wh[0] * wh[0] + wh[1] * wh[1] + wh[2] * wh[2]);
  const bool big = wn > T(1e-20);
  const T wn_s = big ? wn : T(1);
  const T hw = (T(0.5) * wn) * dt;
  const T c = vcos(hw), s = vsin(hw) / wn_s, h = T(0.5) * dt;
  const T O[4][4] = {{T(0), wh[2], -wh[1], wh[0]}, {-wh[2], T(0), wh[0], wh[1]},
                     {wh[1], -wh[0], T(0), wh[2]}, {-wh[0], -wh[1], -wh[2], T(0)}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T e = big ? (i == k ? c : T(0)) + s * O[i][k] : (i == k ? T(1) : T(0)) + h * O[i][k];
      acc = k == 0 ? e * q0[0] : acc + e * q0[k];
    }
    nq[i] = acc;
  }
  quat_norm(nq);
  T R[3][3], ra[3];
  quat_2_rot(q0, R);
  mtv3(R, ah, ra);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    nv[k] = (v0[k] + ra[k] * dt) - g[k] * dt;
    np[k] = ((p0[k] + v0[k] * dt) + ((T(0.5) * ra[k]) * dt) * dt) - ((T(0.5) * g[k]) * dt) * dt;
  }
}

// F's and G's non-trivial 3×3 blocks (state/propagator._phi_g_blocks). By
// block rows and columns of 3, F = [D 0 0 Th 0; A I dt·I 0 Cp; Bv 0 I 0 Cv;
// 0 0 0 I 0; 0 0 0 0 I] and G = [Th 0 0 0; 0 Cp 0 0; 0 Cv 0 0; 0 0 I 0;
// 0 0 0 I].
template <typename T> struct Blocks {
  T D[3][3], Th[3][3], A[3][3], Bv[3][3], Cp[3][3], Cv[3][3];
  T dt;
};

template <typename T, bool kFej>
__device__ __forceinline__ void make_blocks(const T imu[16], const T fej[16], const T nq[4], const T np[3],
                                            const T nv[3], T dt, const T wh[3], const T ah[3], const T g[3],
                                            Blocks<T>& f) {
  T R[3][3], RT[3][3], J[3][3], E[3][3], S[3][3], x[3];
  f.dt = dt;
  const T wdt[3] = {-wh[0] * dt, -wh[1] * dt, -wh[2] * dt};
  if (kFej) {
    quat_2_rot(fej, R);
  } else {
    quat_2_rot(imu, R);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) RT[i][k] = R[k][i];
  jr_exp(wdt, J, E, !kFej);
  if (kFej) {
    T Rn[3][3];
    quat_2_rot(nq, Rn);
    mm3(Rn, RT, f.D);  // dR = R(new_q) R_fejᵀ
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) f.D[i][k] = E[i][k];
  }
  T nD[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) nD[i][k] = -f.D[i][k];
  mm3(nD, J, f.Th);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f.Th[i][k] = f.Th[i][k] * dt;
      f.Cv[i][k] = -RT[i][k] * dt;
      f.Cp[i][k] = ((T(-0.5) * RT[i][k]) * dt) * dt;
    }
  if (kFej) {
    const T* pf = fej + 4;
    const T* vf = fej + 7;
    T nS[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = (nv[k] - vf[k]) + g[k] * dt;
    skew(x, S);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) nS[i][k] = -S[i][k];
    mm3(nS, RT, f.Bv);
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = ((np[k] - pf[k]) - vf[k] * dt) + ((T(0.5) * g[k]) * dt) * dt;
    skew(x, S);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) nS[i][k] = -S[i][k];
    mm3(nS, RT, f.A);
  } else {
    T nR[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) nR[i][k] = -RT[i][k];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = ah[k] * dt;
    skew(x, S);
    mm3(nR, S, f.Bv);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) nR[i][k] = T(-0.5) * RT[i][k];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = (ah[k] * dt) * dt;
    skew(x, S);
    mm3(nR, S, f.A);
  }
}

// y = F x, F's zero blocks skipped (the terms in the dense product's order).
template <typename T> __device__ __forceinline__ void apply_f(const Blocks<T>& f, const T x[15], T y[15]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    y[i] = ((((f.D[i][0] * x[0] + f.D[i][1] * x[1]) + f.D[i][2] * x[2]) + f.Th[i][0] * x[9]) + f.Th[i][1] * x[10]) +
           f.Th[i][2] * x[11];
    y[3 + i] = (((((f.A[i][0] * x[0] + f.A[i][1] * x[1]) + f.A[i][2] * x[2]) + x[3 + i]) + f.dt * x[6 + i]) +
                f.Cp[i][0] * x[12] + f.Cp[i][1] * x[13]) + f.Cp[i][2] * x[14];
    y[6 + i] = (((((f.Bv[i][0] * x[0] + f.Bv[i][1] * x[1]) + f.Bv[i][2] * x[2]) + x[6 + i]) + f.Cv[i][0] * x[12]) +
                f.Cv[i][1] * x[13]) + f.Cv[i][2] * x[14];
    y[9 + i] = x[9 + i];
    y[12 + i] = x[12 + i];
  }
}

// Column j of Qd_s = ½(Qd + Qdᵀ), Qd = G (Qc Gᵀ) (state/propagator.predict_and_compute).
template <typename T>
__device__ __forceinline__ void qd_column(const Blocks<T>& f, int j, const T qc[4], T col[15]) {
  T gj[3];  // G's row j within its column block
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    T v = T(0);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      v = j == r ? f.Th[r][m] : v;
      v = j == 3 + r ? f.Cp[r][m] : v;
      v = j == 6 + r ? f.Cv[r][m] : v;
    }
    gj[m] = v;
  }
#pragma unroll
  for (int i = 0; i < 15; ++i) col[i] = T(0);
  if (j < 3) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T a = (f.Th[i][0] * (qc[0] * gj[0]) + f.Th[i][1] * (qc[0] * gj[1])) + f.Th[i][2] * (qc[0] * gj[2]);
      const T b = (gj[0] * (qc[0] * f.Th[i][0]) + gj[1] * (qc[0] * f.Th[i][1])) + gj[2] * (qc[0] * f.Th[i][2]);
      col[i] = T(0.5) * (a + b);
    }
  } else if (j < 9) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T a = (f.Cp[i][0] * (qc[1] * gj[0]) + f.Cp[i][1] * (qc[1] * gj[1])) + f.Cp[i][2] * (qc[1] * gj[2]);
      const T b = (gj[0] * (qc[1] * f.Cp[i][0]) + gj[1] * (qc[1] * f.Cp[i][1])) + gj[2] * (qc[1] * f.Cp[i][2]);
      col[3 + i] = T(0.5) * (a + b);
      const T c = (f.Cv[i][0] * (qc[1] * gj[0]) + f.Cv[i][1] * (qc[1] * gj[1])) + f.Cv[i][2] * (qc[1] * gj[2]);
      const T d = (gj[0] * (qc[1] * f.Cv[i][0]) + gj[1] * (qc[1] * f.Cv[i][1])) + gj[2] * (qc[1] * f.Cv[i][2]);
      col[6 + i] = T(0.5) * (c + d);
    }
  } else {
#pragma unroll
    for (int i = 9; i < 15; ++i) col[i] = i == j ? (j < 12 ? qc[2] : qc[3]) : T(0);
  }
}

template <typename T, bool kRk4, bool kFej, bool kAvg>
__global__ void __launch_bounds__(32 * kWarps)
imu_propagate_kernel(const T* __restrict__ imu_in, const T* __restrict__ fej_in, const T* __restrict__ imu_t,
                     const T* __restrict__ imu_w, const T* __restrict__ imu_a, const T* __restrict__ t0s,
                     const T* __restrict__ t1s, const T* __restrict__ noises, const T* __restrict__ gravity,
                     T* __restrict__ imu_out, T* __restrict__ fej_out, T* __restrict__ phi_out,
                     T* __restrict__ qd_out, T* __restrict__ last_w_out, int B, int W) {
  __shared__ T s_t[kWarps][kChunk + 1];
  __shared__ T s_w[kWarps][3 * (kChunk + 1)];
  __shared__ T s_a[kWarps][3 * (kChunk + 1)];
  __shared__ T s_x[kWarps][15 * kLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warps: every __syncwarp below is the warp's own

  T imu[16], fej[16], g[3], nz[4], last_w[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    imu[k] = imu_in[b * 16 + k];
    fej[k] = fej_in[b * 16 + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) g[k] = gravity[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) nz[k] = noises[k];
  const T t0 = t0s[b], t1 = t1s[b];
  // Lane j < 15: column j of Φ (from I) and of Qd (from 0).
  T phi[15], qd[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) {
    phi[i] = i == lane ? T(1) : T(0);
    qd[i] = T(0);
  }
  const T* tb = imu_t + b * W;
  const T* wb = imu_w + b * W * 3;
  const T* ab = imu_a + b * W * 3;
  T* xs = s_x[warp];

  for (int c0 = 0; c0 + 1 < W; c0 += kChunk) {
    const int ns = min(kChunk + 1, W - c0);  // samples of this pass: pairs (c0 + n, c0 + n + 1)
    __syncwarp(kFull);
    for (int e = lane; e < ns; e += 32) s_t[warp][e] = tb[c0 + e];
    for (int e = lane; e < 3 * ns; e += 32) {
      s_w[warp][e] = wb[3 * c0 + e];
      s_a[warp][e] = ab[3 * c0 + e];
    }
    __syncwarp(kFull);
    for (int n = 0; n + 1 < ns; ++n) {
      const T ta_r = s_t[warp][n], tb_r = s_t[warp][n + 1];
      const T ta = tmin(tmax(ta_r, t0), t1), tbc = tmin(tmax(tb_r, t0), t1);
      const T dt = tbc - ta;
      if (!(dt > T(0) && finite(dt))) continue;  // the same on every lane
      // The boundary samples interpolated over the pair's span (a span of
      // zero or less takes the first sample).
      const bool span = tb_r > ta_r;
      const T den = span ? tb_r - ta_r : T(1);
      const T l1 = span ? (ta - ta_r) / den : T(0), l2 = span ? (tbc - ta_r) / den : T(0);
      T w1[3], a1[3], w2[3], a2[3], wh1[3], ah1[3], wh2[3], ah2[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T wa = s_w[warp][3 * n + k], wbk = s_w[warp][3 * n + 3 + k];
        const T aa = s_a[warp][3 * n + k], abk = s_a[warp][3 * n + 3 + k];
        w1[k] = (T(1) - l1) * wa + l1 * wbk;
        a1[k] = (T(1) - l1) * aa + l1 * abk;
        w2[k] = (T(1) - l2) * wa + l2 * wbk;
        a2[k] = (T(1) - l2) * aa + l2 * abk;
        wh1[k] = w1[k] - imu[10 + k];
        ah1[k] = a1[k] - imu[13 + k];
        wh2[k] = w2[k] - imu[10 + k];
        ah2[k] = a2[k] - imu[13 + k];
      }
      T nq[4], np[3], nv[3];
      if (kRk4) {
        mean_rk4(imu, dt, wh1, ah1, wh2, ah2, g, nq, np, nv);
      } else {
        mean_discrete<T, kAvg>(imu, dt, wh1, ah1, wh2, ah2, g, nq, np, nv);
      }
      Blocks<T> f;
      make_blocks<T, kFej>(imu, fej, nq, np, nv, dt, wh1, ah1, g, f);

      T y[15];
      if (lane < 15) {
        apply_f(f, phi, y);
#pragma unroll
        for (int i = 0; i < 15; ++i) phi[i] = y[i];
        apply_f(f, qd, y);  // column j of F·Qd
#pragma unroll
        for (int i = 0; i < 15; ++i) xs[i * kLd + lane] = y[i];
      }
      __syncwarp(kFull);
      if (lane < 15) {
        T m[15], qs[15];
#pragma unroll
        for (int k = 0; k < 15; ++k) m[k] = xs[lane * kLd + k];  // row j of F·Qd
        apply_f(f, m, y);  // column j of F (F·Qd)ᵀ = F Qd Fᵀ
        const T qc[4] = {nz[0] / dt, nz[1] / dt, nz[2] * dt, nz[3] * dt};
        qd_column(f, lane, qc, qs);
#pragma unroll
        for (int i = 0; i < 15; ++i) qd[i] = y[i] + qs[i];
      }
      __syncwarp(kFull);
#pragma unroll
      for (int k = 0; k < 3; ++k) last_w[k] = w2[k] - imu[10 + k];
#pragma unroll
      for (int k = 0; k < 4; ++k) imu[k] = nq[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        imu[4 + k] = np[k];
        imu[7 + k] = nv[k];
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) fej[k] = imu[k];
    }
  }
  if (lane < 15) {
#pragma unroll
    for (int i = 0; i < 15; ++i) {
      phi_out[b * 225 + i * 15 + lane] = phi[i];
      qd_out[b * 225 + i * 15 + lane] = qd[i];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      imu_out[b * 16 + k] = imu[k];
      fej_out[b * 16 + k] = fej[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) last_w_out[b * 3 + k] = last_w[k];
  }
}

template <typename T, bool kRk4, bool kFej, bool kAvg>
static int launch(const T* imu, const T* fej, const T* t, const T* w, const T* a, const T* t0, const T* t1,
                  const T* noises, const T* gravity, T* imu_out, T* fej_out, T* phi, T* qd, T* last_w, int B, int W,
                  cudaStream_t stream) {
  imu_propagate_kernel<T, kRk4, kFej, kAvg><<<(B + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
      imu, fej, t, w, a, t0, t1, noises, gravity, imu_out, fej_out, phi, qd, last_w, B, W);
  return (int)cudaGetLastError();
}

// variant = 4·use_rk4 + 2·do_fej + imu_avg (imu_avg 0 under RK4, which does not read it).
template <typename T>
static int launch_variant(const T* imu, const T* fej, const T* t, const T* w, const T* a, const T* t0, const T* t1,
                          const T* noises, const T* gravity, T* imu_out, T* fej_out, T* phi, T* qd, T* last_w,
                          int B, int W, int variant, cudaStream_t stream) {
  if (B <= 0) return 0;
#define OVP_IMU_LAUNCH(R, F, A) \
  launch<T, R, F, A>(imu, fej, t, w, a, t0, t1, noises, gravity, imu_out, fej_out, phi, qd, last_w, B, W, stream)
  switch (variant) {
    case 0: return OVP_IMU_LAUNCH(false, false, false);
    case 1: return OVP_IMU_LAUNCH(false, false, true);
    case 2: return OVP_IMU_LAUNCH(false, true, false);
    case 3: return OVP_IMU_LAUNCH(false, true, true);
    case 4: return OVP_IMU_LAUNCH(true, false, false);
    case 6: return OVP_IMU_LAUNCH(true, true, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef OVP_IMU_LAUNCH
}

}  // namespace ovp_imu

// Pointers: imu, imu_fej [B, 16], imu_t [B, W], imu_w, imu_a [B, W, 3], t0,
// t1 [B], noises [4], gravity [3]; out: imu, imu_fej [B, 16], Φ, Qd
// [B, 15, 15], last_w [B, 3]. All contiguous, of one type, on the stream's device.
extern "C" {

int ovp_imu_propagate_f32(const float* imu, const float* fej, const float* t, const float* w, const float* a,
    const float* t0, const float* t1, const float* noises, const float* gravity, float* imu_out, float* fej_out,
    float* phi, float* qd, float* last_w, int B, int W, int variant, void* stream) {
  return ovp_imu::launch_variant<float>(imu, fej, t, w, a, t0, t1, noises, gravity, imu_out, fej_out, phi, qd,
                                        last_w, B, W, variant, (cudaStream_t)stream);
}

int ovp_imu_propagate_f64(const double* imu, const double* fej, const double* t, const double* w, const double* a,
    const double* t0, const double* t1, const double* noises, const double* gravity, double* imu_out,
    double* fej_out, double* phi, double* qd, double* last_w, int B, int W, int variant, void* stream) {
  return ovp_imu::launch_variant<double>(imu, fej, t, w, a, t0, t1, noises, gravity, imu_out, fej_out, phi, qd,
                                         last_w, B, W, variant, (cudaStream_t)stream);
}

}  // extern "C"
