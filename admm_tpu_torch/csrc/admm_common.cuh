// Device helpers shared by the path kernels: the proximal operators, the
// GLM families' gradients, the FADMM momentum/restart rule and a
// block-wide sum of a few scalars.
//
// Counterparts of admm_tpu/ops/_common.py (soft_threshold, enet_prox,
// fadmm_momentum), of the prox and family gradients inside
// admm_tpu/ops/glm_kernel.py, and of their plain PyTorch forms in
// admm_tpu_torch/kernels/_common.py.  Written once here so that the
// kernels cannot diverge.
//
// Arithmetic.  Elementwise work is IEEE float32, one rounding per
// operation in the order the plain forms write it (the build passes
// -fmad=false and no fast-math).  Products and squared norms accumulate in
// float64 and round once to float32, here and in the plain forms alike.
// The two then agree to the last bit nearly everywhere, so the Boyd test
// and the restart test, which compare residuals near a threshold, decide
// the same way in both: with float32 sums in different orders they do not,
// and niter and the stopping points drift apart.
#pragma once

#include <cuda_runtime.h>

namespace admm {

// sign(v) * max(|v| - pen, 0)
__device__ __forceinline__ float soft_threshold(float v, float pen) {
  const float m = fmaxf(fabsf(v) - pen, 0.0f);
  return v > 0.0f ? m : (v < 0.0f ? -m : 0.0f);
}

// Elastic-net prox (reference: src/ADMMEnet.h:24-40); alpha = 1 is the
// soft-threshold.
__device__ __forceinline__ float enet_prox(float v, float pen, float alpha) {
  // (1 - alpha) in float32 from the float32 alpha, as the plain forms do.
  const float denom = 1.0f + pen * (1.0f - alpha);
  return soft_threshold(v, alpha * pen) / denom;
}

// Elastic-net prox with a per-coordinate penalty lam/rho * mask (mask 0 on
// the unpenalized intercept).
__device__ __forceinline__ float masked_enet_prox(float v, float lam_over_rho,
                                                  float mask, float alpha) {
  return enet_prox(v, lam_over_rho * mask, alpha);
}

// dloss/deta of the logistic loss, sigmoid(eta) - y, with the sigmoid as
// torch.sigmoid computes it in float32: 1 / (1 + expf(-eta)).  At
// eta << 0 expf overflows to inf and the quotient is 0, which is right.
__device__ __forceinline__ float binomial_grad_eta(float eta, float y) {
  return 1.0f / (1.0f + expf(-eta)) - y;
}

// dloss/deta of the Huber loss in r = y - eta: -clip(r, -M, M).
__device__ __forceinline__ float huber_grad_eta(float eta, float y, float M) {
  return -fminf(fmaxf(y - eta, -M), M);
}

// The scalar half of one FADMM momentum/restart step (reference:
// src/FADMMBase.h:240-256).  The caller applies the vector half,
//   adj_z = accel ? (1 + ratio) z_new - ratio z_old : z_old
// (and the same for y), and skips both halves on the converging
// iteration: the reference breaks out before accelerating.
struct Momentum {
  float a;  // Nesterov coefficient adj_a
  float c;  // combined residual adj_c
};

struct MomentumStep {
  bool accel;
  float ratio;
  float a_new;
  float c_new;
};

__device__ __forceinline__ MomentumStep fadmm_momentum(
    const Momentum& m, float rho, float r_pri, float extra_sq,
    float restart_tol) {
  MomentumStep s;
  const float c_new = rho * r_pri * r_pri + rho * extra_sq;
  s.accel = c_new < restart_tol * m.c;
  const float a_acc = 0.5f + 0.5f * sqrtf(1.0f + 4.0f * m.a * m.a);
  s.ratio = (m.a - 1.0f) / a_acc;
  s.a_new = s.accel ? a_acc : 1.0f;
  s.c_new = s.accel ? c_new : m.c / restart_tol;
  return s;
}

constexpr int kWarp = 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum N per-thread values over the block; every thread gets the totals.
// blockDim.x must be a multiple of 32.  `scratch` holds 33 * N doubles.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* scratch) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[warp * N + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      double s = lane < nwarps ? scratch[lane * N + k] : 0.0;
      s = warp_sum(s);
      if (lane == 0) scratch[kWarp * N + k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = scratch[kWarp * N + k];
  // The next call writes only rows [0, 32) before its first barrier,
  // and every thread has read the totals here before reaching it.
}

// sum_i v[i] * col[i * stride], rounded once to float32, for a float64
// vector v in shared memory (converted once per iteration by the caller)
// and one column of a row-major float32 matrix in global memory, read
// through L2.  The products are exact in float64; eight independent
// partial sums keep several loads in flight.  The one float32 -> float64
// conversion per matrix element is what bounds the loop (16 per clock per
// SM on sm_90), not the float64 FMAs.
__device__ __forceinline__ float column_dot(const double* v, const float* col,
                                            int n, int stride) {
  double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  int i = 0;
  for (; i + 8 <= n; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc[u] = fma(v[i + u],
                   static_cast<double>(
                       __ldg(col + static_cast<size_t>(i + u) * stride)),
                   acc[u]);
  }
  for (; i < n; ++i)
    acc[0] = fma(v[i],
                 static_cast<double>(
                     __ldg(col + static_cast<size_t>(i) * stride)),
                 acc[0]);
  return static_cast<float>(((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                            ((acc[4] + acc[5]) + (acc[6] + acc[7])));
}

// sum_i row[i] * v[i] over one warp's lanes (the caller reduces the lanes
// with warp_sum), for one row of a row-major float32 matrix in global
// memory and a float64 vector in shared memory; exact products accumulated
// in float64.  16-byte loads where the row starts on a 16-byte boundary and
// holds a multiple of four elements.
__device__ __forceinline__ double row_dot(const float* row, const double* v,
                                          int n, int wlane) {
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  if ((n & 3) == 0 && (reinterpret_cast<size_t>(row) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
    for (int i = wlane; i < n / 4; i += kWarp) {
      const float4 h = __ldg(row4 + i);
      const double* vv = v + 4 * i;
      a0 = fma(static_cast<double>(h.x), vv[0], a0);
      a1 = fma(static_cast<double>(h.y), vv[1], a1);
      a2 = fma(static_cast<double>(h.z), vv[2], a2);
      a3 = fma(static_cast<double>(h.w), vv[3], a3);
    }
  } else {
#pragma unroll 4
    for (int i = wlane; i < n; i += kWarp)
      a0 = fma(static_cast<double>(__ldg(row + i)), v[i], a0);
  }
  return (a0 + a1) + (a2 + a3);
}

// Largest dynamic shared memory a block may ask for on sm_90, keeping 2 KB
// for the static reduction scratch.
constexpr int kMaxDynamicSmem = 232448 - 2048;

template <typename Kernel>
inline cudaError_t set_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace admm
