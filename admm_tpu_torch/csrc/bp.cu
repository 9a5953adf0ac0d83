// Basis Pursuit, min ||x||_1 s.t. Ax = b: M signals against one A, FADMM
// with rho fixed, every lane to its own convergence.
//
// Replaces admm_tpu/ops/bp_kernel.py::_bp_batch_kernel
// (bp_batch_solve_pallas).
//
// One iteration of one lane (reference: src/ADMMBP.h:48-88,
// src/FADMMBase.h:219-265), with Winv = (AA')^-1 and the lane's cached
// aaab = A' Winv b:
//   v = adj_z - adj_y/rho
//   t = v A'        (1,p)x(p,n)
//   u = t Winv      (1,n)x(n,n)
//   x = v + aaab - u A                             (1,n)x(n,p)
//   z = soft(x + adj_y/rho, 1/rho),  r = x - z,  y = adj_y + rho r
//   Boyd test on ||r|| and rho ||z - z_old||, then momentum/restart.
//
// Design.  The wide path kernel's: lanes never interact (the Pallas
// kernel's all-done exit only stops lanes that are already frozen), so one
// thread block runs one lane with its own loop and the per-lane niter
// equals the Pallas kernel's; a single signal is simply a grid of one.
// Lane state lives in shared memory: the three products' left factors v
// (p), t and u (n each) as float64, and z, y, adj_z, adj_y, z_new, y_new
// (p each) as float32: 8p + 4n floats, 80 KB at n = 1000, p = 2000.  The
// first product gives each warp whole rows of A (a row dot product,
// reduced by shuffles); the other two give each thread whole columns (a
// warp reads 32 neighbouring columns of a row: coalesced).  Each product
// is rounded once to float32, as the TPU kernel's three float32 products
// are.  The norms of the pre-update x, z, y are carried as scalars, so one
// block reduction of six sums per iteration gives every norm.
//
// What bounds it on this card: two passes over A and one over Winv per
// iteration per lane, (2 n p + n^2) * 4 bytes (20 MB at 1000 x 2000) from
// L2, each element converted to float64 once (16 conversions per clock per
// SM).  A (8 MB) and Winv (4 MB) stay resident in the 50 MB L2.
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBpSums = 6;

__global__ void __launch_bounds__(kThreads)
bp_batch_kernel(const float* __restrict__ A, const float* __restrict__ winv,
                const float* __restrict__ aaab, float* __restrict__ z_out,
                int* __restrict__ niter_out, int n, int p, float rho,
                float eps_abs, float eps_rel, int maxit, float restart_tol) {
  extern __shared__ float smem[];
  __shared__ double red[(admm::kWarp + 1) * kBpSums];
  double* v64 = reinterpret_cast<double*>(smem);  // (p,) adj_z - adj_y/rho
  double* t64 = v64 + p;                          // (n,) v A'
  double* u64 = t64 + n;                          // (n,) t Winv
  float* z = smem + 2 * p + 4 * n;
  float* y = z + p;
  float* adj_z = y + p;
  float* adj_y = adj_z + p;
  float* zs = adj_y + p;  // z_new
  float* yn = zs + p;     // y_new
  for (int j = threadIdx.x; j < 8 * p + 4 * n; j += blockDim.x) smem[j] = 0.0f;
  __syncthreads();

  const int lane = blockIdx.x;
  const float* aaab_l = aaab + static_cast<size_t>(lane) * p;
  const float sqrt_p = sqrtf(static_cast<float>(p));
  const float pen = 1.0f / rho;
  const int warp = threadIdx.x / admm::kWarp;
  const int wlane = threadIdx.x % admm::kWarp;
  const int nwarps = blockDim.x / admm::kWarp;
  float nx2 = 0.0f, nz2 = 0.0f, ny2 = 0.0f;  // pre-update squared norms
  admm::Momentum mom;
  mom.a = 1.0f;
  mom.c = 9999.0f;

  int it = 0;
  while (it < maxit) {
    const float eps_pri =
        fmaxf(sqrtf(nx2), sqrtf(nz2)) * eps_rel + sqrt_p * eps_abs;
    const float eps_dua = sqrtf(ny2) * eps_rel + sqrt_p * eps_abs;

    for (int j = threadIdx.x; j < p; j += blockDim.x)
      v64[j] = static_cast<double>(adj_z[j] - adj_y[j] / rho);
    __syncthreads();

    // t = A v; warp w owns rows w, w + nwarps, ...
    for (int i = warp; i < n; i += nwarps) {
      const float* row = A + static_cast<size_t>(i) * p;
      double dot = 0.0;
      for (int j = wlane; j < p; j += admm::kWarp)
        dot = fma(static_cast<double>(__ldg(row + j)), v64[j], dot);
      const float acc = static_cast<float>(admm::warp_sum(dot));
      if (wlane == 0) t64[i] = static_cast<double>(acc);
    }
    __syncthreads();

    // u = t Winv; thread k owns column k.
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      u64[k] = static_cast<double>(admm::column_dot(t64, winv + k, n, n));
    __syncthreads();

    // x = v + aaab - u A (thread j owns column j of A), then z, r, y.
    double s[kBpSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
      const float corr = admm::column_dot(u64, A + j, n, p);
      const float xn = static_cast<float>(v64[j]) + aaab_l[j] - corr;
      const float ay = adj_y[j];
      const float zn = admm::soft_threshold(xn + ay / rho, pen);
      const float r = xn - zn;
      const float y_new = ay + rho * r;
      const float dz = zn - z[j];
      const float ez = zn - adj_z[j];
      s[0] += static_cast<double>(dz * dz);  // ||z_new - z||^2: dual residual
      s[1] += static_cast<double>(r * r);    // ||x_new - z_new||^2: primal
      s[2] += static_cast<double>(ez * ez);  // ||z_new - adj_z||^2: combined
      s[3] += static_cast<double>(xn * xn);  // next iteration's ||x||^2
      s[4] += static_cast<double>(zn * zn);  // next iteration's ||z||^2
      s[5] += static_cast<double>(y_new * y_new);  // next ||y||^2
      zs[j] = zn;
      yn[j] = y_new;
    }
    admm::block_sum<kBpSums>(s, red);

    const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
    const float r_pri = sqrtf(static_cast<float>(s[1]));
    const bool done = r_pri < eps_pri && r_dua < eps_dua;
    const admm::MomentumStep m = admm::fadmm_momentum(
        mom, rho, r_pri, static_cast<float>(s[2]), restart_tol);
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
      const float zn = zs[j];
      const float y_new = yn[j];
      if (!done) {
        adj_z[j] = m.accel ? (1.0f + m.ratio) * zn - m.ratio * z[j] : z[j];
        adj_y[j] = m.accel ? (1.0f + m.ratio) * y_new - m.ratio * y[j] : y[j];
      }
      z[j] = zn;
      y[j] = y_new;
    }
    if (!done) {
      mom.a = m.a_new;
      mom.c = m.c_new;
    }
    nx2 = static_cast<float>(s[3]);
    nz2 = static_cast<float>(s[4]);
    ny2 = static_cast<float>(s[5]);
    ++it;
    __syncthreads();
    if (done) break;
  }
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    z_out[static_cast<size_t>(lane) * p + j] = z[j];
  if (threadIdx.x == 0) niter_out[lane] = it;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int admm_bp_batch_solve(const float* A, const float* winv, const float* aaab,
                        float* z_out, int* niter_out, int n, int p, int m,
                        float rho, float eps_abs, float eps_rel, int maxit,
                        float restart_tol, void* stream) {
  const size_t smem = sizeof(float) * (8 * static_cast<size_t>(p) + 4 * n);
  if (n <= 0 || p <= 0 || m <= 0 || smem > admm::kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = admm::set_dynamic_smem(bp_batch_kernel, smem);
  if (err != cudaSuccess) return err;
  bp_batch_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, winv, aaab, z_out, niter_out, n, p, rho, eps_abs, eps_rel, maxit,
      restart_tol);
  return cudaGetLastError();
}

}  // extern "C"
