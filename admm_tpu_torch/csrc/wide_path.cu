// Wide Lasso/Elastic-Net lambda path (p >= n): linearized ADMM with a
// per-lane adaptive rho, all lambdas at once.
//
// Replaces admm_tpu/ops/wide_path.py::_wide_kernel (wide_path_batch_pallas).
//
// One iteration of one lane (reference: src/ADMMLassoWide.h:13-25,
// :129-165; adaptive ladder src/ADMMBase.h:85-109):
//   grad = (Ax + z + y/rho) X                      (1,n)x(n,p)
//   x    = enet_prox(x - grad/sprad, lam/(rho sprad)), or 0 when
//          lam > lambda0 (1 - 1e-5) (the all-zero exit)
//   Ax   = x X'                                    (1,p)x(p,n)
//   z    = -(ys + y + rho Ax) / (1 + rho)
//   y    = y + rho (Ax + z)
//   Boyd test, then the rho ladder (x2 / :2 at a 10x imbalance, then a 1.2
//   nudge), held while it <= rho_start_iter and on the converging step.
//
// Design.  Lanes never interact, so each thread block runs one lane to its
// own convergence, with its own rho, and the per-lane niter equals the
// Pallas kernel's.  Lane state lives in shared memory: the gradient's left
// factor (n) and x (p) as float64 copies for the products, and x (p), z,
// y and Ax (n each) as float32; 3p + 5n floats, 44 KB at n = 1000,
// p = 2000.  The first product gives each thread whole columns of X (a warp
// reads 32 neighbouring columns of a row: coalesced); the second gives each
// warp whole rows (a row dot product, reduced by shuffles).  The norms of
// the pre-update Ax, z and y are carried from the previous iteration, so
// one block reduction of five sums per iteration gives every norm.
//
// What bounds it on this card: two passes over X per iteration, 2 n p * 4
// bytes (16 MB at 1000 x 2000) from L2 per lane per iteration, each element
// converted to float64 once per pass (16 conversions per clock per SM).
// X (8 MB) stays resident in the 50 MB L2.
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWideSums = 5;

struct WideParams {
  const float* X;   // (n, p) row-major
  const float* ys;  // (n,)
  int n, p;
  float sprad, lambda0, eps_abs, eps_rel, alpha;
  int maxit, rho_start_iter;
};

__global__ void __launch_bounds__(kThreads)
wide_path_batch_kernel(WideParams P, const float* __restrict__ lam,
                       const float* __restrict__ rho0,
                       float* __restrict__ x_out, int* __restrict__ niter_out) {
  extern __shared__ float smem[];
  __shared__ double red[(admm::kWarp + 1) * kWideSums];
  const int n = P.n, p = P.p;
  double* tmp64 = reinterpret_cast<double*>(smem);  // (n,) Ax + z + y/rho
  double* x64 = tmp64 + n;                           // (p,) x, float64 copy
  float* x = smem + 2 * (n + p);                     // (p,) primal iterate
  float* z = x + p;                                  // (n,)
  float* y = z + n;                                  // (n,)
  float* ax = y + n;                                 // (n,) cached A x
  for (int j = threadIdx.x; j < 3 * p + 5 * n; j += blockDim.x)
    smem[j] = 0.0f;
  __syncthreads();

  const int lane = blockIdx.x;
  const float lam_l = lam[lane];
  float rho = rho0[lane];
  const float sqrt_n = sqrtf(static_cast<float>(n));
  const float sqrt_p = sqrtf(static_cast<float>(p));
  const float sqrt_sprad = sqrtf(P.sprad);
  // float32(1 - 1e-5), the factor the plain form multiplies by.
  const bool zero_exit = lam_l > P.lambda0 * 0.99999f;
  const int warp = threadIdx.x / admm::kWarp;
  const int wlane = threadIdx.x % admm::kWarp;
  const int nwarps = blockDim.x / admm::kWarp;
  float nax2 = 0.0f, nz2 = 0.0f, ny2 = 0.0f;  // pre-update squared norms

  int it = 0;
  while (it < P.maxit) {
    const float eps_pri =
        fmaxf(sqrtf(nax2), sqrtf(nz2)) * P.eps_rel + sqrt_n * P.eps_abs;
    const float eps_dua =
        sqrt_sprad * sqrtf(ny2) * P.eps_rel + sqrt_p * P.eps_abs;

    for (int i = threadIdx.x; i < n; i += blockDim.x)
      tmp64[i] = static_cast<double>(ax[i] + z[i] + y[i] / rho);
    __syncthreads();

    // Linearized x-update; thread j owns column j of X.
    const float pen = lam_l / (rho * P.sprad);
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
      const float g = admm::column_dot(tmp64, P.X + j, n, p);
      const float v = x[j] - g / P.sprad;
      x[j] = zero_exit ? 0.0f : admm::enet_prox(v, pen, P.alpha);
      x64[j] = static_cast<double>(x[j]);
    }
    __syncthreads();

    // Ax = X x and the z/y updates; warp w owns rows w, w + nwarps, ...
    double s[kWideSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
    for (int i = warp; i < n; i += nwarps) {
      const float* row = P.X + static_cast<size_t>(i) * p;
      double dot = 0.0;
      for (int j = wlane; j < p; j += admm::kWarp)
        dot = fma(static_cast<double>(__ldg(row + j)), x64[j], dot);
      const float acc = static_cast<float>(admm::warp_sum(dot));
      if (wlane == 0) {
        const float zn = -(P.ys[i] + y[i] + rho * acc) / (1.0f + rho);
        const float r = acc + zn;
        const float yn = y[i] + rho * r;
        const float dz = zn - z[i];
        s[0] += static_cast<double>(dz * dz);    // ||z_new - z||^2: dual
        s[1] += static_cast<double>(r * r);      // ||Ax + z_new||^2: primal
        s[2] += static_cast<double>(acc * acc);  // next ||Ax||^2
        s[3] += static_cast<double>(zn * zn);    // next ||z||^2
        s[4] += static_cast<double>(yn * yn);    // next ||y||^2
        ax[i] = acc;
        z[i] = zn;
        y[i] = yn;
      }
    }
    admm::block_sum<kWideSums>(s, red);

    const float r_dua = rho * sqrt_sprad * sqrtf(static_cast<float>(s[0]));
    const float r_pri = sqrtf(static_cast<float>(s[1]));
    const bool done = r_pri < eps_pri && r_dua < eps_dua;
    const float ratio_p = r_pri / eps_pri;
    const float ratio_d = r_dua / eps_dua;
    float rho_a = ratio_p > 10.0f * ratio_d ? rho * 2.0f : rho;
    rho_a = ratio_d > 10.0f * ratio_p ? rho_a * 0.5f : rho_a;
    rho_a = r_pri < eps_pri ? rho_a / 1.2f : rho_a;
    rho_a = r_dua < eps_dua ? rho_a * 1.2f : rho_a;
    if (!(done || it <= P.rho_start_iter)) rho = rho_a;
    nax2 = static_cast<float>(s[2]);
    nz2 = static_cast<float>(s[3]);
    ny2 = static_cast<float>(s[4]);
    ++it;
    __syncthreads();
    if (done) break;
  }
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    x_out[static_cast<size_t>(lane) * p + j] = x[j];
  if (threadIdx.x == 0) niter_out[lane] = it;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int admm_wide_path_batch(const float* X, const float* ys, const float* lam,
                         const float* rho, float* x_out, int* niter_out,
                         int n, int p, int k, float sprad, float lambda0,
                         float eps_abs, float eps_rel, float alpha, int maxit,
                         int rho_start_iter, void* stream) {
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(p) + 5 * n);
  if (n <= 0 || p <= 0 || k <= 0 || smem > admm::kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = admm::set_dynamic_smem(wide_path_batch_kernel, smem);
  if (err != cudaSuccess) return err;
  WideParams P;
  P.X = X;
  P.ys = ys;
  P.n = n;
  P.p = p;
  P.sprad = sprad;
  P.lambda0 = lambda0;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.alpha = alpha;
  P.maxit = maxit;
  P.rho_start_iter = rho_start_iter;
  wide_path_batch_kernel<<<k, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      P, lam, rho, x_out, niter_out);
  return cudaGetLastError();
}

}  // extern "C"
