// Penalized GLM lambda path with the fixed majorizer: plain ADMM on
// b - z = 0, all lambdas at once, for the binomial (logistic) and Huber
// losses.
//
// Replaces admm_tpu/ops/glm_kernel.py::_glm_kernel (glm_batch_path_pallas).
//
// One iteration of one lane, with B = x and v = z - y/rho:
//   eps_pri = max(||x||, ||z||) eps_rel + sqrt(q) eps_abs
//   eps_dua = ||y|| eps_rel + sqrt(q) eps_abs          (pre-update iterates)
//   newton_steps times, the majorize-minimize step of the x-update:
//     U    = Xa B                                   (n,q)x(q,)
//     G    = sigmoid(U) - ys  (binomial)  or  -clip(ys - U, -M, M)  (huber)
//     grad = Xa' G / n + rho (B - v)                (q,n)x(n,)
//     B    = B - Minv grad                          (q,q)x(q,)
//   z = soft(B + y/rho, alpha pen) / (1 + pen (1 - alpha)),
//       pen = lam/rho * mask (mask 0 on the intercept)
//   r_dua = rho ||z - z_old||,  r_pri = ||B - z||,  y = y + rho (B - z)
//   done when r_pri < eps_pri and r_dua < eps_dua.
// Cold start, no momentum, rho fixed.  Minv = (bound Xa'Xa/n + rho I)^-1 is
// symmetric, so the third product is taken as row dot products, which read
// Minv along its contiguous axis; the plain form does the same.
//
// Design.  Lanes never interact, so each thread block runs one lane to its
// own convergence, and the per-lane niter equals the Pallas kernel's.  Lane
// state lives in shared memory: x, z and y (q each, float32) and the three
// products' vector factors as float64 (B and grad, q each; G, n), 7q + 2n
// floats: 108 KB at n = 10000, q = 1001.  The first and third products give
// each warp whole rows (a row dot product, reduced by shuffles; lane 0 then
// applies the family gradient or the step); the second gives each thread
// whole columns of Xa (a warp reads 32 neighbouring columns of a row:
// coalesced).  The norms of the pre-update x, z and y are carried from the
// previous iteration, so one block reduction of five sums per iteration
// gives every norm.
//
// What bounds it on this card: 2 newton_steps passes over Xa and
// newton_steps over Minv per lane-iteration (6.7 MB at 2000 x 201, 168 MB
// at 10000 x 1001 with two steps), read from L2 by one SM per lane, each
// element converted to float64 once per pass.  With 30 lambdas 30 of the
// 132 SMs work.
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kGlmSums = 5;
constexpr int kBinomial = 0;
constexpr int kHuber = 1;

struct GlmParams {
  const float* Xa;    // (n, q) row-major, the ones column included
  const float* Minv;  // (q, q) symmetric majorizer inverse
  const float* ys;    // (n,)
  const float* mask;  // (q,) penalty mask
  int n, q;
  float rho, eps_abs, eps_rel, alpha, huber_m;
  int maxit, newton_steps;
};

__host__ __device__ constexpr size_t glm_smem_floats(int n, int q) {
  return 7 * static_cast<size_t>(q) + 2 * static_cast<size_t>(n);
}

template <int kFamily>
__global__ void __launch_bounds__(kThreads)
glm_batch_path_kernel(GlmParams P, const float* __restrict__ lam,
                      float* __restrict__ z_out, int* __restrict__ niter_out) {
  extern __shared__ float smem[];
  __shared__ double red[(admm::kWarp + 1) * kGlmSums];
  const int n = P.n, q = P.q;
  const float rho = P.rho;
  double* g64 = reinterpret_cast<double*>(smem);  // (n,) family gradient G
  double* b64 = g64 + n;                           // (q,) B, float64 copy
  double* grad64 = b64 + q;                        // (q,) grad
  float* x = smem + 2 * (n + 2 * q);               // (q,) B, the x iterate
  float* z = x + q;                                // (q,)
  float* y = z + q;                                // (q,)
  for (size_t j = threadIdx.x; j < glm_smem_floats(n, q); j += blockDim.x)
    smem[j] = 0.0f;
  __syncthreads();

  const int lane = blockIdx.x;
  const float lam_over_rho = lam[lane] / rho;
  const float n_f = static_cast<float>(n);
  const float sqrt_q = sqrtf(static_cast<float>(q));
  const int warp = threadIdx.x / admm::kWarp;
  const int wlane = threadIdx.x % admm::kWarp;
  const int nwarps = blockDim.x / admm::kWarp;
  float nx2 = 0.0f, nz2 = 0.0f, ny2 = 0.0f;  // pre-update squared norms

  int it = 0;
  while (it < P.maxit) {
    const float eps_pri =
        fmaxf(sqrtf(nx2), sqrtf(nz2)) * P.eps_rel + sqrt_q * P.eps_abs;
    const float eps_dua = sqrtf(ny2) * P.eps_rel + sqrt_q * P.eps_abs;

    for (int step = 0; step < P.newton_steps; ++step) {
      for (int j = threadIdx.x; j < q; j += blockDim.x)
        b64[j] = static_cast<double>(x[j]);
      __syncthreads();

      // U = Xa B and the family gradient; warp w owns rows w, w + nwarps, ...
      for (int i = warp; i < n; i += nwarps) {
        const double dot = admm::warp_sum(admm::row_dot(
            P.Xa + static_cast<size_t>(i) * q, b64, q, wlane));
        if (wlane == 0) {
          const float u = static_cast<float>(dot);
          const float g = kFamily == kBinomial
                              ? admm::binomial_grad_eta(u, P.ys[i])
                              : admm::huber_grad_eta(u, P.ys[i], P.huber_m);
          g64[i] = static_cast<double>(g);
        }
      }
      __syncthreads();

      // grad = Xa' G / n + rho (B - v); thread j owns column j of Xa.
      for (int j = threadIdx.x; j < q; j += blockDim.x) {
        const float acc = admm::column_dot(g64, P.Xa + j, n, q);
        const float v = z[j] - y[j] / rho;
        const float grad = acc / n_f + rho * (x[j] - v);
        grad64[j] = static_cast<double>(grad);
      }
      __syncthreads();

      // B = B - Minv grad; warp w owns rows w, w + nwarps, ... of Minv.
      for (int j = warp; j < q; j += nwarps) {
        const double dot = admm::warp_sum(admm::row_dot(
            P.Minv + static_cast<size_t>(j) * q, grad64, q, wlane));
        if (wlane == 0) x[j] = x[j] - static_cast<float>(dot);
      }
      __syncthreads();
    }

    // Masked elastic-net prox, dual ascent and the five sums of squares.
    double s[kGlmSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
    for (int j = threadIdx.x; j < q; j += blockDim.x) {
      const float xn = x[j];
      const float zn = admm::masked_enet_prox(xn + y[j] / rho, lam_over_rho,
                                              P.mask[j], P.alpha);
      const float dz = zn - z[j];
      const float r = xn - zn;
      const float yn = y[j] + rho * r;
      s[0] += static_cast<double>(dz * dz);  // ||z_new - z||^2: dual
      s[1] += static_cast<double>(r * r);    // ||B - z_new||^2: primal
      s[2] += static_cast<double>(xn * xn);  // next ||x||^2
      s[3] += static_cast<double>(zn * zn);  // next ||z||^2
      s[4] += static_cast<double>(yn * yn);  // next ||y||^2
      z[j] = zn;
      y[j] = yn;
    }
    admm::block_sum<kGlmSums>(s, red);

    const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
    const float r_pri = sqrtf(static_cast<float>(s[1]));
    const bool done = r_pri < eps_pri && r_dua < eps_dua;
    nx2 = static_cast<float>(s[2]);
    nz2 = static_cast<float>(s[3]);
    ny2 = static_cast<float>(s[4]);
    ++it;
    __syncthreads();
    if (done) break;
  }
  for (int j = threadIdx.x; j < q; j += blockDim.x)
    z_out[static_cast<size_t>(lane) * q + j] = z[j];
  if (threadIdx.x == 0) niter_out[lane] = it;
}

template <int kFamily>
cudaError_t launch_glm(const GlmParams& P, const float* lam, float* z_out,
                       int* niter_out, int k, size_t smem,
                       cudaStream_t stream) {
  cudaError_t err =
      admm::set_dynamic_smem(glm_batch_path_kernel<kFamily>, smem);
  if (err != cudaSuccess) return err;
  glm_batch_path_kernel<kFamily><<<k, kThreads, smem, stream>>>(
      P, lam, z_out, niter_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// family: 0 = binomial, 1 = huber (huber_m is its M, unused for binomial).
// Returns cudaGetLastError() after the launch (0 = launched).
int admm_glm_batch_path(const float* Xa, const float* Minv, const float* ys,
                        const float* mask, const float* lam, float* z_out,
                        int* niter_out, int n, int q, int k, float rho,
                        float eps_abs, float eps_rel, float alpha, int maxit,
                        int family, float huber_m, int newton_steps,
                        void* stream) {
  const size_t smem = sizeof(float) * glm_smem_floats(n, q);
  if (n <= 0 || q <= 0 || k <= 0 || newton_steps <= 0 ||
      (family != kBinomial && family != kHuber) ||
      smem > admm::kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  GlmParams P;
  P.Xa = Xa;
  P.Minv = Minv;
  P.ys = ys;
  P.mask = mask;
  P.n = n;
  P.q = q;
  P.rho = rho;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.alpha = alpha;
  P.huber_m = huber_m;
  P.maxit = maxit;
  P.newton_steps = newton_steps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return family == kBinomial
             ? launch_glm<kBinomial>(P, lam, z_out, niter_out, k, smem, s)
             : launch_glm<kHuber>(P, lam, z_out, niter_out, k, smem, s);
}

}  // extern "C"
