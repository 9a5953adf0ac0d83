// Tall Lasso/Elastic-Net lambda path (n > p): FADMM against a cached
// ridge inverse Minv = (X'X + rho I)^-1, two kernels.
//
// Replaces admm_tpu/ops/tall_path.py::_kernel (tall_path_batch_pallas,
// all lambdas at once from a cold start) and ::_scan_kernel
// (tall_path_scan_pallas, one lane warm-started in sequence over lambda).
//
// One iteration of one lane (reference: src/ADMMLassoTall.h:70-97,
// src/FADMMBase.h:219-265):
//   x  = (X'y - adj_y + rho adj_z) Minv           one (1,p)x(p,p) product
//   z  = enet_prox(x + adj_y/rho, lam/rho)
//   y  = adj_y + rho (x - z)
//   Boyd test on ||x - z|| and rho ||z - z_old||, then momentum/restart.
//
// Design.  The lambda lanes never interact: the Pallas kernel's all-done
// exit only stops lanes that are already frozen.  So the batch kernel
// runs one thread block per lane, each with its own `for (it < maxit &&
// !done)` loop, and gives the same per-lane niter with no grid-wide sync.
// The scan kernel is one block looping over lambda around the same
// iteration.  Lane state (z, y, adj_z, adj_y, two scratch rows, and the
// x-update's right-hand side as float64: 8p floats, 32 KB at p = 1000)
// lives in shared memory.  ||x||, ||z||, ||y|| of the pre-update iterates
// are carried as scalars from the previous iteration, so one block
// reduction of six sums per iteration gives every norm.  The whole loop
// runs on the device with no host sync.
//
// What bounds it on this card: the x-update reads all of Minv (p^2 * 4
// bytes, 4 MB at p = 1000) from L2 every iteration, k * p^2 * 4 bytes per
// iteration for the batch kernel (400 MB at k = 100), and converts each
// element to float64 once (16 conversions per clock per SM).  The scan
// kernel runs on one SM.  Sharing each Minv read among a group of lanes,
// or splitting Minv's columns across CTAs with a grid-wide sync per
// iteration, is later work.
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTallSums = 6;

// Shared-memory rows and carried scalars of one lane.
struct TallLane {
  double* rhs64;  // x-update right-hand side, float64 (exact copy)
  float* z;
  float* y;
  float* adj_z;
  float* adj_y;
  float* zs;   // z_new
  float* xn;   // x_new, then y_new
  float nx2, nz2, ny2;  // squared norms of the current x, z, y
  admm::Momentum mom;
};

struct TallParams {
  const float* minv;  // (p, p) row-major
  const float* xty;   // (p,)
  int p;
  float rho, eps_abs, eps_rel, alpha, restart_tol, sqrt_p;
};

// Dynamic shared memory: p doubles, then six rows of p floats.
__device__ void tall_lane_init(TallLane& L, float* smem, int p) {
  L.rhs64 = reinterpret_cast<double*>(smem);
  float* f = smem + 2 * p;
  L.z = f;
  L.y = f + p;
  L.adj_z = f + 2 * p;
  L.adj_y = f + 3 * p;
  L.zs = f + 4 * p;
  L.xn = f + 5 * p;
  for (int j = threadIdx.x; j < 8 * p; j += blockDim.x) smem[j] = 0.0f;
  L.nx2 = L.nz2 = L.ny2 = 0.0f;
  L.mom.a = 1.0f;
  L.mom.c = 9999.0f;
  __syncthreads();
}

// One FADMM iteration of one lane; returns the Boyd test's verdict.  The
// verdict comes from block-reduced values, so it is the same in every
// thread and the caller's loop stays uniform.
__device__ bool tall_iteration(const TallParams& P, TallLane& L, float lam,
                               double* red) {
  const int p = P.p;
  const float rho = P.rho;
  const float eps_pri =
      fmaxf(sqrtf(L.nx2), sqrtf(L.nz2)) * P.eps_rel + P.sqrt_p * P.eps_abs;
  const float eps_dua = sqrtf(L.ny2) * P.eps_rel + P.sqrt_p * P.eps_abs;

  for (int j = threadIdx.x; j < p; j += blockDim.x)
    L.rhs64[j] =
        static_cast<double>(P.xty[j] - L.adj_y[j] + rho * L.adj_z[j]);
  __syncthreads();

  // x_new[j] = sum_i rhs[i] Minv[i, j]: a warp reads 32 neighbouring
  // columns of one row, so each load of Minv is coalesced.
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    L.xn[j] = admm::column_dot(L.rhs64, P.minv + j, p, p);
  __syncthreads();

  const float pen = lam / rho;
  double s[kTallSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const float xn = L.xn[j];
    const float ay = L.adj_y[j];
    const float zn = admm::enet_prox(xn + ay / rho, pen, P.alpha);
    const float r = xn - zn;
    const float yn = ay + rho * r;
    const float dz = zn - L.z[j];
    const float ez = zn - L.adj_z[j];
    s[0] += static_cast<double>(dz * dz);  // ||z_new - z||^2: dual residual
    s[1] += static_cast<double>(r * r);    // ||x_new - z_new||^2: primal
    s[2] += static_cast<double>(ez * ez);  // ||z_new - adj_z||^2: combined
    s[3] += static_cast<double>(xn * xn);  // next iteration's ||x||^2
    s[4] += static_cast<double>(zn * zn);  // next iteration's ||z||^2
    s[5] += static_cast<double>(yn * yn);  // next iteration's ||y||^2
    L.zs[j] = zn;
    L.xn[j] = yn;
  }
  admm::block_sum<kTallSums>(s, red);

  const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
  const float r_pri = sqrtf(static_cast<float>(s[1]));
  const bool done = r_pri < eps_pri && r_dua < eps_dua;
  const admm::MomentumStep m = admm::fadmm_momentum(
      L.mom, rho, r_pri, static_cast<float>(s[2]), P.restart_tol);
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const float zn = L.zs[j];
    const float yn = L.xn[j];
    if (!done) {
      L.adj_z[j] = m.accel ? (1.0f + m.ratio) * zn - m.ratio * L.z[j]
                           : L.z[j];
      L.adj_y[j] = m.accel ? (1.0f + m.ratio) * yn - m.ratio * L.y[j]
                           : L.y[j];
    }
    L.z[j] = zn;
    L.y[j] = yn;
  }
  if (!done) {
    L.mom.a = m.a_new;
    L.mom.c = m.c_new;
  }
  L.nx2 = static_cast<float>(s[3]);
  L.nz2 = static_cast<float>(s[4]);
  L.ny2 = static_cast<float>(s[5]);
  __syncthreads();
  return done;
}

// Batch: block b solves lambda lane b from a cold start.
__global__ void __launch_bounds__(kThreads)
tall_path_batch_kernel(TallParams P, const float* __restrict__ lam,
                       float* __restrict__ z_out, int* __restrict__ niter_out,
                       int maxit) {
  extern __shared__ float smem[];
  __shared__ double red[(admm::kWarp + 1) * kTallSums];
  const int lane = blockIdx.x;
  TallLane L;
  tall_lane_init(L, smem, P.p);
  const float lam_l = lam[lane];
  int it = 0;
  while (it < maxit) {
    const bool done = tall_iteration(P, L, lam_l, red);
    ++it;
    if (done) break;
  }
  for (int j = threadIdx.x; j < P.p; j += blockDim.x)
    z_out[static_cast<size_t>(lane) * P.p + j] = L.z[j];
  if (threadIdx.x == 0) niter_out[lane] = it;
}

// Scan: one block, warm-started over lambda.  At each lambda the momentum
// is re-synchronised to the warm iterates (admm_tpu/core/engine.py::
// warm_start): adj_z = z, adj_y = y, a = 1, c = 9999.
__global__ void __launch_bounds__(kThreads)
tall_path_scan_kernel(TallParams P, const float* __restrict__ lam,
                      float* __restrict__ z_out, int* __restrict__ niter_out,
                      int k, int maxit) {
  extern __shared__ float smem[];
  __shared__ double red[(admm::kWarp + 1) * kTallSums];
  TallLane L;
  tall_lane_init(L, smem, P.p);
  for (int kk = 0; kk < k; ++kk) {
    for (int j = threadIdx.x; j < P.p; j += blockDim.x) {
      L.adj_z[j] = L.z[j];
      L.adj_y[j] = L.y[j];
    }
    L.mom.a = 1.0f;
    L.mom.c = 9999.0f;
    __syncthreads();
    const float lam_k = lam[kk];
    int it = 0;
    while (it < maxit) {
      const bool done = tall_iteration(P, L, lam_k, red);
      ++it;
      if (done) break;
    }
    for (int j = threadIdx.x; j < P.p; j += blockDim.x)
      z_out[static_cast<size_t>(kk) * P.p + j] = L.z[j];
    if (threadIdx.x == 0) niter_out[kk] = it;
  }
}

TallParams make_params(const float* minv, const float* xty, int p, float rho,
                       float eps_abs, float eps_rel, float alpha,
                       float restart_tol) {
  TallParams P;
  P.minv = minv;
  P.xty = xty;
  P.p = p;
  P.rho = rho;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.alpha = alpha;
  P.restart_tol = restart_tol;
  P.sqrt_p = sqrtf(static_cast<float>(p));
  return P;
}

}  // namespace

extern "C" {

// Every entry returns cudaGetLastError() after its launch (0 = launched).
int admm_tall_path_batch(const float* minv, const float* xty,
                         const float* lam, float* z_out, int* niter_out,
                         int p, int k, float rho, float eps_abs,
                         float eps_rel, float alpha, int maxit,
                         float restart_tol, void* stream) {
  const size_t smem = sizeof(float) * 8 * static_cast<size_t>(p);
  if (p <= 0 || k <= 0 || smem > admm::kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = admm::set_dynamic_smem(tall_path_batch_kernel, smem);
  if (err != cudaSuccess) return err;
  TallParams P =
      make_params(minv, xty, p, rho, eps_abs, eps_rel, alpha, restart_tol);
  tall_path_batch_kernel<<<k, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      P, lam, z_out, niter_out, maxit);
  return cudaGetLastError();
}

int admm_tall_path_scan(const float* minv, const float* xty, const float* lam,
                        float* z_out, int* niter_out, int p, int k, float rho,
                        float eps_abs, float eps_rel, float alpha, int maxit,
                        float restart_tol, void* stream) {
  const size_t smem = sizeof(float) * 8 * static_cast<size_t>(p);
  if (p <= 0 || k <= 0 || smem > admm::kMaxDynamicSmem)
    return cudaErrorInvalidValue;
  cudaError_t err = admm::set_dynamic_smem(tall_path_scan_kernel, smem);
  if (err != cudaSuccess) return err;
  TallParams P =
      make_params(minv, xty, p, rho, eps_abs, eps_rel, alpha, restart_tol);
  tall_path_scan_kernel<<<1, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      P, lam, z_out, niter_out, k, maxit);
  return cudaGetLastError();
}

const char* admm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
