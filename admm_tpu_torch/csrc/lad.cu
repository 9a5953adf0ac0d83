// LAD (median regression): one whole FADMM solve against the dense hat
// matrix H = Xa (Xa'Xa)^-1 Xa', rho fixed.
//
// Replaces admm_tpu/ops/lad_kernel.py::_lad_pallas_kernel
// (lad_solve_pallas).
//
// One iteration (reference: src/ADMMLAD.h:57-98, src/FADMMBase.h:219-265):
//   x  = H (ys - adj_y/rho + adj_z)                one (n,n)x(n,1) product
//   z  = soft(x - ys + adj_y/rho, 1/rho)
//   r  = x - ys - z,   y = adj_y + rho r
//   Boyd test on ||r|| and rho ||z - z_old||, with ||ys|| in the primal
//   scale, then momentum/restart; adj_* are held on the converging step
//   and returned for the caller's recovery solve.
// H is symmetric, so the product is taken as row dot products, which read
// H along its contiguous axis; the plain form does the same.
//
// Design.  There is one lane, and one thread block reading all of H every
// iteration is bound by the bytes a single SM keeps in flight: a
// one-block version of this kernel (thread j owning column j, as in the
// tall scan kernel) took 99 us per iteration at n = 1000 and 5.5 ms at
// n = 5000, where H (100 MB) is past the 50 MB L2 (H100 SXM, 700 W).  So
// the rows of H are split over a cooperative grid, up to one block per SM
// and more where shared memory allows, with ONE grid-wide sync per
// iteration:
//   1. every block holds its own full copy of the iterates (z, y, adj_z,
//      adj_y as float32 and the product's right factor as float64: 6n
//      floats of shared memory), all copies identical;
//   2. each warp takes whole rows: a dot product with 16-byte loads,
//      reduced by shuffles; lane 0 then updates that element and writes
//      z_new and y_new to a global buffer and six partial sums of squares
//      go, per block, to another;
//   3. grid sync; every block adds the partial sums in the same order,
//      takes the same stopping and restart decisions, and brings its copy
//      of the iterates up to date from the global buffer.
// The global buffers are double-buffered on the iteration's parity: a
// block that runs ahead writes iteration t+1's values while a slower one
// still reads iteration t's, and cannot get further before the next sync.
// The redundant elementwise work is n per block against n^2 / blocks in
// the product.  The loop never leaves the device.
//
// What bounds it on this card: reading H once per iteration, n^2 * 4
// bytes, from L2 (n = 1000: 4 MB) or device memory (n = 5000: 100 MB,
// 30 us at 3.35 TB/s), one float32 -> float64 conversion per element (16
// per clock per SM), and the grid sync's latency, which dominates at
// n = 1000.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // also the largest grid: see the totals below
constexpr int kLadSums = 6;

struct LadParams {
  const float* hat;  // (n, n) row-major
  const float* ys;   // (n,)
  float* znew;       // (2, n) z_new by iteration parity
  float* ynew;       // (2, n) y_new by iteration parity
  double* partial;   // (2, kThreads, kLadSums) per-block sums by parity
  float* adjy_out;
  float* adjz_out;
  int* niter_out;
  int n;
  float rho, eps_abs, eps_rel, ynorm, restart_tol;
  int maxit;
};

__global__ void __launch_bounds__(kThreads) lad_solve_kernel(LadParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ double red[(admm::kWarp + 1) * kLadSums];
  const int n = P.n;
  const float rho = P.rho;
  double* v64 = reinterpret_cast<double*>(smem);  // (n,) ys - adj_y/rho + adj_z
  float* z = smem + 2 * n;
  float* y = z + n;
  float* adj_z = y + n;
  float* adj_y = adj_z + n;
  for (int j = threadIdx.x; j < 6 * n; j += blockDim.x) smem[j] = 0.0f;
  __syncthreads();

  const int wlane = threadIdx.x % admm::kWarp;
  const int nwarps = blockDim.x / admm::kWarp;
  const int gwarp = blockIdx.x * nwarps + threadIdx.x / admm::kWarp;
  const int gwarps = gridDim.x * nwarps;
  const float sqrt_n = sqrtf(static_cast<float>(n));
  const float pen = 1.0f / rho;
  float nx2 = 0.0f, nz2 = 0.0f, ny2 = 0.0f;  // pre-update squared norms
  admm::Momentum mom;
  mom.a = 1.0f;
  mom.c = 9999.0f;

  int it = 0;
  while (it < P.maxit) {
    const float eps_pri =
        fmaxf(fmaxf(sqrtf(nx2), sqrtf(nz2)), P.ynorm) * P.eps_rel +
        sqrt_n * P.eps_abs;
    const float eps_dua = sqrtf(ny2) * P.eps_rel + sqrt_n * P.eps_abs;
    float* znew = P.znew + static_cast<size_t>(it & 1) * n;
    float* ynew = P.ynew + static_cast<size_t>(it & 1) * n;
    double* partial = P.partial + (it & 1) * kThreads * kLadSums;

    for (int j = threadIdx.x; j < n; j += blockDim.x)
      v64[j] = static_cast<double>(P.ys[j] - adj_y[j] / rho + adj_z[j]);
    __syncthreads();

    // This warp's rows: x_new[j] = sum_i H[j, i] v[i], then element j.
    double s[kLadSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int j = gwarp; j < n; j += gwarps) {
      const double dot = admm::warp_sum(
          admm::row_dot(P.hat + static_cast<size_t>(j) * n, v64, n, wlane));
      if (wlane == 0) {
        const float xn = static_cast<float>(dot);
        const float ay = adj_y[j];
        const float d = xn - P.ys[j];
        const float zn = admm::soft_threshold(d + ay / rho, pen);
        const float r = d - zn;
        const float y_new = ay + rho * r;
        const float dz = zn - z[j];
        const float ez = zn - adj_z[j];
        s[0] += static_cast<double>(dz * dz);  // ||z_new - z||^2: dual
        s[1] += static_cast<double>(r * r);    // ||x - ys - z_new||^2: primal
        s[2] += static_cast<double>(ez * ez);  // ||z_new - adj_z||^2: combined
        s[3] += static_cast<double>(xn * xn);  // next iteration's ||x||^2
        s[4] += static_cast<double>(zn * zn);  // next iteration's ||z||^2
        s[5] += static_cast<double>(y_new * y_new);  // next ||y||^2
        znew[j] = zn;
        ynew[j] = y_new;
      }
    }
    admm::block_sum<kLadSums>(s, red);
#pragma unroll
    for (int k = 0; k < kLadSums; ++k)
      if (threadIdx.x == k) partial[blockIdx.x * kLadSums + k] = s[k];
    grid.sync();

    // Thread b takes block b's sums (the grid is at most kThreads blocks):
    // every block adds them in the same order and decides alike.
#pragma unroll
    for (int k = 0; k < kLadSums; ++k)
      s[k] = threadIdx.x < gridDim.x
                 ? __ldcg(partial + threadIdx.x * kLadSums + k)
                 : 0.0;
    admm::block_sum<kLadSums>(s, red);

    const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
    const float r_pri = sqrtf(static_cast<float>(s[1]));
    const bool done = r_pri < eps_pri && r_dua < eps_dua;
    const admm::MomentumStep m = admm::fadmm_momentum(
        mom, rho, r_pri, static_cast<float>(s[2]), P.restart_tol);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      // Written by other blocks: read through L2, not this SM's L1.
      const float zn = __ldcg(znew + j);
      const float y_new = __ldcg(ynew + j);
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
  if (blockIdx.x == 0) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      P.adjy_out[j] = adj_y[j];
      P.adjz_out[j] = adj_z[j];
    }
    if (threadIdx.x == 0) P.niter_out[0] = it;
  }
}

}  // namespace

extern "C" {

// The largest grid admm_lad_solve launches: the caller sizes `partial`,
// (2, admm_lad_max_grid(), 6) doubles, by it.
int admm_lad_max_grid() { return kThreads; }

// Returns the launch's error (0 = launched).  `znew` and `ynew` are (2, n)
// floats of scratch, `partial` as above; none needs initialising.
int admm_lad_solve(const float* hat, const float* ys, float* znew,
                   float* ynew, double* partial, float* adjy_out,
                   float* adjz_out, int* niter_out, int n, float rho,
                   float eps_abs, float eps_rel, float ynorm, int maxit,
                   float restart_tol, void* stream) {
  const size_t smem = sizeof(float) * 6 * static_cast<size_t>(n);
  if (n <= 0 || smem > admm::kMaxDynamicSmem) return cudaErrorInvalidValue;
  cudaError_t err = admm::set_dynamic_smem(lad_solve_kernel, smem);
  if (err != cudaSuccess) return err;
  // As many blocks as can be resident at once (a grid sync needs them all
  // running), no more than one warp per row needs, at most kThreads.
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lad_solve_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  const int warps = kThreads / admm::kWarp;
  int blocks = per_sm * sms;
  if (blocks > kThreads) blocks = kThreads;
  if (blocks > (n + warps - 1) / warps) blocks = (n + warps - 1) / warps;
  if (blocks < 1) return cudaErrorInvalidConfiguration;

  LadParams P;
  P.hat = hat;
  P.ys = ys;
  P.znew = znew;
  P.ynew = ynew;
  P.partial = partial;
  P.adjy_out = adjy_out;
  P.adjz_out = adjz_out;
  P.niter_out = niter_out;
  P.n = n;
  P.rho = rho;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.ynorm = ynorm;
  P.restart_tol = restart_tol;
  P.maxit = maxit;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(lad_solve_kernel), dim3(blocks), dim3(kThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
