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
// ||x||, ||z||, ||y|| of the pre-update iterates are carried as scalars
// from the previous iteration, so six sums of squares per iteration give
// every norm.  The whole loop runs on the device with no host sync.
//
// Batch kernel.  The lambda lanes never interact: the Pallas kernel's
// all-done exit only stops lanes that are already frozen.  So one thread
// block runs one lane, each with its own `for (it < maxit && !done)` loop,
// and gives the same per-lane niter with no grid-wide sync.  Lane state
// (z, y, adj_z, adj_y, two scratch rows, and the x-update's right-hand
// side as float64: 8p floats, 32 KB at p = 1000) lives in shared memory.
// It reads all of Minv (4 MB at p = 1000) from L2 per lane and iteration
// and converts each element to float64 once (16 conversions per clock per
// SM); sharing each Minv read among a group of lanes is later work.
//
// Scan kernel.  There is one lane, and one block reading all of Minv every
// iteration is bound by the bytes one SM keeps in flight (77 us per
// iteration at p = 1000; NVIDIA H100 80GB HBM3, 700 W).  So the scan is
// one persistent cooperative grid, up to one block per SM, with ONE
// grid-wide sync per iteration, as in lad.cu:
//   1. every block holds its own full copy of z, y, adj_z, adj_y, X'y
//      (float32) and the product's right-hand side (float64) in shared
//      memory, all copies identical;
//   2. each warp takes whole columns of Minv, read as rows of a transposed
//      copy whose leading dimension is padded to four floats (16-byte
//      loads whatever p is; Minv is symmetric only up to rounding, and the
//      plain form's rhs Minv reads its columns), reduces by shuffles, does
//      the elementwise stage of that coordinate, writes z_new and y_new to
//      a global buffer, and the block's six partial sums go to another;
//   3. grid sync; every block adds the blocks' partial sums in the same
//      fixed order, so all take the same stopping, restart and
//      momentum decisions, bring their copies up to date from the global
//      buffer and form the next right-hand side in the same pass.
// The loop over lambda stays inside the kernel.  The warm restart at each
// lambda (adj_z = z, adj_y = y, a = 1, c = 9999) is folded into step 3 of
// the lambda's last iteration and needs no sync of its own.  The global
// buffers are double-buffered on the parity of an iteration count that
// runs over the WHOLE path: a count that restarted at every lambda would
// give the last iteration of one lambda and the first of the next the same
// parity, and a block that runs ahead would overwrite what a slower one
// still reads.  Every exit of a loop comes from the grid's totals, which
// are the same in every thread of the grid.
//
// What bounds the scan on this card: the grid sync and the L2 latency of
// one row's loads per iteration at p = 1000 (Minv, 4 MB, is L2-resident);
// reading Minv from device memory once p^2 * 4 bytes pass the 50 MB L2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// Scan: one lane warm-started over lambda, on a cooperative grid.
// ---------------------------------------------------------------------------
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / admm::kWarp;

struct ScanParams {
  const float* minvT;  // (p, ldp) row-major: the transpose of Minv
  const float* xty;    // (p,)
  const float* lam;    // (k,)
  float* znew;         // (2, p) z_new by the path iteration's parity
  float* ynew;         // (2, p) y_new by the same
  double* partial;     // (2, kTallSums, grid) per-block sums by the same
  float* z_out;        // (k, p)
  int* niter_out;      // (k,)
  int p, ldp, k, maxit;
  float rho, eps_abs, eps_rel, alpha, restart_tol, sqrt_p;
};

__global__ void __launch_bounds__(kScanThreads, 1)
tall_path_scan_kernel(const __grid_constant__ ScanParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ double wsum[kScanWarps * kTallSums];
  __shared__ double red[(admm::kWarp + 1) * kTallSums];
  const int p = P.p, ldp = P.ldp;
  const float rho = P.rho;
  // ldp doubles (the padding stays 0), then five rows of p floats.
  double* rhs64 = reinterpret_cast<double*>(smem);
  float* z = smem + 2 * ldp;
  float* y = z + p;
  float* adj_z = y + p;
  float* adj_y = adj_z + p;
  float* xty = adj_y + p;
  const int tid = threadIdx.x;
  for (int j = tid; j < 2 * ldp + 4 * p; j += kScanThreads) smem[j] = 0.0f;
  for (int j = tid; j < p; j += kScanThreads) xty[j] = P.xty[j];
  __syncthreads();
  // The cold start's right-hand side, X'y - 0 + rho 0.
  for (int j = tid; j < p; j += kScanThreads)
    rhs64[j] = static_cast<double>(xty[j] - adj_y[j] + rho * adj_z[j]);
  __syncthreads();

  const int warp = tid / admm::kWarp, wlane = tid % admm::kWarp;
  const int gwarp = blockIdx.x * kScanWarps + warp;
  const int gwarps = gridDim.x * kScanWarps;
  const size_t pstride = static_cast<size_t>(gridDim.x) * kTallSums;
  int c_lo, c_hi;  // this block's columns of z_out
  admm::row_tile(p, blockIdx.x, gridDim.x, &c_lo, &c_hi);
  float nx2 = 0.0f, nz2 = 0.0f, ny2 = 0.0f;  // pre-update squared norms
  int path_it = 0;  // iterations over the whole path: the buffers' parity

  for (int kk = 0; kk < P.k; ++kk) {
    const float pen = P.lam[kk] / rho;
    admm::Momentum mom;  // re-synchronised to the warm iterates
    mom.a = 1.0f;
    mom.c = 9999.0f;
    int it = 0;
    while (it < P.maxit) {
      const float eps_pri =
          fmaxf(sqrtf(nx2), sqrtf(nz2)) * P.eps_rel + P.sqrt_p * P.eps_abs;
      const float eps_dua = sqrtf(ny2) * P.eps_rel + P.sqrt_p * P.eps_abs;
      const int par = path_it & 1;
      float* znew = P.znew + static_cast<size_t>(par) * p;
      float* ynew = P.ynew + static_cast<size_t>(par) * p;
      double* partial = P.partial + par * pstride;

      // This warp's coordinates: x_new[j] = sum_i rhs[i] Minv[i, j], then
      // the elementwise stage of coordinate j.
      double s[kTallSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int j = gwarp; j < p; j += gwarps) {
        const double dot = admm::warp_sum(admm::row_dot(
            P.minvT + static_cast<size_t>(j) * ldp, rhs64, ldp, wlane));
        if (wlane == 0) {
          const float xn = static_cast<float>(dot);
          const float ay = adj_y[j];
          const float zn = admm::enet_prox(xn + ay / rho, pen, P.alpha);
          const float r = xn - zn;
          const float yn = ay + rho * r;
          const float dz = zn - z[j];
          const float ez = zn - adj_z[j];
          s[0] += static_cast<double>(dz * dz);  // ||z_new - z||^2: dual
          s[1] += static_cast<double>(r * r);    // ||x_new - z_new||^2: primal
          s[2] += static_cast<double>(ez * ez);  // ||z_new - adj_z||^2
          s[3] += static_cast<double>(xn * xn);  // next iteration's ||x||^2
          s[4] += static_cast<double>(zn * zn);  // next iteration's ||z||^2
          s[5] += static_cast<double>(yn * yn);  // next iteration's ||y||^2
          znew[j] = zn;
          ynew[j] = yn;
        }
      }
      // The block's sums: the warps' in warp order.
      if (wlane == 0) {
#pragma unroll
        for (int c = 0; c < kTallSums; ++c) wsum[warp * kTallSums + c] = s[c];
      }
      __syncthreads();
      if (tid < kTallSums) {
        double t = 0.0;
        for (int w = 0; w < kScanWarps; ++w) t += wsum[w * kTallSums + tid];
        partial[tid * gridDim.x + blockIdx.x] = t;
      }
      grid.sync();

      // Thread b takes block b's sums (the grid is at most kScanThreads
      // blocks; one coalesced load per sum), and the block adds them by a
      // fixed tree: the totals, and every decision below, are the same in
      // every thread of the grid.
#pragma unroll
      for (int c = 0; c < kTallSums; ++c)
        s[c] = tid < gridDim.x ? __ldcg(partial + c * gridDim.x + tid) : 0.0;
      admm::block_sum<kTallSums>(s, red);
      const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
      const float r_pri = sqrtf(static_cast<float>(s[1]));
      const bool done = r_pri < eps_pri && r_dua < eps_dua;
      const admm::MomentumStep m = admm::fadmm_momentum(
          mom, rho, r_pri, static_cast<float>(s[2]), P.restart_tol);
      // The lambda's last iteration: the next lambda starts from
      // adj_z = z, adj_y = y (after the last lambda nothing reads them).
      const bool last = done || it + 1 >= P.maxit;
      for (int j = tid; j < p; j += kScanThreads) {
        // Written by other blocks: read through L2, not this SM's L1.
        const float zn = __ldcg(znew + j);
        const float yn = __ldcg(ynew + j);
        float az, ay;
        if (last) {
          az = zn;
          ay = yn;
        } else {
          az = m.accel ? (1.0f + m.ratio) * zn - m.ratio * z[j] : z[j];
          ay = m.accel ? (1.0f + m.ratio) * yn - m.ratio * y[j] : y[j];
        }
        adj_z[j] = az;
        adj_y[j] = ay;
        z[j] = zn;
        y[j] = yn;
        rhs64[j] = static_cast<double>(xty[j] - ay + rho * az);
      }
      if (!done) {
        mom.a = m.a_new;
        mom.c = m.c_new;
      }
      nx2 = static_cast<float>(s[3]);
      nz2 = static_cast<float>(s[4]);
      ny2 = static_cast<float>(s[5]);
      ++it;
      ++path_it;
      __syncthreads();
      if (done) break;
    }
    for (int j = c_lo + tid; j < c_hi; j += kScanThreads)
      P.z_out[static_cast<size_t>(kk) * p + j] = z[j];
    if (blockIdx.x == 0 && tid == 0) P.niter_out[kk] = it;
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

// The batch entry returns cudaGetLastError() after its launch (0 = launched).
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

// minvT is the transpose of Minv, (p, ldp) with ldp a multiple of four and
// the padding zero; `znew` and `ynew` are (2, p) floats of scratch and
// `partial` (2, 6, blocks) doubles, none of which needs initialising;
// blocks <= 256.
// Returns the launch's error (0 = launched); a grid the card cannot hold at
// once is refused (cudaErrorCooperativeLaunchTooLarge), not run.
int admm_tall_path_scan(const float* minvT, const float* xty,
                        const float* lam, float* znew, float* ynew,
                        double* partial, float* z_out, int* niter_out, int p,
                        int ldp, int k, int blocks, float rho, float eps_abs,
                        float eps_rel, float alpha, int maxit,
                        float restart_tol, void* stream) {
  if (p <= 0 || k <= 0 || blocks <= 0 || blocks > kScanThreads || ldp < p ||
      (ldp & 3))
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(ldp) + 5 * p);
  if (smem > admm::kMaxDynamicSmem) return cudaErrorInvalidValue;
  cudaError_t err = admm::set_dynamic_smem(tall_path_scan_kernel, smem);
  if (err != cudaSuccess) return err;
  ScanParams P;
  P.minvT = minvT;
  P.xty = xty;
  P.lam = lam;
  P.znew = znew;
  P.ynew = ynew;
  P.partial = partial;
  P.z_out = z_out;
  P.niter_out = niter_out;
  P.p = p;
  P.ldp = ldp;
  P.k = k;
  P.maxit = maxit;
  P.rho = rho;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.alpha = alpha;
  P.restart_tol = restart_tol;
  P.sqrt_p = sqrtf(static_cast<float>(p));
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(tall_path_scan_kernel), dim3(blocks),
      dim3(kScanThreads), args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

const char* admm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
