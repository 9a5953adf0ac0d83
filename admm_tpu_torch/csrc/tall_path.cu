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
// all-done exit only stops lanes that are already frozen.  The first
// version gave one block one lane: every lane read all of Minv (4 MB at
// p = 1000) from L2 every iteration and converted each element to float64
// once per lane, 100 lanes sharing the L2's bandwidth (2.6 ms for 100
// lambdas; NVIDIA H100 80GB HBM3, 700 W).  Now, as in wide_path.cu:
//   * one persistent cooperative grid, one block per SM, runs every lane;
//     lane state (the right-hand side rhs, x_new, z_new, y_new, z, y,
//     adj_z, adj_y: (k, ldp) floats each) lives in a float32 scratch
//     buffer in device memory that the wrapper allocates zeroed;
//   * the x-update of every ACTIVE lane is one tall-skinny product,
//     x_new[lane, j] = sum_i rhs[lane, i] Minv[i, j], taken by rows of a
//     transposed copy of Minv (admm::lanes_product with M = Minv'; Minv
//     is symmetric only up to rounding and the plain form reads its
//     columns), the coordinates split over the blocks: one load and one
//     float64 conversion of an element of Minv serves every lane;
//   * on its own coordinates a block then does the elastic-net prox and
//     the y-update and writes six partial sums of squares per lane,
//     sum-major, a group of a warp's lanes per lane; after a grid sync
//     every block adds the partials in the same order (grid_totals_by_sum)
//     and reaches the same stopping, restart and momentum decisions per
//     lane; it brings its coordinates up to date, forms the next
//     right-hand side there, and drops converged lanes from a compacted
//     list of active lanes, the same in every block; a second grid sync
//     lets the next product read every block's right-hand side.
// Two grid syncs per iteration: the momentum step needs the totals, and
// the next product needs every coordinate of the right-hand side.  No
// atomics: two launches give the same bits.  A lane that has converged
// leaves the list with its z and niter final, as the plain form freezes
// it.  What bounds it on this card: float64 multiply-adds, p^2 per
// lane-iteration on the vector units, and, as lanes drop out, the two grid
// syncs and one chunk's L2 latency per iteration.
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

constexpr int kTallSums = 6;

constexpr int kBatchThreads = admm::kGemmThreads;
constexpr int kBatchWarps = kBatchThreads / admm::kWarp;

struct BatchParams {
  const float* minvT;  // (p, ldp) row-major: the transpose of Minv
  const float* xty;    // (p,)
  const float* lam;    // (k,)
  float* rhs;          // (k, ldp) each, zero at launch; X'y - adj_y + rho adj_z
  float* xn;           // x_new
  float* zn;           // z_new
  float* yn;           // y_new
  float* z;
  float* y;
  float* adj_z;
  float* adj_y;
  double* partial;     // (k, kTallSums, blocks)
  float* z_out;        // (k, p)
  int* niter_out;      // (k,)
  int p, ldp, k, maxit;
  float rho, eps_abs, eps_rel, alpha, restart_tol, sqrt_p;
};

struct StoreProduct {
  float* out;
  int ld;
  __device__ void operator()(int j, int lane, float acc) const {
    out[static_cast<size_t>(lane) * ld + j] = acc;
  }
};

__global__ void __launch_bounds__(kBatchThreads, 1)
tall_path_batch_kernel(const __grid_constant__ BatchParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double2 product_smem[];
  __shared__ int act[admm::kMaxLanes];  // the active lanes, ascending
  __shared__ int lane_done[admm::kMaxLanes];  // by position in act
  __shared__ int accel_s[admm::kMaxLanes];    // by lane from here on
  __shared__ float ratio_s[admm::kMaxLanes];
  __shared__ float mom_a[admm::kMaxLanes];
  __shared__ float mom_c[admm::kMaxLanes];
  __shared__ float nx2[admm::kMaxLanes];  // pre-update squared norms
  __shared__ float nz2[admm::kMaxLanes];
  __shared__ float ny2[admm::kMaxLanes];
  __shared__ int nact_s;
  const int p = P.p, k = P.k, ldp = P.ldp;
  const float rho = P.rho;
  const int tid = threadIdx.x;
  const int warp = tid / admm::kWarp, wlane = tid % admm::kWarp;
  const int nblocks = gridDim.x;
  int p_lo, p_hi;  // this block's coordinates: rows of Minv'
  admm::row_tile(p, blockIdx.x, nblocks, &p_lo, &p_hi);
  const int mine = p_hi - p_lo;
  // The elementwise stages give a lane's coordinates of this block (p /
  // blocks: 7 or 8 at p = 1000) to a group of a warp's lanes, the smallest
  // power of two that holds them, at least 8 (as in wide_path.cu).
  int group = 8;
  while (group < mine && group < admm::kWarp) group *= 2;
  const int per_warp = admm::kWarp / group;
  const int sub = wlane / group, g = wlane % group;
  for (int l = tid; l < k; l += kBatchThreads) {
    act[l] = l;
    mom_a[l] = 1.0f;
    mom_c[l] = 9999.0f;
    nx2[l] = nz2[l] = ny2[l] = 0.0f;
  }
  // The cold start's right-hand side, X'y - 0 + rho 0, on this block's
  // coordinates.
  for (int o = tid; o < mine * k; o += kBatchThreads) {
    const int lane = o / mine, j = p_lo + o % mine;
    P.rhs[static_cast<size_t>(lane) * ldp + j] = P.xty[j] - 0.0f + rho * 0.0f;
  }
  __syncthreads();
  grid.sync();
  int nact = k;

  // Every block computes nact and `it` from the same totals: all reach
  // every grid sync the same number of times.
  int it = 0;
  while (it < P.maxit && nact > 0) {
    admm::lanes_product(P.minvT, ldp, p_lo, p_hi, p, P.rhs, ldp, act, nact,
                        product_smem, StoreProduct{P.xn, ldp});

    // This block's coordinates of every active lane: the prox, y and the
    // six sums of squares.  A group of a warp's lanes per lane.
    for (int li0 = warp * per_warp; li0 < nact;
         li0 += kBatchWarps * per_warp) {
      const int li = li0 + sub;
      const bool live = li < nact;
      const int lane = act[live ? li : 0];
      const float pen = P.lam[lane] / rho;
      double s[kTallSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int j = p_lo + g; live && j < p_hi; j += group) {
        const size_t at = static_cast<size_t>(lane) * ldp + j;
        const float xn = P.xn[at];
        const float ay = P.adj_y[at];
        const float zn = admm::enet_prox(xn + ay / rho, pen, P.alpha);
        const float r = xn - zn;
        const float yn = ay + rho * r;
        const float dz = zn - P.z[at];
        const float ez = zn - P.adj_z[at];
        s[0] += static_cast<double>(dz * dz);  // ||z_new - z||^2: dual
        s[1] += static_cast<double>(r * r);    // ||x_new - z_new||^2: primal
        s[2] += static_cast<double>(ez * ez);  // ||z_new - adj_z||^2
        s[3] += static_cast<double>(xn * xn);  // next iteration's ||x||^2
        s[4] += static_cast<double>(zn * zn);  // next iteration's ||z||^2
        s[5] += static_cast<double>(yn * yn);  // next iteration's ||y||^2
        P.zn[at] = zn;
        P.yn[at] = yn;
      }
#pragma unroll
      for (int c = 0; c < kTallSums; ++c) s[c] = admm::group_sum(s[c], group);
      if (live && g == 0) {
        double* dst = P.partial +
                      static_cast<size_t>(lane) * kTallSums * nblocks +
                      blockIdx.x;
#pragma unroll
        for (int c = 0; c < kTallSums; ++c) dst[c * nblocks] = s[c];
      }
    }
    grid.sync();

    // Totals, the Boyd test and the momentum step, alike in every block.
    for (int li = warp; li < nact; li += kBatchWarps) {
      const int lane = act[li];
      double s[kTallSums];
      admm::grid_totals_by_sum<kTallSums>(
          P.partial + static_cast<size_t>(lane) * kTallSums * nblocks,
          nblocks, wlane, s);
      if (wlane == 0) {
        const float eps_pri =
            fmaxf(sqrtf(nx2[lane]), sqrtf(nz2[lane])) * P.eps_rel +
            P.sqrt_p * P.eps_abs;
        const float eps_dua = sqrtf(ny2[lane]) * P.eps_rel +
                              P.sqrt_p * P.eps_abs;
        const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
        const float r_pri = sqrtf(static_cast<float>(s[1]));
        const bool done = r_pri < eps_pri && r_dua < eps_dua;
        admm::Momentum mom;
        mom.a = mom_a[lane];
        mom.c = mom_c[lane];
        const admm::MomentumStep m = admm::fadmm_momentum(
            mom, rho, r_pri, static_cast<float>(s[2]), P.restart_tol);
        if (!done) {
          mom_a[lane] = m.a_new;
          mom_c[lane] = m.c_new;
        }
        lane_done[li] = done;
        accel_s[lane] = m.accel;
        ratio_s[lane] = m.ratio;
        nx2[lane] = static_cast<float>(s[3]);
        nz2[lane] = static_cast<float>(s[4]);
        ny2[lane] = static_cast<float>(s[5]);
      }
    }
    ++it;
    __syncthreads();

    // The refresh of this block's coordinates, and the next right-hand
    // side in the same pass; a lane that is done keeps its adj_*.
    for (int li = warp * per_warp + sub; li < nact;
         li += kBatchWarps * per_warp) {
      const int lane = act[li];
      const bool done = lane_done[li];
      const bool accel = accel_s[lane];
      const float ratio = ratio_s[lane];
      for (int j = p_lo + g; j < p_hi; j += group) {
        const size_t at = static_cast<size_t>(lane) * ldp + j;
        const float zn = P.zn[at], yn = P.yn[at];
        const float zo = P.z[at], yo = P.y[at];
        if (!done) {
          const float az = accel ? (1.0f + ratio) * zn - ratio * zo : zo;
          const float ay = accel ? (1.0f + ratio) * yn - ratio * yo : yo;
          P.adj_z[at] = az;
          P.adj_y[at] = ay;
          P.rhs[at] = P.xty[j] - ay + rho * az;
        }
        P.z[at] = zn;
        P.y[at] = yn;
      }
    }
    __syncthreads();
    if (tid == 0) {  // drop the lanes that are done; the order is kept
      int kept = 0;
      for (int li = 0; li < nact; ++li) {
        const int lane = act[li];
        if (lane_done[li]) {
          if (blockIdx.x == 0) P.niter_out[lane] = it;
        } else {
          act[kept++] = lane;
        }
      }
      nact_s = kept;
    }
    __syncthreads();
    nact = nact_s;
    grid.sync();  // the next product reads every block's right-hand side
  }
  if (blockIdx.x == 0)  // lanes that ran out of iterations
    for (int li = tid; li < nact; li += kBatchThreads)
      P.niter_out[act[li]] = it;
  for (int o = tid; o < mine * k; o += kBatchThreads) {
    const int lane = o / mine, j = p_lo + o % mine;
    P.z_out[static_cast<size_t>(lane) * p + j] =
        P.z[static_cast<size_t>(lane) * ldp + j];
  }
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

}  // namespace

extern "C" {

// minvT is the transpose of Minv, (p, ldp) with ldp a multiple of four and
// the padding zero; `scratch` holds 8 k ldp floats, all zero; `partial`
// k * 6 * blocks doubles; k <= 128 lanes; blocks from
// kernels/tall_path.py::batch_launch_plan.  Returns the launch's error
// (0 = launched); a grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge), not run.
int admm_tall_path_batch(const float* minvT, const float* xty,
                         const float* lam, float* scratch, double* partial,
                         float* z_out, int* niter_out, int p, int ldp, int k,
                         int blocks, float rho, float eps_abs, float eps_rel,
                         float alpha, int maxit, float restart_tol,
                         void* stream) {
  if (p <= 0 || k <= 0 || k > admm::kMaxLanes || blocks <= 0 || ldp < p ||
      (ldp & 3))
    return cudaErrorInvalidValue;
  const size_t kp = static_cast<size_t>(k) * ldp;
  BatchParams P;
  P.minvT = minvT;
  P.xty = xty;
  P.lam = lam;
  P.rhs = scratch;
  P.xn = scratch + kp;
  P.zn = scratch + 2 * kp;
  P.yn = scratch + 3 * kp;
  P.z = scratch + 4 * kp;
  P.y = scratch + 5 * kp;
  P.adj_z = scratch + 6 * kp;
  P.adj_y = scratch + 7 * kp;
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
  const size_t smem = admm::kGemmSmemBytes;
  cudaError_t err = admm::set_dynamic_smem(tall_path_batch_kernel, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(tall_path_batch_kernel), dim3(blocks),
      dim3(kBatchThreads), args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
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
