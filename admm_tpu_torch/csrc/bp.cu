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
// Design.  The first version gave one block one lane, with the lane's state
// in shared memory: every signal read A and Winv again through one SM's
// few loads in flight (396 ms for 100 signals at 1000 x 2000, 95 ms for
// one signal on one SM; NVIDIA H100 80GB HBM3, 700 W).  Now:
//   * one persistent cooperative grid, one block per SM, runs every lane;
//     z, y, adj_z, adj_y, z_new, y_new, v, x (lane-major, (m, ldp)) and t, u
//     (m, ldn) live in a float32 scratch buffer in device memory
//     (L2-resident), which the wrapper allocates zeroed;
//   * each product is a tall-skinny product over the ACTIVE lanes with its
//     output rows split over the blocks (admm::lanes_product): t = A v by
//     rows of A, u = t Winv by rows of Winv' (Winv is symmetric only up to
//     rounding, and the plain form's t Winv reads its columns: with Winv's
//     rows z drifted 1e-3 from the plain form's), x = v + aaab - A' u by
//     rows of A' (transposed copies the wrapper makes once per call).  One
//     load and one float64 conversion of a matrix element serves every
//     lane; a grid sync follows each product;
//   * after the third product a block holds its coordinates of every lane:
//     it does the soft-threshold, r and y there and writes six partial sums
//     of squares per lane; after a grid sync every block adds the partials
//     in the same order and reaches the same totals, stopping decisions and
//     momentum steps, applies the momentum's vector half to its own
//     coordinates, writes v for the next iteration, and rebuilds the same
//     compacted list of active lanes.  No atomics: two launches give the
//     same bits.  A lane that has converged leaves the list with its
//     momentum held; its z and niter are final;
//   * leading dimensions are padded to four floats by the wrapper.
// Four grid syncs per iteration.  One signal (m = 1) is the same kernel: a
// matrix-vector product split over the SMs.
//
// What bounds it on this card: float64 multiply-adds, 2 n p + n^2 per lane
// and iteration on the vector units, and, when lanes are few, the four grid
// syncs and the latency of one chunk's loads from L2 (A, 8 MB, and Winv,
// 4 MB, stay resident in the 50 MB L2).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = admm::kGemmThreads;
constexpr int kBpSums = 6;

struct BpParams {
  const float* A;     // (n, ldp) row-major
  const float* AT;    // (p, ldn) its transpose
  const float* winvT; // (n, ldn) transpose of (AA')^-1
  const float* aaab;  // (m, p) rows A' Winv b_i
  float* z;           // (m, ldp) each, zero at launch
  float* y;
  float* adj_z;
  float* adj_y;
  float* zn;          // z_new
  float* yn;          // y_new
  float* v;           // adj_z - adj_y / rho
  float* x;
  float* t;           // (m, ldn) each
  float* u;
  double* partial;    // (blocks, m, kBpSums)
  float* z_out;       // (m, p)
  int* niter_out;     // (m,)
  int n, p, m, ldp, ldn;
  float rho, eps_abs, eps_rel, restart_tol;
  int maxit;
};

struct StoreProduct {
  float* out;
  int ld;
  __device__ void operator()(int i, int lane, float acc) const {
    out[static_cast<size_t>(lane) * ld + i] = acc;
  }
};

// x = v + aaab - A' u.
struct XUpdate {
  const BpParams& P;
  __device__ void operator()(int j, int lane, float corr) const {
    const size_t at = static_cast<size_t>(lane) * P.ldp + j;
    P.x[at] = __ldcg(P.v + at) + P.aaab[static_cast<size_t>(lane) * P.p + j] -
              corr;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
bp_batch_kernel(const __grid_constant__ BpParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double2 smem[];
  __shared__ int act[admm::kMaxLanes];     // the active lanes, ascending
  __shared__ int lane_done[admm::kMaxLanes];
  __shared__ int lane_accel[admm::kMaxLanes];
  __shared__ float lane_ratio[admm::kMaxLanes];
  __shared__ float nx2[admm::kMaxLanes];   // pre-update squared norms
  __shared__ float nz2[admm::kMaxLanes];
  __shared__ float ny2[admm::kMaxLanes];
  __shared__ admm::Momentum mom[admm::kMaxLanes];
  __shared__ int nact_s;
  const int n = P.n, p = P.p, m = P.m, ldp = P.ldp, ldn = P.ldn;
  const float rho = P.rho;
  const float pen = 1.0f / rho;
  const int tid = threadIdx.x;
  const int warp = tid / admm::kWarp, wlane = tid % admm::kWarp;
  const int nwarps = kThreads / admm::kWarp;
  const int nblocks = gridDim.x;
  const float sqrt_p = sqrtf(static_cast<float>(p));
  int n_lo, n_hi, p_lo, p_hi;  // this block's rows of A and Winv, and of A'
  admm::row_tile(n, blockIdx.x, nblocks, &n_lo, &n_hi);
  admm::row_tile(p, blockIdx.x, nblocks, &p_lo, &p_hi);
  for (int l = tid; l < m; l += kThreads) {
    act[l] = l;
    nx2[l] = nz2[l] = ny2[l] = 0.0f;
    mom[l].a = 1.0f;
    mom[l].c = 9999.0f;
  }
  __syncthreads();
  int nact = m;

  // Every block computes nact and `it` from the same totals: all reach
  // every grid sync the same number of times.  v is 0 at the cold start.
  int it = 0;
  while (it < P.maxit && nact > 0) {
    admm::lanes_product(P.A, ldp, n_lo, n_hi, p, P.v, ldp, act, nact, smem,
                        StoreProduct{P.t, ldn});
    grid.sync();
    admm::lanes_product(P.winvT, ldn, n_lo, n_hi, n, P.t, ldn, act, nact, smem,
                        StoreProduct{P.u, ldn});
    grid.sync();
    admm::lanes_product(P.AT, ldn, p_lo, p_hi, n, P.u, ldn, act, nact, smem,
                        XUpdate{P});

    // This block's coordinates of every active lane: z, r, y and the six
    // sums of squares.  A warp per lane.
    for (int li = warp; li < nact; li += nwarps) {
      const int lane = act[li];
      double s[kBpSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int j = p_lo + wlane; j < p_hi; j += admm::kWarp) {
        const size_t at = static_cast<size_t>(lane) * ldp + j;
        const float xn = __ldcg(P.x + at);
        const float ay = __ldcg(P.adj_y + at);
        const float zn = admm::soft_threshold(xn + ay / rho, pen);
        const float r = xn - zn;
        const float y_new = ay + rho * r;
        const float dz = zn - __ldcg(P.z + at);
        const float ez = zn - __ldcg(P.adj_z + at);
        s[0] += static_cast<double>(dz * dz);  // ||z_new - z||^2: dual residual
        s[1] += static_cast<double>(r * r);    // ||x_new - z_new||^2: primal
        s[2] += static_cast<double>(ez * ez);  // ||z_new - adj_z||^2: combined
        s[3] += static_cast<double>(xn * xn);  // next iteration's ||x||^2
        s[4] += static_cast<double>(zn * zn);  // next iteration's ||z||^2
        s[5] += static_cast<double>(y_new * y_new);  // next ||y||^2
        P.zn[at] = zn;
        P.yn[at] = y_new;
      }
#pragma unroll
      for (int c = 0; c < kBpSums; ++c) s[c] = admm::warp_sum(s[c]);
      if (wlane == 0) {
        double* dst = P.partial +
                      (static_cast<size_t>(blockIdx.x) * m + lane) * kBpSums;
#pragma unroll
        for (int c = 0; c < kBpSums; ++c) dst[c] = s[c];
      }
    }
    grid.sync();

    // Totals, the Boyd test and the momentum's scalar half, alike in
    // every block.
    for (int li = warp; li < nact; li += nwarps) {
      const int lane = act[li];
      double s[kBpSums];
      admm::grid_totals<kBpSums>(P.partial + lane * kBpSums,
                                 static_cast<size_t>(m) * kBpSums, nblocks,
                                 wlane, s);
      if (wlane == 0) {
        const float eps_pri =
            fmaxf(sqrtf(nx2[lane]), sqrtf(nz2[lane])) * P.eps_rel +
            sqrt_p * P.eps_abs;
        const float eps_dua = sqrtf(ny2[lane]) * P.eps_rel + sqrt_p * P.eps_abs;
        const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
        const float r_pri = sqrtf(static_cast<float>(s[1]));
        const bool done = r_pri < eps_pri && r_dua < eps_dua;
        const admm::MomentumStep ms = admm::fadmm_momentum(
            mom[lane], rho, r_pri, static_cast<float>(s[2]), P.restart_tol);
        lane_done[li] = done;
        lane_accel[li] = ms.accel;
        lane_ratio[li] = ms.ratio;
        if (!done) {  // held on the converging iteration
          mom[lane].a = ms.a_new;
          mom[lane].c = ms.c_new;
        }
        nx2[lane] = static_cast<float>(s[3]);
        nz2[lane] = static_cast<float>(s[4]);
        ny2[lane] = static_cast<float>(s[5]);
      }
    }
    ++it;
    __syncthreads();

    // The momentum's vector half on this block's coordinates, and v for
    // the next iteration's first product.
    for (int li = warp; li < nact; li += nwarps) {
      const int lane = act[li];
      const bool done = lane_done[li], accel = lane_accel[li];
      const float ratio = lane_ratio[li];
      for (int j = p_lo + wlane; j < p_hi; j += admm::kWarp) {
        const size_t at = static_cast<size_t>(lane) * ldp + j;
        const float zn = __ldcg(P.zn + at);
        const float y_new = __ldcg(P.yn + at);
        if (!done) {
          const float zo = __ldcg(P.z + at), yo = __ldcg(P.y + at);
          const float az = accel ? (1.0f + ratio) * zn - ratio * zo : zo;
          const float ay = accel ? (1.0f + ratio) * y_new - ratio * yo : yo;
          P.adj_z[at] = az;
          P.adj_y[at] = ay;
          P.v[at] = az - ay / rho;
        }
        P.z[at] = zn;
        P.y[at] = y_new;
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
    grid.sync();  // the next product reads every block's v
  }
  if (blockIdx.x == 0)  // lanes that ran out of iterations
    for (int li = tid; li < nact; li += kThreads) P.niter_out[act[li]] = it;
  const int mine = p_hi - p_lo;
  for (int o = tid; o < mine * m; o += kThreads) {
    const int lane = o / mine, j = p_lo + o % mine;
    P.z_out[static_cast<size_t>(lane) * p + j] =
        __ldcg(P.z + static_cast<size_t>(lane) * ldp + j);
  }
}

}  // namespace

extern "C" {

// A (n, ldp), AT (p, ldn) and winvT (n, ldn) are zero-padded to leading
// dimensions that are multiples of four; `scratch` holds 8 m ldp + 2 m ldn
// floats, all zero; `partial` blocks * m * 6 doubles; m <= 128 lanes.
// Returns the launch's error (0 = launched).
int admm_bp_batch_solve(const float* A, const float* AT, const float* winvT,
                        const float* aaab, float* scratch, double* partial,
                        float* z_out, int* niter_out, int n, int p, int m,
                        int ldp, int ldn, int blocks, float rho, float eps_abs,
                        float eps_rel, int maxit, float restart_tol,
                        void* stream) {
  if (n <= 0 || p <= 0 || m <= 0 || m > admm::kMaxLanes || blocks <= 0 ||
      ldp < p || ldn < n || (ldp & 3) || (ldn & 3))
    return cudaErrorInvalidValue;
  const size_t mp = static_cast<size_t>(m) * ldp;
  const size_t mn = static_cast<size_t>(m) * ldn;
  BpParams P;
  P.A = A;
  P.AT = AT;
  P.winvT = winvT;
  P.aaab = aaab;
  P.z = scratch;
  P.y = scratch + mp;
  P.adj_z = scratch + 2 * mp;
  P.adj_y = scratch + 3 * mp;
  P.zn = scratch + 4 * mp;
  P.yn = scratch + 5 * mp;
  P.v = scratch + 6 * mp;
  P.x = scratch + 7 * mp;
  P.t = scratch + 8 * mp;
  P.u = scratch + 8 * mp + mn;
  P.partial = partial;
  P.z_out = z_out;
  P.niter_out = niter_out;
  P.n = n;
  P.p = p;
  P.m = m;
  P.ldp = ldp;
  P.ldn = ldn;
  P.rho = rho;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.restart_tol = restart_tol;
  P.maxit = maxit;
  const size_t smem = admm::kGemmSmemBytes;
  cudaError_t err = admm::set_dynamic_smem(bp_batch_kernel, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&P};
  // A grid the card cannot hold at once is refused here
  // (cudaErrorCooperativeLaunchTooLarge), not run.
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(bp_batch_kernel), dim3(blocks), dim3(kThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
