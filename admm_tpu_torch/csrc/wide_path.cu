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
// Design.  The first version gave one block one lane, with the lane's state
// in shared memory: every lane read X twice per iteration through one SM's
// few loads in flight and converted every element to float64 once per lane
// (79 ms for 100 lambdas at 1000 x 2000; NVIDIA H100 80GB HBM3, 700 W).
// Now, as in bp.cu and glm.cu:
//   * one persistent cooperative grid, one block per SM, runs every lane;
//     x (lane-major, (k, ldp)) and Ax, z, y and the gradient's left factor
//     tmp = Ax + z + y/rho ((k, ldn) each) live in a float32 scratch buffer
//     in device memory (L2-resident), which the wrapper allocates zeroed;
//   * each product is a tall-skinny product over the ACTIVE lanes with its
//     output rows split over the blocks (admm::lanes_product): grad = X' tmp
//     by rows of X' (a transposed copy the wrapper makes once per call),
//     whose epilogue is the linearized x-update with the lane's own rho, and
//     Ax = X x by rows of X.  One load and one float64 conversion of a matrix
//     element serves every lane;
//   * after the second product a block holds its rows of Ax for every lane:
//     it does the z and y updates there and writes five partial sums of
//     squares per lane; after a grid sync every block adds the partials in
//     the same order and reaches the same totals, stopping decisions and
//     steps of the rho ladder, and rebuilds the same compacted list of
//     active lanes.  No atomics: two launches give the same bits;
//   * tmp needs the rho the ladder has JUST set, which is known only after
//     the totals: each block then forms tmp for its own rows, and a third
//     grid sync lets the next product read every block's.  (Forming tmp
//     inside the second product's epilogue would use the old rho; forming
//     it when the product loads its vectors would save this sync and read
//     three vectors for one from L2, which is already the larger stream,
//     and would put a loader into the routine bp.cu and glm.cu share.)
//   * a lane that has converged leaves the list; its x and niter are final.
//     Leading dimensions are padded to four floats by the wrapper.
// Three grid syncs per iteration.  One lambda (k = 1) is the same kernel.
//
// What bounds it on this card: float64 multiply-adds, 2 n p per lane and
// iteration on the vector units, and, when lanes are few, the three grid
// syncs and the latency of one chunk's loads from L2 (X and X', 8 MB each,
// stay resident in the 50 MB L2).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = admm::kGemmThreads;
constexpr int kWideSums = 5;

struct WideParams {
  const float* X;     // (n, ldp) row-major
  const float* XT;    // (p, ldn) its transpose
  const float* ys;    // (n,)
  const float* lam;   // (k,)
  const float* rho0;  // (k,) each lane's starting rho
  float* x;           // (k, ldp), zero at launch
  float* ax;          // (k, ldn) each, zero at launch
  float* z;
  float* y;
  float* tmp;         // Ax + z + y / rho
  double* partial;    // (k, kWideSums, blocks)
  float* x_out;       // (k, p)
  int* niter_out;     // (k,)
  int n, p, k, ldp, ldn;
  float sprad, lambda0, eps_abs, eps_rel, alpha;
  int maxit, rho_start_iter;
};

struct StoreProduct {
  float* out;
  int ld;
  __device__ void operator()(int i, int lane, float acc) const {
    out[static_cast<size_t>(lane) * ld + i] = acc;
  }
};

// The linearized x-update of coordinate j of one lane, from the gradient.
struct XUpdate {
  const WideParams& P;
  const float* pen;      // per lane: lam / (rho sprad)
  const int* zero_exit;  // per lane: lam > lambda0 (1 - 1e-5)
  __device__ void operator()(int j, int lane, float g) const {
    const size_t at = static_cast<size_t>(lane) * P.ldp + j;
    const float v = __ldcg(P.x + at) - g / P.sprad;
    P.x[at] =
        zero_exit[lane] ? 0.0f : admm::enet_prox(v, pen[lane], P.alpha);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
wide_path_batch_kernel(const __grid_constant__ WideParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double2 smem[];
  __shared__ int act[admm::kMaxLanes];  // the active lanes, ascending
  __shared__ int lane_done[admm::kMaxLanes];
  __shared__ int zero_exit[admm::kMaxLanes];
  __shared__ float rho_s[admm::kMaxLanes];
  __shared__ float pen_s[admm::kMaxLanes];
  __shared__ float nax2[admm::kMaxLanes];  // pre-update squared norms
  __shared__ float nz2[admm::kMaxLanes];
  __shared__ float ny2[admm::kMaxLanes];
  __shared__ int nact_s;
  const int n = P.n, p = P.p, k = P.k, ldp = P.ldp, ldn = P.ldn;
  const int tid = threadIdx.x;
  const int warp = tid / admm::kWarp, wlane = tid % admm::kWarp;
  const int nwarps = kThreads / admm::kWarp;
  const int nblocks = gridDim.x;
  const float sqrt_n = sqrtf(static_cast<float>(n));
  const float sqrt_p = sqrtf(static_cast<float>(p));
  const float sqrt_sprad = sqrtf(P.sprad);
  int n_lo, n_hi, p_lo, p_hi;  // this block's rows of X, and of X'
  admm::row_tile(n, blockIdx.x, nblocks, &n_lo, &n_hi);
  admm::row_tile(p, blockIdx.x, nblocks, &p_lo, &p_hi);
  // The elementwise stages give a lane's rows of this block (n / blocks: 7
  // or 8 at n = 1000) to a group of lanes of a warp, the smallest power of
  // two that holds them, at least 8: a warp then takes 32 / group lanes at
  // once, where a whole warp per lane would leave most of its threads idle
  // and pay one L2 latency per lane in turn.
  int group = 8;
  while (group < n_hi - n_lo && group < admm::kWarp) group *= 2;
  const int per_warp = admm::kWarp / group;
  const int sub = wlane / group, g = wlane % group;
  for (int l = tid; l < k; l += kThreads) {
    const float lam_l = P.lam[l], rho_l = P.rho0[l];
    act[l] = l;
    rho_s[l] = rho_l;
    pen_s[l] = lam_l / (rho_l * P.sprad);
    // float32(1 - 1e-5), the factor the plain form multiplies by.
    zero_exit[l] = lam_l > P.lambda0 * 0.99999f;
    nax2[l] = nz2[l] = ny2[l] = 0.0f;
  }
  __syncthreads();
  int nact = k;

  // Every block computes nact and `it` from the same totals: all reach
  // every grid sync the same number of times.  tmp is 0 at the cold start.
  int it = 0;
  while (it < P.maxit && nact > 0) {
    admm::lanes_product(P.XT, ldn, p_lo, p_hi, n, P.tmp, ldn, act, nact, smem,
                        XUpdate{P, pen_s, zero_exit});
    grid.sync();
    admm::lanes_product(P.X, ldp, n_lo, n_hi, p, P.x, ldp, act, nact, smem,
                        StoreProduct{P.ax, ldn});

    // This block's rows of every active lane: z, y and the five sums of
    // squares.  A group of a warp's lanes per lane.
    for (int li0 = warp * per_warp; li0 < nact; li0 += nwarps * per_warp) {
      const int li = li0 + sub;
      const bool live = li < nact;
      const int lane = act[live ? li : 0];
      const float rho = rho_s[lane];
      double s[kWideSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
      for (int i = n_lo + g; live && i < n_hi; i += group) {
        const size_t at = static_cast<size_t>(lane) * ldn + i;
        const float acc = __ldcg(P.ax + at);
        const float yo = __ldcg(P.y + at);
        const float zn = -(P.ys[i] + yo + rho * acc) / (1.0f + rho);
        const float r = acc + zn;
        const float yn = yo + rho * r;
        const float dz = zn - __ldcg(P.z + at);
        s[0] += static_cast<double>(dz * dz);    // ||z_new - z||^2: dual
        s[1] += static_cast<double>(r * r);      // ||Ax + z_new||^2: primal
        s[2] += static_cast<double>(acc * acc);  // next ||Ax||^2
        s[3] += static_cast<double>(zn * zn);    // next ||z||^2
        s[4] += static_cast<double>(yn * yn);    // next ||y||^2
        P.z[at] = zn;
        P.y[at] = yn;
      }
#pragma unroll
      for (int c = 0; c < kWideSums; ++c) s[c] = admm::group_sum(s[c], group);
      if (live && g == 0) {
        double* dst = P.partial +
                      static_cast<size_t>(lane) * kWideSums * nblocks +
                      blockIdx.x;
#pragma unroll
        for (int c = 0; c < kWideSums; ++c) dst[c * nblocks] = s[c];
      }
    }
    grid.sync();

    // Totals, the Boyd test and the rho ladder, alike in every block.
    for (int li = warp; li < nact; li += nwarps) {
      const int lane = act[li];
      double s[kWideSums];
      admm::grid_totals_by_sum<kWideSums>(
          P.partial + static_cast<size_t>(lane) * kWideSums * nblocks, nblocks,
          wlane, s);
      if (wlane == 0) {
        const float rho = rho_s[lane];
        const float eps_pri =
            fmaxf(sqrtf(nax2[lane]), sqrtf(nz2[lane])) * P.eps_rel +
            sqrt_n * P.eps_abs;
        const float eps_dua =
            sqrt_sprad * sqrtf(ny2[lane]) * P.eps_rel + sqrt_p * P.eps_abs;
        const float r_dua = rho * sqrt_sprad * sqrtf(static_cast<float>(s[0]));
        const float r_pri = sqrtf(static_cast<float>(s[1]));
        const bool done = r_pri < eps_pri && r_dua < eps_dua;
        const float ratio_p = r_pri / eps_pri;
        const float ratio_d = r_dua / eps_dua;
        float rho_a = ratio_p > 10.0f * ratio_d ? rho * 2.0f : rho;
        rho_a = ratio_d > 10.0f * ratio_p ? rho_a * 0.5f : rho_a;
        rho_a = r_pri < eps_pri ? rho_a / 1.2f : rho_a;
        rho_a = r_dua < eps_dua ? rho_a * 1.2f : rho_a;
        if (!(done || it <= P.rho_start_iter)) {
          rho_s[lane] = rho_a;
          pen_s[lane] = P.lam[lane] / (rho_a * P.sprad);
        }
        lane_done[li] = done;
        nax2[lane] = static_cast<float>(s[2]);
        nz2[lane] = static_cast<float>(s[3]);
        ny2[lane] = static_cast<float>(s[4]);
      }
    }
    ++it;
    __syncthreads();

    // The next gradient's left factor on this block's rows, with the rho
    // the ladder has just set.
    for (int li = warp * per_warp + sub; li < nact; li += nwarps * per_warp) {
      if (lane_done[li]) continue;
      const int lane = act[li];
      const float rho = rho_s[lane];
      for (int i = n_lo + g; i < n_hi; i += group) {
        const size_t at = static_cast<size_t>(lane) * ldn + i;
        P.tmp[at] = __ldcg(P.ax + at) + __ldcg(P.z + at) + __ldcg(P.y + at) / rho;
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
    grid.sync();  // the next product reads every block's tmp
  }
  if (blockIdx.x == 0)  // lanes that ran out of iterations
    for (int li = tid; li < nact; li += kThreads) P.niter_out[act[li]] = it;
  const int mine = p_hi - p_lo;
  for (int o = tid; o < mine * k; o += kThreads) {
    const int lane = o / mine, j = p_lo + o % mine;
    P.x_out[static_cast<size_t>(lane) * p + j] =
        __ldcg(P.x + static_cast<size_t>(lane) * ldp + j);
  }
}

}  // namespace

extern "C" {

// X (n, ldp) and XT (p, ldn) are zero-padded to leading dimensions that are
// multiples of four; `scratch` holds k ldp + 4 k ldn floats, all zero;
// `partial` k * 5 * blocks doubles; k <= 128 lanes.  Returns the launch's
// error (0 = launched).
int admm_wide_path_batch(const float* X, const float* XT, const float* ys,
                         const float* lam, const float* rho, float* scratch,
                         double* partial, float* x_out, int* niter_out, int n,
                         int p, int k, int ldp, int ldn, int blocks,
                         float sprad, float lambda0, float eps_abs,
                         float eps_rel, float alpha, int maxit,
                         int rho_start_iter, void* stream) {
  if (n <= 0 || p <= 0 || k <= 0 || k > admm::kMaxLanes || blocks <= 0 ||
      ldp < p || ldn < n || (ldp & 3) || (ldn & 3))
    return cudaErrorInvalidValue;
  const size_t kp = static_cast<size_t>(k) * ldp;
  const size_t kn = static_cast<size_t>(k) * ldn;
  WideParams P;
  P.X = X;
  P.XT = XT;
  P.ys = ys;
  P.lam = lam;
  P.rho0 = rho;
  P.x = scratch;
  P.ax = scratch + kp;
  P.z = scratch + kp + kn;
  P.y = scratch + kp + 2 * kn;
  P.tmp = scratch + kp + 3 * kn;
  P.partial = partial;
  P.x_out = x_out;
  P.niter_out = niter_out;
  P.n = n;
  P.p = p;
  P.k = k;
  P.ldp = ldp;
  P.ldn = ldn;
  P.sprad = sprad;
  P.lambda0 = lambda0;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.alpha = alpha;
  P.maxit = maxit;
  P.rho_start_iter = rho_start_iter;
  const size_t smem = admm::kGemmSmemBytes;
  cudaError_t err = admm::set_dynamic_smem(wide_path_batch_kernel, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&P};
  // A grid the card cannot hold at once is refused here
  // (cudaErrorCooperativeLaunchTooLarge), not run.
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(wide_path_batch_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
