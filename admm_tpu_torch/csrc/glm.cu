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
// Design.  The first version gave one block one lane, with the lane's state
// in shared memory: every lane read Xa and Minv again, through one SM's few
// loads in flight, and converted each element to float64 once per lane; at
// 10000 x 1001 with 100 lambdas it took 2052 ms against 165-291 ms of its
// own plain form, whose float64 matrix products share each load of Xa among
// the lanes (NVIDIA H100 80GB HBM3, 700 W).  Now:
//   * one persistent cooperative grid, one block per SM, runs every lane;
//     x, z, y, grad (lane-major, (k, ldq)) and G (k, ldn) live in a float32
//     scratch buffer in device memory (L2-resident), which the wrapper
//     allocates zeroed;
//   * each product is a tall-skinny product over the ACTIVE lanes with its
//     output rows split over the blocks (admm::lanes_product), so that no
//     sum crosses a block: U = Xa B by rows of Xa, with the family gradient
//     applied to the block's tile of U; grad by rows of Xa' (a transposed
//     copy the wrapper makes once per call: one routine and one access
//     pattern, 16-byte loads along the depth); the step by rows of Minv.
//     One load and one float64 conversion of a matrix element serves every
//     lane.  A grid sync follows each product;
//   * after the last step a block holds its coordinates of every lane: it
//     does the prox and the dual ascent there and writes five partial sums
//     of squares per lane; after one more grid sync every block adds the
//     partials in the same order, reaches the same totals and stopping
//     decisions, and rebuilds the same compacted list of active lanes.  No
//     atomics: two launches give the same bits.  A lane that has converged
//     leaves the list; its state and niter are final.  The grid leaves the
//     loop when the list is empty or at maxit;
//   * leading dimensions are padded to four floats (q = 1001 -> 1004) by
//     the wrapper, zero-filled.
// 3 newton_steps + 1 grid syncs per iteration.  One lane (k = 1) is the same
// kernel: a matrix-vector product split over the SMs.
//
// What bounds it on this card: float64 multiply-adds, 2 n q + q^2 per lane
// and Newton step on the vector units (no float64 tensor-core path is used
// here), the blocks' reads of every active lane's G (n floats per lane and
// block) from L2 in the second product, and the grid syncs when lanes or
// rows are few.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "admm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = admm::kGemmThreads;
constexpr int kGlmSums = 5;
constexpr int kBinomial = 0;
constexpr int kHuber = 1;

struct GlmParams {
  const float* Xa;    // (n, ldq) row-major, the ones column included
  const float* XaT;   // (q, ldn) its transpose
  const float* Minv;  // (q, ldq) symmetric majorizer inverse
  const float* ys;    // (n,)
  const float* mask;  // (q,) penalty mask
  const float* lam;   // (k,)
  float* x;           // (k, ldq) each, zero at launch
  float* z;
  float* y;
  float* grad;
  float* G;           // (k, ldn)
  double* partial;    // (blocks, k, kGlmSums)
  float* z_out;       // (k, q)
  int* niter_out;     // (k,)
  int n, q, k, ldq, ldn;
  float rho, eps_abs, eps_rel, alpha, huber_m;
  int maxit, newton_steps;
};

// G = dloss/deta at U = Xa B, for the block's rows of every active lane.
template <int kFamily>
struct FamilyGradient {
  const GlmParams& P;
  __device__ void operator()(int i, int lane, float u) const {
    const float g = kFamily == kBinomial
                        ? admm::binomial_grad_eta(u, P.ys[i])
                        : admm::huber_grad_eta(u, P.ys[i], P.huber_m);
    P.G[static_cast<size_t>(lane) * P.ldn + i] = g;
  }
};

// grad = Xa' G / n + rho (B - v),  v = z - y / rho.
struct Gradient {
  const GlmParams& P;
  __device__ void operator()(int j, int lane, float acc) const {
    const size_t at = static_cast<size_t>(lane) * P.ldq + j;
    const float v = __ldcg(P.z + at) - __ldcg(P.y + at) / P.rho;
    P.grad[at] =
        acc / static_cast<float>(P.n) + P.rho * (__ldcg(P.x + at) - v);
  }
};

// B = B - Minv grad.
struct NewtonStep {
  const GlmParams& P;
  __device__ void operator()(int j, int lane, float acc) const {
    const size_t at = static_cast<size_t>(lane) * P.ldq + j;
    P.x[at] = __ldcg(P.x + at) - acc;
  }
};

template <int kFamily>
__global__ void __launch_bounds__(kThreads, 1)
glm_batch_path_kernel(const __grid_constant__ GlmParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ double2 smem[];
  __shared__ int act[admm::kMaxLanes];     // the active lanes, ascending
  __shared__ int lane_done[admm::kMaxLanes];
  __shared__ float nx2[admm::kMaxLanes];   // pre-update squared norms
  __shared__ float nz2[admm::kMaxLanes];
  __shared__ float ny2[admm::kMaxLanes];
  __shared__ int nact_s;
  const int n = P.n, q = P.q, k = P.k, ldq = P.ldq;
  const float rho = P.rho;
  const int tid = threadIdx.x;
  const int warp = tid / admm::kWarp, wlane = tid % admm::kWarp;
  const int nwarps = kThreads / admm::kWarp;
  const int nblocks = gridDim.x;
  const float sqrt_q = sqrtf(static_cast<float>(q));
  int n_lo, n_hi, q_lo, q_hi;  // this block's rows of Xa, and of Xa', Minv
  admm::row_tile(n, blockIdx.x, nblocks, &n_lo, &n_hi);
  admm::row_tile(q, blockIdx.x, nblocks, &q_lo, &q_hi);
  for (int l = tid; l < k; l += kThreads) {
    act[l] = l;
    nx2[l] = nz2[l] = ny2[l] = 0.0f;
  }
  __syncthreads();
  int nact = k;

  // Every block computes nact and `it` from the same totals: all reach
  // every grid sync the same number of times.
  int it = 0;
  while (it < P.maxit && nact > 0) {
    for (int step = 0; step < P.newton_steps; ++step) {
      admm::lanes_product(P.Xa, ldq, n_lo, n_hi, q, P.x, ldq, act, nact, smem,
                          FamilyGradient<kFamily>{P});
      grid.sync();
      admm::lanes_product(P.XaT, P.ldn, q_lo, q_hi, n, P.G, P.ldn, act, nact,
                          smem, Gradient{P});
      grid.sync();
      admm::lanes_product(P.Minv, ldq, q_lo, q_hi, q, P.grad, ldq, act, nact,
                          smem, NewtonStep{P});
      // The next step's first product reads every block's B.
      if (step + 1 < P.newton_steps) grid.sync();
    }

    // This block's coordinates of every active lane: masked elastic-net
    // prox, dual ascent and the five sums of squares.  A warp per lane.
    for (int li = warp; li < nact; li += nwarps) {
      const int lane = act[li];
      const float lam_over_rho = P.lam[lane] / rho;
      double s[kGlmSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
      for (int j = q_lo + wlane; j < q_hi; j += admm::kWarp) {
        const size_t at = static_cast<size_t>(lane) * ldq + j;
        const float xn = __ldcg(P.x + at);
        const float yo = __ldcg(P.y + at);
        const float zn = admm::masked_enet_prox(xn + yo / rho, lam_over_rho,
                                                P.mask[j], P.alpha);
        const float dz = zn - __ldcg(P.z + at);
        const float r = xn - zn;
        const float yn = yo + rho * r;
        s[0] += static_cast<double>(dz * dz);  // ||z_new - z||^2: dual
        s[1] += static_cast<double>(r * r);    // ||B - z_new||^2: primal
        s[2] += static_cast<double>(xn * xn);  // next ||x||^2
        s[3] += static_cast<double>(zn * zn);  // next ||z||^2
        s[4] += static_cast<double>(yn * yn);  // next ||y||^2
        P.z[at] = zn;
        P.y[at] = yn;
      }
#pragma unroll
      for (int c = 0; c < kGlmSums; ++c) s[c] = admm::warp_sum(s[c]);
      if (wlane == 0) {
        double* dst = P.partial +
                      (static_cast<size_t>(blockIdx.x) * k + lane) * kGlmSums;
#pragma unroll
        for (int c = 0; c < kGlmSums; ++c) dst[c] = s[c];
      }
    }
    grid.sync();

    // Totals and the Boyd test, alike in every block.
    for (int li = warp; li < nact; li += nwarps) {
      const int lane = act[li];
      double s[kGlmSums];
      admm::grid_totals<kGlmSums>(P.partial + lane * kGlmSums,
                                  static_cast<size_t>(k) * kGlmSums, nblocks,
                                  wlane, s);
      if (wlane == 0) {
        const float eps_pri =
            fmaxf(sqrtf(nx2[lane]), sqrtf(nz2[lane])) * P.eps_rel +
            sqrt_q * P.eps_abs;
        const float eps_dua = sqrtf(ny2[lane]) * P.eps_rel + sqrt_q * P.eps_abs;
        const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
        const float r_pri = sqrtf(static_cast<float>(s[1]));
        lane_done[li] = r_pri < eps_pri && r_dua < eps_dua;
        nx2[lane] = static_cast<float>(s[2]);
        nz2[lane] = static_cast<float>(s[3]);
        ny2[lane] = static_cast<float>(s[4]);
      }
    }
    ++it;
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
  }
  if (blockIdx.x == 0)  // lanes that ran out of iterations
    for (int li = tid; li < nact; li += kThreads) P.niter_out[act[li]] = it;
  const int mine = q_hi - q_lo;
  for (int o = tid; o < mine * k; o += kThreads) {
    const int lane = o / mine, j = q_lo + o % mine;
    P.z_out[static_cast<size_t>(lane) * q + j] =
        __ldcg(P.z + static_cast<size_t>(lane) * ldq + j);
  }
}

template <int kFamily>
cudaError_t launch_glm(GlmParams& P, int blocks, cudaStream_t stream) {
  const size_t smem = admm::kGemmSmemBytes;
  cudaError_t err =
      admm::set_dynamic_smem(glm_batch_path_kernel<kFamily>, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&P};
  // A grid the card cannot hold at once is refused here
  // (cudaErrorCooperativeLaunchTooLarge), not run.
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(glm_batch_path_kernel<kFamily>), dim3(blocks),
      dim3(kThreads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// family: 0 = binomial, 1 = huber (huber_m is its M, unused for binomial).
// Xa (n, ldq), XaT (q, ldn) and Minv (q, ldq) are zero-padded to leading
// dimensions that are multiples of four; `scratch` holds 4 k ldq + k ldn
// floats, all zero; `partial` blocks * k * 5 doubles; k <= 128 lanes.
// Returns the launch's error (0 = launched).
int admm_glm_batch_path(const float* Xa, const float* XaT, const float* Minv,
                        const float* ys, const float* mask, const float* lam,
                        float* scratch, double* partial, float* z_out,
                        int* niter_out, int n, int q, int k, int ldq, int ldn,
                        int blocks, float rho, float eps_abs, float eps_rel,
                        float alpha, int maxit, int family, float huber_m,
                        int newton_steps, void* stream) {
  if (n <= 0 || q <= 0 || k <= 0 || k > admm::kMaxLanes || blocks <= 0 ||
      newton_steps <= 0 || ldq < q || ldn < n || (ldq & 3) || (ldn & 3) ||
      (family != kBinomial && family != kHuber))
    return cudaErrorInvalidValue;
  const size_t kq = static_cast<size_t>(k) * ldq;
  GlmParams P;
  P.Xa = Xa;
  P.XaT = XaT;
  P.Minv = Minv;
  P.ys = ys;
  P.mask = mask;
  P.lam = lam;
  P.x = scratch;
  P.z = scratch + kq;
  P.y = scratch + 2 * kq;
  P.grad = scratch + 3 * kq;
  P.G = scratch + 4 * kq;
  P.partial = partial;
  P.z_out = z_out;
  P.niter_out = niter_out;
  P.n = n;
  P.q = q;
  P.k = k;
  P.ldq = ldq;
  P.ldn = ldn;
  P.rho = rho;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.alpha = alpha;
  P.huber_m = huber_m;
  P.maxit = maxit;
  P.newton_steps = newton_steps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return family == kBinomial ? launch_glm<kBinomial>(P, blocks, s)
                             : launch_glm<kHuber>(P, blocks, s);
}

}  // extern "C"
