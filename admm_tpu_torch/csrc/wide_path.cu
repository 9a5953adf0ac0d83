// Wide Lasso/Elastic-Net lambda path (p >= n): linearized ADMM with an
// adaptive rho, two kernels: all lambdas at once (wide_path_batch_kernel),
// and one lane warm-started over lambda (wide_path_scan_kernel, below).
//
// The batch kernel replaces admm_tpu/ops/wide_path.py::_wide_kernel
// (wide_path_batch_pallas).  The scan kernel replaces no Pallas kernel: the
// JAX package runs the warm-started wide path on its generic engine.
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

// One step of the adaptive-rho ladder (reference: src/ADMMBase.h:85-109):
// x2 / :2 when one scaled residual dominates by 10x, then a 1.2 nudge
// toward whichever residual has converged.  Both kernels hold rho on the
// converging iteration and while it <= rho_start_iter.
__device__ __forceinline__ float rho_ladder(float rho, float r_pri,
                                            float eps_pri, float r_dua,
                                            float eps_dua) {
  const float ratio_p = r_pri / eps_pri;
  const float ratio_d = r_dua / eps_dua;
  float r = ratio_p > 10.0f * ratio_d ? rho * 2.0f : rho;
  r = ratio_d > 10.0f * ratio_p ? r * 0.5f : r;
  r = r_pri < eps_pri ? r / 1.2f : r;
  return r_dua < eps_dua ? r * 1.2f : r;
}

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
        const float rho_a = rho_ladder(rho, r_pri, eps_pri, r_dua, eps_dua);
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

// ---------------------------------------------------------------------------
// Scan: one lane warm-started over lambda, on a cooperative grid.
//
// What it computes is models/lasso.py::_solve_path_wide on the engine
// (_scan_path, warm_start, make_admm_solver over _wide_ops with the rho
// ladder): for each lambda in order, keep x, z, y and rho, reset the
// iteration count, and run the iteration above until the Boyd test passes
// or maxit; the lambda's x and niter are written out.
//
// Why a kernel of its own.  Run at k = 1 the batch kernel pays three grid
// syncs an iteration, streams X and X' from L2 twice an iteration and
// starts every lambda cold; on the engine an iteration is ~99 small
// launches (~190 us an iteration at 1000 x 2000; NVIDIA H100 80GB HBM3,
// 700 W).  With one lane nothing is shared between lanes, and the work of
// an iteration (4np operations, 8 MFLOP at 1000 x 2000) is a few hundred
// nanoseconds of the card: what bounds it is the grid syncs and the
// latency of each exchange through L2.  So:
//   * one persistent cooperative grid, one block per SM, one launch per
//     path: every lambda runs inside the kernel;
//   * X is read from device memory once a call, never per iteration: block
//     b holds two slices of it in shared memory, its rows (row_tile of n:
//     rows_max x ldp floats, 8 x 2000 at 1000 x 2000 on 132 SMs, 64 KB) and
//     its columns (row_tile of p, stored column by column: cols_max x ldn
//     floats, 16 x 1000, 64 KB), beside a full copy of the lane's x (as
//     float64), Ax, z, y and the gradient's left factor tmp = Ax + z + y/rho
//     (as float64);
//   * grad = tmp X on its columns needs all of tmp, which every block
//     holds; the x-update follows there, and the block writes its
//     coordinates of the new x to global scratch.  Grid sync 1.
//   * every block reads all of x (8 KB); Ax = X x on its rows, then z and y
//     there, and the five sums of squares of its rows; it writes its rows
//     of Ax, z and y and its five partial sums.  Grid sync 2.
//   * every block reads all of Ax, z and y (12 KB) and every block's
//     partials, adds the partials by one fixed tree, reaches the same
//     totals, stopping decision and rho step, and forms tmp for all n with
//     the new rho itself: the batch kernel's third sync is not needed.
// Two grid syncs an iteration.  Single buffers suffice: what is written
// between sync 1 and sync 2 is read after sync 2 and written again only
// after the next sync 1, and x is written only after sync 2 of the
// iteration that read it.  Products and squared norms accumulate in
// float64 and round once; no atomics: two launches give the same bits.
//
// What bounds it on this card: the two grid syncs and the two exchanges'
// L2 latency an iteration, then the float32 -> float64 conversion of each
// element of X (2np a path iteration over the grid, 16 a clock an SM).
// The slices need rows_max * pad4(p) + cols_max * pad4(n) floats of shared
// memory, so shapes whose slices and state do not fit one block's 227 KB at
// the card's block count take the engine (kernels/wide_path.py::scan_fits:
// up to p = 2944 at n = 1000 on 132 SMs).
// ---------------------------------------------------------------------------
constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / admm::kWarp;

struct ScanParams {
  const float* X;    // (n, p) row-major
  const float* ys;   // (n,)
  const float* lam;  // (k,)
  float* xg;         // (ldp,) the new x, exchanged; zero at launch
  float* rowsg;      // (3, ldn) the new Ax, z and y, exchanged; zero at launch
  double* partial;   // (kWideSums, blocks) the blocks' sums of squares
  float* x_out;      // (k, p)
  int* niter_out;    // (k,)
  int n, p, k, ldp, ldn, rows_max, cols_max, part_len;
  float rho0, sprad, lambda0, eps_abs, eps_rel, alpha;
  int maxit, rho_start_iter;
};

// Dynamic shared memory of a block (kernels/wide_path.py::scan_launch_plan
// repeats it): x and tmp as float64, the row and column slices, Ax, z and
// y, the products' segment sums and the rows' sums of squares.
inline size_t scan_smem_bytes(int ldp, int ldn, int rows_max, int cols_max,
                              int part_len) {
  return sizeof(double) * (static_cast<size_t>(ldp) + ldn) +
         sizeof(float) * (static_cast<size_t>(rows_max) * ldp +
                          static_cast<size_t>(cols_max) * ldn +
                          3 * static_cast<size_t>(ldn)) +
         sizeof(double) * (static_cast<size_t>(part_len) +
                           static_cast<size_t>(kWideSums) * rows_max);
}

// out[r] = sum_i M[r, i] v[i] for the d rows of a slice in shared memory
// (row stride ldm floats, a multiple of four, zero past the depth) against
// a float64 vector in shared memory (zero past the depth): exact products
// summed in float64, rounded once.  The block's warps take pairs of rows
// times S segments of the depth (one load of v serves both rows of a
// pair), each reduces its sums by shuffles, and thread r then adds row r's
// S segment sums in segment order: the same bits every run.  epi(r, sum)
// receives each row's sum rounded to float32.  `part` holds
// max(2 kScanWarps, d) doubles.  Ends with the block synchronised.
template <typename Epilogue>
__device__ __forceinline__ void slice_dots(const float* M, int ldm, int d,
                                           const double* v, double* part,
                                           Epilogue epi) {
  const int tid = threadIdx.x;
  const int warp = tid / admm::kWarp, wlane = tid % admm::kWarp;
  const int pairs = (d + 1) / 2;
  int S = 1;
  while (pairs > 0 && 2 * S * pairs <= kScanWarps) S *= 2;
  const int m4 = ldm / 4;
  const double2* v2 = reinterpret_cast<const double2*>(v);
  for (int t = warp; t < pairs * S; t += kScanWarps) {
    const int r0 = 2 * (t / S), s = t % S;
    const bool two = r0 + 1 < d;  // the same in the whole warp
    const int lo = m4 * s / S, hi = m4 * (s + 1) / S;
    const float4* a4 = reinterpret_cast<const float4*>(M) +
                       static_cast<size_t>(r0) * m4;
    const float4* b4 = a4 + m4;
    double a0 = 0.0, a1 = 0.0, b0 = 0.0, b1 = 0.0;
    for (int q = lo + wlane; q < hi; q += admm::kWarp) {
      const double2 v0 = v2[2 * q], v1 = v2[2 * q + 1];
      const float4 xa = a4[q];
      a0 = fma(static_cast<double>(xa.x), v0.x, a0);
      a1 = fma(static_cast<double>(xa.y), v0.y, a1);
      a0 = fma(static_cast<double>(xa.z), v1.x, a0);
      a1 = fma(static_cast<double>(xa.w), v1.y, a1);
      if (two) {
        const float4 xb = b4[q];
        b0 = fma(static_cast<double>(xb.x), v0.x, b0);
        b1 = fma(static_cast<double>(xb.y), v0.y, b1);
        b0 = fma(static_cast<double>(xb.z), v1.x, b0);
        b1 = fma(static_cast<double>(xb.w), v1.y, b1);
      }
    }
    const double sa = admm::warp_sum(a0 + a1);
    const double sb = admm::warp_sum(b0 + b1);
    if (wlane == 0) {
      part[r0 * S + s] = sa;
      if (two) part[(r0 + 1) * S + s] = sb;
    }
  }
  __syncthreads();
  for (int r = tid; r < d; r += kScanThreads) {
    double sum = 0.0;
    for (int s = 0; s < S; ++s) sum += part[r * S + s];
    epi(r, static_cast<float>(sum));
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kScanThreads, 1)
wide_path_scan_kernel(const __grid_constant__ ScanParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) double wide_scan_smem[];
  __shared__ double red[(admm::kWarp + 1) * kWideSums];
  const int n = P.n, p = P.p, ldp = P.ldp, ldn = P.ldn;
  const int tid = threadIdx.x;
  const int nblocks = gridDim.x, blk = blockIdx.x;
  double* x64 = wide_scan_smem;                       // ldp
  double* tmp64 = x64 + ldp;                          // ldn
  float* Xr = reinterpret_cast<float*>(tmp64 + ldn);  // rows_max x ldp
  float* Xc = Xr + static_cast<size_t>(P.rows_max) * ldp;  // cols_max x ldn
  float* ax = Xc + static_cast<size_t>(P.cols_max) * ldn;  // then z, y
  float* z = ax + ldn;
  float* y = z + ldn;
  double* part = reinterpret_cast<double*>(y + ldn);  // part_len
  double* sq = part + P.part_len;                     // rows_max x 5
  int r_lo, r_hi, c_lo, c_hi;  // this block's rows of X, and its columns
  admm::row_tile(n, blk, nblocks, &r_lo, &r_hi);
  admm::row_tile(p, blk, nblocks, &c_lo, &c_hi);
  const int nrows = r_hi - r_lo, ncols = c_hi - c_lo;

  // X from device memory, once: the block's rows, and its columns stored
  // column by column; zero past the depth.  The lane starts at 0.
  for (int o = tid; o < nrows * ldp; o += kScanThreads) {
    const int r = o / ldp, j = o % ldp;
    Xr[o] = j < p ? P.X[static_cast<size_t>(r_lo + r) * p + j] : 0.0f;
  }
  for (int o = tid; o < ldn * ncols; o += kScanThreads) {
    const int i = o / ncols, c = o % ncols;
    Xc[static_cast<size_t>(c) * ldn + i] =
        i < n ? P.X[static_cast<size_t>(i) * p + c_lo + c] : 0.0f;
  }
  for (int j = tid; j < ldp; j += kScanThreads) x64[j] = 0.0;
  for (int i = tid; i < ldn; i += kScanThreads) {
    tmp64[i] = 0.0;
    ax[i] = z[i] = y[i] = 0.0f;
  }
  __syncthreads();

  const float sqrt_n = sqrtf(static_cast<float>(n));
  const float sqrt_p = sqrtf(static_cast<float>(p));
  const float sqrt_sprad = sqrtf(P.sprad);
  float rho = P.rho0;
  float nax2 = 0.0f, nz2 = 0.0f, ny2 = 0.0f;  // pre-update squared norms
  const float4* xg4 = reinterpret_cast<const float4*>(P.xg);
  const float4* rows4 = reinterpret_cast<const float4*>(P.rowsg);
  float4* axzy4 = reinterpret_cast<float4*>(ax);  // ax, z, y: 3 ldn floats

  // Every exit of a loop comes from the grid's totals, the same in every
  // thread of the grid: all reach every grid sync the same number of times.
  for (int kk = 0; kk < P.k; ++kk) {
    const float lam = P.lam[kk];
    // float32(1 - 1e-5), the factor the plain form multiplies by.
    const bool zero_exit = lam > P.lambda0 * 0.99999f;
    int it = 0;
    while (it < P.maxit) {
      const float eps_pri =
          fmaxf(sqrtf(nax2), sqrtf(nz2)) * P.eps_rel + sqrt_n * P.eps_abs;
      const float eps_dua =
          sqrt_sprad * sqrtf(ny2) * P.eps_rel + sqrt_p * P.eps_abs;
      const float pen = lam / (rho * P.sprad);

      // grad = tmp X on this block's columns, and the x-update there.
      slice_dots(Xc, ldn, ncols, tmp64, part, [&](int c, float g) {
        const int j = c_lo + c;
        const float v = static_cast<float>(x64[j]) - g / P.sprad;
        P.xg[j] = zero_exit ? 0.0f : admm::enet_prox(v, pen, P.alpha);
      });
      grid.sync();

      // All of the new x (written by other blocks: read through L2).
      for (int q = tid; q < ldp / 4; q += kScanThreads) {
        const float4 v = __ldcg(xg4 + q);
        x64[4 * q] = v.x;
        x64[4 * q + 1] = v.y;
        x64[4 * q + 2] = v.z;
        x64[4 * q + 3] = v.w;
      }
      __syncthreads();

      // Ax = X x on this block's rows, then z, y and the sums of squares
      // there.
      slice_dots(Xr, ldp, nrows, x64, part, [&](int r, float acc) {
        const int i = r_lo + r;
        const float yo = y[i];
        const float zn = -(__ldg(P.ys + i) + yo + rho * acc) / (1.0f + rho);
        const float res = acc + zn;
        const float yn = yo + rho * res;
        const float dz = zn - z[i];
        double* s = sq + r * kWideSums;
        s[0] = static_cast<double>(dz * dz);    // ||z_new - z||^2: dual
        s[1] = static_cast<double>(res * res);  // ||Ax + z_new||^2: primal
        s[2] = static_cast<double>(acc * acc);  // next ||Ax||^2
        s[3] = static_cast<double>(zn * zn);    // next ||z||^2
        s[4] = static_cast<double>(yn * yn);    // next ||y||^2
        P.rowsg[i] = acc;
        P.rowsg[ldn + i] = zn;
        P.rowsg[2 * ldn + i] = yn;
      });
      if (tid < kWideSums) {  // the block's sums: its rows in order
        double t = 0.0;
        for (int r = 0; r < nrows; ++r) t += sq[r * kWideSums + tid];
        P.partial[tid * nblocks + blk] = t;
      }
      grid.sync();

      // Thread b takes block b's sums (the grid is at most kScanThreads
      // blocks; one coalesced load per sum), the block adds them by a fixed
      // tree; meanwhile every block copies all of Ax, z and y.
      double s[kWideSums];
#pragma unroll
      for (int c = 0; c < kWideSums; ++c)
        s[c] = tid < nblocks ? __ldcg(P.partial + c * nblocks + tid) : 0.0;
      for (int q = tid; q < 3 * ldn / 4; q += kScanThreads)
        axzy4[q] = __ldcg(rows4 + q);
      admm::block_sum<kWideSums>(s, red);

      // The Boyd test and the rho ladder, alike in every thread.
      const float r_dua = rho * sqrt_sprad * sqrtf(static_cast<float>(s[0]));
      const float r_pri = sqrtf(static_cast<float>(s[1]));
      const bool done = r_pri < eps_pri && r_dua < eps_dua;
      if (!(done || it <= P.rho_start_iter))
        rho = rho_ladder(rho, r_pri, eps_pri, r_dua, eps_dua);
      nax2 = static_cast<float>(s[2]);
      nz2 = static_cast<float>(s[3]);
      ny2 = static_cast<float>(s[4]);
      ++it;

      // The next gradient's left factor, with the rho just set, on every
      // row (block_sum's barriers made the copies above visible).
      for (int i = tid; i < n; i += kScanThreads)
        tmp64[i] = static_cast<double>(ax[i] + z[i] + y[i] / rho);
      __syncthreads();
      if (done) break;
    }
    for (int j = c_lo + tid; j < c_hi; j += kScanThreads)
      P.x_out[static_cast<size_t>(kk) * p + j] = static_cast<float>(x64[j]);
    if (blk == 0 && tid == 0) P.niter_out[kk] = it;
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


// X is (n, p) row-major and unpadded; `xg` holds ldp floats and `rowsg`
// 3 ldn, both zero; `partial` 5 * blocks doubles; ldp and ldn are p and n
// padded to multiples of four; rows_max and cols_max the most rows of X and
// columns any block owns (kernels/wide_path.py::scan_launch_plan);
// blocks <= 512.  Returns the launch's error (0 = launched); shared memory
// past one block's, or a grid the card cannot hold at once
// (cudaErrorCooperativeLaunchTooLarge), is refused, not run.
int admm_wide_path_scan(const float* X, const float* ys, const float* lam,
                        float* xg, float* rowsg, double* partial,
                        float* x_out, int* niter_out, int n, int p, int k,
                        int ldp, int ldn, int rows_max, int cols_max,
                        int blocks, float rho, float sprad, float lambda0,
                        float eps_abs, float eps_rel, float alpha, int maxit,
                        int rho_start_iter, void* stream) {
  if (n <= 0 || p <= 0 || k <= 0 || blocks <= 0 || blocks > kScanThreads ||
      ldp < p || ldn < n || (ldp & 3) || (ldn & 3) ||
      static_cast<long long>(rows_max) * blocks < n ||
      static_cast<long long>(cols_max) * blocks < p)
    return cudaErrorInvalidValue;
  const int part_len = rows_max > cols_max ? rows_max : cols_max;
  ScanParams P;
  P.X = X;
  P.ys = ys;
  P.lam = lam;
  P.xg = xg;
  P.rowsg = rowsg;
  P.partial = partial;
  P.x_out = x_out;
  P.niter_out = niter_out;
  P.n = n;
  P.p = p;
  P.k = k;
  P.ldp = ldp;
  P.ldn = ldn;
  P.rows_max = rows_max;
  P.cols_max = cols_max;
  P.part_len = part_len > 2 * kScanWarps ? part_len : 2 * kScanWarps;
  P.rho0 = rho;
  P.sprad = sprad;
  P.lambda0 = lambda0;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.alpha = alpha;
  P.maxit = maxit;
  P.rho_start_iter = rho_start_iter;
  const size_t smem =
      scan_smem_bytes(ldp, ldn, rows_max, cols_max, P.part_len);
  if (smem > admm::kMaxDynamicSmem) return cudaErrorInvalidValue;
  cudaError_t err = admm::set_dynamic_smem(wide_path_scan_kernel, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(wide_path_scan_kernel), dim3(blocks),
      dim3(kScanThreads), args, smem, static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
