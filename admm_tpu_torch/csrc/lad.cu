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
// What bounds it on this card: reading H once per iteration, n^2 * 4
// bytes, from L2 (n = 1000: 4 MB) or from device memory (n = 5000:
// 100 MB, past the 50 MB L2: 30 us at 3.35 TB/s), and, at n = 1000, the
// latency of the one grid sync and the L2 round trips of an iteration.
//
// Design.  One lane, one persistent cooperative grid of one block per SM,
// ONE grid-wide sync per iteration.
//   * Block b owns a contiguous range of H's rows (row_tile), which is one
//     contiguous stretch of memory (rows padded to a multiple of four
//     floats by the wrapper).  A producer warp streams that stretch
//     through a ring of stages in shared memory with Hopper's 1-D bulk
//     async copies (cp.async.bulk ... mbarrier::complete_tx::bytes; one
//     stage holds one segment of a row, each stage has a `full` and an
//     `empty` mbarrier).  H does not change between iterations, so the
//     producer runs ahead across the grid sync: while the grid syncs and
//     adds its totals, the next iteration's first stages are already in
//     flight (at n = 1000 the block's whole share of H, 32 KB, sits in the
//     ring before the iteration starts).  The ring takes what the state
//     leaves of the shared memory, a multiple of 8 stages: 107 KB in
//     flight at n = 5000, 8 stages of 3.8 KB at n = 9600.
//   * Eight consumer warps: ring slot s goes to warp s % 8, so the warps
//     read different stages at once; a warp converts each element to
//     float64 once, multiplies by the float64 right factor v held in
//     shared memory and reduces its lanes by shuffles into the segment's
//     sum; a row's x is its segments' sums added in order.  (All eight
//     warps splitting each stage paid a wait and a reduction per stage in
//     every warp: 8.6 and 48.9 us per iteration at n = 1000 and 5000 on an
//     NVIDIA H100 80GB HBM3, 700 W.)
//   * Every block holds full copies of z, y, ys (float32) and v (float64),
//     and adj_z, adj_y only at its own rows: the refresh after the grid
//     sync forms each v[j] from z_new, y_new (exchanged through device
//     memory) and the old z, y, the momentum step it takes alike in every
//     block.  About 5n floats of state: 100 KB at n = 5000, 192 KB at
//     n = 9600.
//   * Per iteration: the product, a barrier; the elementwise stage of the
//     block's rows, whose six sums of squares are added over a warp by
//     shuffles and over the warps in warp order behind one barrier and
//     written sum-major (partial[k * grid + b]); the grid sync; thread b
//     loads block b's six sums, one block reduction gives every block the
//     same totals and decisions; the refresh, a closing barrier.  Four
//     block barriers and one grid sync, as in the tall scan kernel.  The
//     consumers' own barriers are named barriers of their 256 threads, so
//     the producer warp meets them only at the grid sync and the closing
//     barrier.
// The exchange buffers and the partial sums are double-buffered on the
// iteration's parity: a block that runs ahead writes iteration t+1's values
// while a slower one still reads iteration t's, and cannot get further
// before the next sync.  Products are exact in float64 and rounded once to
// float32; every sum is added in a fixed order (no atomics): two launches
// give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "admm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * admm::kWarp;  // 256
constexpr int kThreads = kConsumers + admm::kWarp;        // + the producer
constexpr int kLadSums = 6;
constexpr int kMaxStages = 64;
constexpr int kRefresh = 8;  // coordinates a thread refreshes per round

struct LadParams {
  const float* hat;    // (n, ld) row-major, zero beyond column n
  const float* ys;     // (n,)
  const float* ynorm;  // ||ys||, one float in device memory
  float* znew;         // (2, n) z_new by iteration parity
  float* ynew;         // (2, n) y_new by iteration parity
  double* partial;     // (2, kLadSums, grid) per-block sums by parity
  float* adjy_out;
  float* adjz_out;
  int* niter_out;
  int n, ld, seg, stages, maxit;
  float rho, eps_abs, eps_rel, restart_tol;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of `bar` with this parity has completed.  A wait
// that outlasts some 2^35 clocks (about 20 s) can only be a fault: it traps,
// which ends the launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// One bulk async copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory; its arrival completes
// the transaction count of `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The consumer warps' own block barrier (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
lad_solve_kernel(const __grid_constant__ LadParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full_bar[kMaxStages];
  __shared__ uint64_t empty_bar[kMaxStages];
  __shared__ double wsum[kConsumerWarps * kLadSums];
  __shared__ int s_done;

  const int n = P.n, ld = P.ld, seg = P.seg, S = P.stages;
  const int nblocks = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / admm::kWarp, wlane = tid % admm::kWarp;
  int lo, hi;  // this block's rows
  admm::row_tile(n, blockIdx.x, nblocks, &lo, &hi);
  const int rows = hi - lo;
  const int rows_max = (n + nblocks - 1) / nblocks;
  const int nseg = (ld + seg - 1) / seg;  // segments per row
  const int Q = rows * nseg;              // stages per iteration

  // Shared memory: the ring, then v (ld doubles), the sums of this block's
  // segments (float64), z, y, ys (n floats each, padded to four) and
  // adj_z, adj_y at this block's rows.
  float* ring = reinterpret_cast<float*>(smem_raw);
  double* v64 = reinterpret_cast<double*>(ring + static_cast<size_t>(S) * seg);
  double* seg_sum = v64 + ld;  // each segment's sum, float64
  float* z = reinterpret_cast<float*>(seg_sum + rows_max * nseg);
  const int n4 = (n + 3) / 4 * 4;
  float* y = z + n4;
  float* ys = y + n4;
  float* adj_z = ys + n4;
  float* adj_y = adj_z + (rows_max + 3) / 4 * 4;

  const float rho = P.rho;
  if (tid < kConsumers) {
    for (int j = tid; j < ld; j += kConsumers) {
      float yj = 0.0f;
      if (j < n) {
        yj = P.ys[j];
        ys[j] = yj;
        z[j] = 0.0f;
        y[j] = 0.0f;
      }
      // The cold start's right factor, ys - 0 / rho + 0 (0 in the padding).
      v64[j] = static_cast<double>(yj - 0.0f / rho + 0.0f);
    }
    for (int j = tid; j < rows; j += kConsumers) adj_z[j] = adj_y[j] = 0.0f;
  } else if (tid == kConsumers) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- The producer warp: lane 0 starts the copies. ------------------
    // Stage c (counted over the whole solve) holds segment c % Q of this
    // block's stretch.  Before the grid sync of iteration `it` it starts
    // every stage up to (it + 1) Q + S - 1: stage c waits for stage c - S
    // to be read, which the consumers do during iteration `it`, so the
    // wait never needs the sync.
    const long long total = static_cast<long long>(P.maxit) * Q;
    long long started = 0;
    int s = 0, q = 0;     // stage index and segment of the next copy
    uint32_t phase = 0;   // its use of the stage: even or odd
    bool wrapped = false;  // the ring has been filled once
    int it = 0;
    while (it < P.maxit) {
      if (wlane == 0) {
        long long limit = static_cast<long long>(it + 1) * Q + S;
        if (limit > total) limit = total;
        for (; started < limit; ++started) {
          // The stage's last use must have been read by every consumer
          // warp.
          if (wrapped) mbar_wait(&empty_bar[s], phase ^ 1u);
          const int row = lo + q / nseg, col0 = (q % nseg) * seg;
          const int len = min(seg, ld - col0);
          mbar_arrive_expect_tx(&full_bar[s], 4u * len);
          bulk_load(ring + static_cast<size_t>(s) * seg,
                    P.hat + static_cast<size_t>(row) * ld + col0, 4u * len,
                    &full_bar[s]);
          if (++q == Q) q = 0;
          if (++s == S) {
            s = 0;
            phase ^= 1u;
            wrapped = true;
          }
        }
      }
      __syncwarp();
      grid.sync();
      ++it;
      __syncthreads();  // the consumers' closing barrier: s_done is set
      if (s_done) break;
    }
    // Copies still in flight must land before the block's shared memory
    // is released.
    if (wlane == 0) {
      for (long long c = static_cast<long long>(it) * Q; c < started; ++c)
        mbar_wait(&full_bar[c % S], static_cast<uint32_t>((c / S) & 1));
    }
    return;
  }

  // ---- The consumer warps. ----------------------------------------------
  const float ynorm = __ldg(P.ynorm);
  const float sqrt_n = sqrtf(static_cast<float>(n));
  const float pen = 1.0f / rho;
  float nx2 = 0.0f, nz2 = 0.0f, ny2 = 0.0f;  // pre-update squared norms
  admm::Momentum mom;
  mom.a = 1.0f;
  mom.c = 9999.0f;
  const double2* v2 = reinterpret_cast<const double2*>(v64);
  int cs = 0;          // the stage the next segment arrives in
  uint32_t cphase = 0;  // and the parity of its use

  int it = 0;
  while (it < P.maxit) {
    const float eps_pri =
        fmaxf(fmaxf(sqrtf(nx2), sqrtf(nz2)), ynorm) * P.eps_rel +
        sqrt_n * P.eps_abs;
    const float eps_dua = sqrtf(ny2) * P.eps_rel + sqrt_n * P.eps_abs;
    const int par = it & 1;
    float* znew = P.znew + static_cast<size_t>(par) * n;
    float* ynew = P.ynew + static_cast<size_t>(par) * n;
    double* partial = P.partial + static_cast<size_t>(par) * kLadSums * nblocks;

    // The product: x[row] = sum_i H[row, i] v[i] over this block's rows.
    // Ring slot s is always read by consumer warp s % 8 (the ring has a
    // multiple of 8 slots), which reduces its lanes by shuffles into
    // seg_sum[q]: the warps work on different stages at once.  A warp then
    // waits on a slot's full barrier only after it has read the slot's
    // previous use itself, so the barrier is never two phases behind the
    // parity it waits for.  Every warp steps through every slot and phase
    // to keep its count of the ring.
    for (int q = 0, sg = 0; q < Q; ++q) {
      if (cs % kConsumerWarps == warp) {
        const int col0 = sg * seg;
        const int len4 = min(seg, ld - col0) / 4;
        mbar_wait(&full_bar[cs], cphase);
        const float4* h4 = reinterpret_cast<const float4*>(
            ring + static_cast<size_t>(cs) * seg);
        const double2* vv = v2 + col0 / 2;
        double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
#pragma unroll 4
        for (int i = wlane; i < len4; i += admm::kWarp) {
          const float4 h = h4[i];
          const double2 v01 = vv[2 * i], v23 = vv[2 * i + 1];
          a0 = fma(static_cast<double>(h.x), v01.x, a0);
          a1 = fma(static_cast<double>(h.y), v01.y, a1);
          a2 = fma(static_cast<double>(h.z), v23.x, a2);
          a3 = fma(static_cast<double>(h.w), v23.y, a3);
        }
        __syncwarp();
        if (wlane == 0) mbar_arrive(&empty_bar[cs]);
        const double d = admm::warp_sum((a0 + a1) + (a2 + a3));
        if (wlane == 0) seg_sum[q] = d;
      }
      if (++cs == S) {
        cs = 0;
        cphase ^= 1u;
      }
      if (++sg == nseg) sg = 0;
    }
    consumers_sync();

    // The elementwise stage of this block's rows.
    double s[kLadSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int r = tid; r < rows; r += kConsumers) {
      double dot = 0.0;  // the row's segments, in order
      for (int k = 0; k < nseg; ++k) dot += seg_sum[r * nseg + k];
      const int j = lo + r;
      const float xn = static_cast<float>(dot);
      const float ay = adj_y[r];
      const float d = xn - ys[j];
      const float zn = admm::soft_threshold(d + ay / rho, pen);
      const float res = d - zn;
      const float y_new = ay + rho * res;
      const float dz = zn - z[j];
      const float ez = zn - adj_z[r];
      s[0] += static_cast<double>(dz * dz);    // ||z_new - z||^2: dual
      s[1] += static_cast<double>(res * res);  // ||x - ys - z_new||^2: primal
      s[2] += static_cast<double>(ez * ez);    // ||z_new - adj_z||^2
      s[3] += static_cast<double>(xn * xn);    // next iteration's ||x||^2
      s[4] += static_cast<double>(zn * zn);    // next iteration's ||z||^2
      s[5] += static_cast<double>(y_new * y_new);  // next ||y||^2
      znew[j] = zn;
      ynew[j] = y_new;
    }
    // The block's sums: the warps' in warp order.
#pragma unroll
    for (int k = 0; k < kLadSums; ++k) s[k] = admm::warp_sum(s[k]);
    if (wlane == 0) {
#pragma unroll
      for (int k = 0; k < kLadSums; ++k) wsum[warp * kLadSums + k] = s[k];
    }
    consumers_sync();
    if (tid < kLadSums) {
      double t = 0.0;
      for (int w = 0; w < kConsumerWarps; ++w) t += wsum[w * kLadSums + tid];
      partial[tid * nblocks + blockIdx.x] = t;
    }
    grid.sync();

    // Thread b takes block b's sums (the grid is at most 256 blocks; one
    // coalesced load per sum) and the block adds them by a fixed tree:
    // the totals, and every decision below, are the same in every block.
#pragma unroll
    for (int k = 0; k < kLadSums; ++k) {
      const double v =
          tid < nblocks ? __ldcg(partial + k * nblocks + tid) : 0.0;
      s[k] = admm::warp_sum(v);
    }
    if (wlane == 0) {
#pragma unroll
      for (int k = 0; k < kLadSums; ++k) wsum[warp * kLadSums + k] = s[k];
    }
    consumers_sync();
#pragma unroll
    for (int k = 0; k < kLadSums; ++k) {
      double t = 0.0;
      for (int w = 0; w < kConsumerWarps; ++w) t += wsum[w * kLadSums + k];
      s[k] = t;
    }

    const float r_dua = rho * sqrtf(static_cast<float>(s[0]));
    const float r_pri = sqrtf(static_cast<float>(s[1]));
    const bool done = r_pri < eps_pri && r_dua < eps_dua;
    const admm::MomentumStep m = admm::fadmm_momentum(
        mom, rho, r_pri, static_cast<float>(s[2]), P.restart_tol);
    // The refresh, and the next right factor in the same pass.  adj_z and
    // adj_y are formed on the fly for every coordinate and kept only at
    // this block's rows.  A thread's z_new and y_new are loaded kRefresh
    // coordinates at a time, all in flight before the first is used: one
    // L2 round trip per kRefresh coordinates, not per coordinate.
    for (int j0 = tid; j0 < n; j0 += kRefresh * kConsumers) {
      float zb[kRefresh], yb[kRefresh];
#pragma unroll
      for (int u = 0; u < kRefresh; ++u) {
        const int j = j0 + u * kConsumers;
        // Written by other blocks: read through L2, not this SM's L1.
        zb[u] = j < n ? __ldcg(znew + j) : 0.0f;
        yb[u] = j < n ? __ldcg(ynew + j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kRefresh; ++u) {
        const int j = j0 + u * kConsumers;
        if (j >= n) break;
        const float zn = zb[u], y_new = yb[u];
        if (!done) {
          const float az =
              m.accel ? (1.0f + m.ratio) * zn - m.ratio * z[j] : z[j];
          const float ay =
              m.accel ? (1.0f + m.ratio) * y_new - m.ratio * y[j] : y[j];
          v64[j] = static_cast<double>(ys[j] - ay / rho + az);
          if (j >= lo && j < hi) {
            adj_z[j - lo] = az;
            adj_y[j - lo] = ay;
          }
        }
        z[j] = zn;
        y[j] = y_new;
      }
    }
    if (!done) {
      mom.a = m.a_new;
      mom.c = m.c_new;
    }
    nx2 = static_cast<float>(s[3]);
    nz2 = static_cast<float>(s[4]);
    ny2 = static_cast<float>(s[5]);
    ++it;
    if (tid == 0) s_done = done;
    __syncthreads();  // with the producer
    if (done) break;
  }
  for (int r = tid; r < rows; r += kConsumers) {
    P.adjy_out[lo + r] = adj_y[r];
    P.adjz_out[lo + r] = adj_z[r];
  }
  if (blockIdx.x == 0 && tid == 0) P.niter_out[0] = it;
}

// The dynamic shared memory of one block (kernels/lad.py::launch_plan
// reckons the same): the ring, v, the sums of the block's segments, z, y,
// ys and the block's adj_z, adj_y.
long long smem_bytes(int n, int ld, int grid, int seg, int stages) {
  const long long rows_max = (n + grid - 1) / grid;
  const long long nseg = (ld + seg - 1) / seg;
  const long long n4 = (n + 3) / 4 * 4, r4 = (rows_max + 3) / 4 * 4;
  return 4LL * stages * seg + 8LL * ld + 8LL * rows_max * nseg +
         4LL * (3 * n4 + 2 * r4);
}

}  // namespace

extern "C" {

// hat is (n, ld) with ld a multiple of four and the padding zero; `ynorm`
// one float in device memory; `znew` and `ynew` (2, n) floats and `partial`
// (2, 6, grid) doubles of scratch, none of which needs initialising; grid,
// seg (floats per stage, a multiple of four) and stages come from
// kernels/lad.py::launch_plan.  Returns the launch's error (0 = launched);
// a grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge), not run.
int admm_lad_solve(const float* hat, const float* ys, const float* ynorm,
                   float* znew, float* ynew, double* partial,
                   float* adjy_out, float* adjz_out, int* niter_out, int n,
                   int ld, int grid, int seg, int stages, float rho,
                   float eps_abs, float eps_rel, int maxit,
                   float restart_tol, void* stream) {
  if (n <= 0 || ld < n || (ld & 3) || grid <= 0 || grid > kConsumers ||
      grid > n || seg <= 0 || (seg & 3) || stages < kConsumerWarps ||
      stages % kConsumerWarps || stages > kMaxStages)
    return cudaErrorInvalidValue;
  const long long smem = smem_bytes(n, ld, grid, seg, stages);
  if (smem > admm::kMaxDynamicSmem) return cudaErrorInvalidValue;
  cudaError_t err = admm::set_dynamic_smem(lad_solve_kernel,
                                           static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  LadParams P;
  P.hat = hat;
  P.ys = ys;
  P.ynorm = ynorm;
  P.znew = znew;
  P.ynew = ynew;
  P.partial = partial;
  P.adjy_out = adjy_out;
  P.adjz_out = adjz_out;
  P.niter_out = niter_out;
  P.n = n;
  P.ld = ld;
  P.seg = seg;
  P.stages = stages;
  P.maxit = maxit;
  P.rho = rho;
  P.eps_abs = eps_abs;
  P.eps_rel = eps_rel;
  P.restart_tol = restart_tol;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(lad_solve_kernel), dim3(grid), dim3(kThreads),
      args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
