// Device helpers shared by the path kernels: the proximal operators, the
// GLM families' gradients, the FADMM momentum/restart rule, a block-wide
// sum of a few scalars, and the tall-skinny product of a matrix tile with
// every active lane's vector (lanes_product) that the GLM, BP and the wide
// and tall batch Lasso kernels are built on.
//
// Counterparts of admm_tpu/ops/_common.py (soft_threshold, enet_prox,
// fadmm_momentum), of the prox and family gradients inside
// admm_tpu/ops/glm_kernel.py, and of their plain PyTorch forms in
// admm_tpu_torch/kernels/_common.py.  Written once here so that the
// kernels cannot diverge.
//
// Arithmetic.  Elementwise work is IEEE float32, one rounding per
// operation in the order the plain forms write it (the build passes
// -fmad=false and no fast-math).  Products and squared norms accumulate in
// float64 and round once to float32, here and in the plain forms alike.
// The two then agree to the last bit nearly everywhere, so the Boyd test
// and the restart test, which compare residuals near a threshold, decide
// the same way in both: with float32 sums in different orders they do not,
// and niter and the stopping points drift apart.
#pragma once

#include <cuda_runtime.h>

namespace admm {

// sign(v) * max(|v| - pen, 0)
__device__ __forceinline__ float soft_threshold(float v, float pen) {
  const float m = fmaxf(fabsf(v) - pen, 0.0f);
  return v > 0.0f ? m : (v < 0.0f ? -m : 0.0f);
}

// Elastic-net prox (reference: src/ADMMEnet.h:24-40); alpha = 1 is the
// soft-threshold.
__device__ __forceinline__ float enet_prox(float v, float pen, float alpha) {
  // (1 - alpha) in float32 from the float32 alpha, as the plain forms do.
  const float denom = 1.0f + pen * (1.0f - alpha);
  return soft_threshold(v, alpha * pen) / denom;
}

// Elastic-net prox with a per-coordinate penalty lam/rho * mask (mask 0 on
// the unpenalized intercept).
__device__ __forceinline__ float masked_enet_prox(float v, float lam_over_rho,
                                                  float mask, float alpha) {
  return enet_prox(v, lam_over_rho * mask, alpha);
}

// dloss/deta of the logistic loss, sigmoid(eta) - y, with the sigmoid as
// torch.sigmoid computes it in float32: 1 / (1 + expf(-eta)).  At
// eta << 0 expf overflows to inf and the quotient is 0, which is right.
__device__ __forceinline__ float binomial_grad_eta(float eta, float y) {
  return 1.0f / (1.0f + expf(-eta)) - y;
}

// dloss/deta of the Huber loss in r = y - eta: -clip(r, -M, M).
__device__ __forceinline__ float huber_grad_eta(float eta, float y, float M) {
  return -fminf(fmaxf(y - eta, -M), M);
}

// The scalar half of one FADMM momentum/restart step (reference:
// src/FADMMBase.h:240-256).  The caller applies the vector half,
//   adj_z = accel ? (1 + ratio) z_new - ratio z_old : z_old
// (and the same for y), and skips both halves on the converging
// iteration: the reference breaks out before accelerating.
struct Momentum {
  float a;  // Nesterov coefficient adj_a
  float c;  // combined residual adj_c
};

struct MomentumStep {
  bool accel;
  float ratio;
  float a_new;
  float c_new;
};

__device__ __forceinline__ MomentumStep fadmm_momentum(
    const Momentum& m, float rho, float r_pri, float extra_sq,
    float restart_tol) {
  MomentumStep s;
  const float c_new = rho * r_pri * r_pri + rho * extra_sq;
  s.accel = c_new < restart_tol * m.c;
  const float a_acc = 0.5f + 0.5f * sqrtf(1.0f + 4.0f * m.a * m.a);
  s.ratio = (m.a - 1.0f) / a_acc;
  s.a_new = s.accel ? a_acc : 1.0f;
  s.c_new = s.accel ? c_new : m.c / restart_tol;
  return s;
}

constexpr int kWarp = 32;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over each aligned group of `width` lanes of a warp (a power of two);
// every lane of a group gets its group's sum.  The tree is warp_sum's last
// log2(width) steps: a group whose sum sits in its first `width` lanes gives
// the bits warp_sum gives when the warp's other lanes hold 0.
__device__ __forceinline__ double group_sum(double v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum N per-thread values over the block; every thread gets the totals.
// blockDim.x must be a multiple of 32.  `scratch` holds 33 * N doubles.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* scratch) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[warp * N + k] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      double s = lane < nwarps ? scratch[lane * N + k] : 0.0;
      s = warp_sum(s);
      if (lane == 0) scratch[kWarp * N + k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = scratch[kWarp * N + k];
  // The next call writes only rows [0, 32) before its first barrier,
  // and every thread has read the totals here before reaching it.
}

// sum_i row[i] * v[i] over one warp's lanes (the caller reduces the lanes
// with warp_sum), for one row of a row-major float32 matrix in global
// memory and a float64 vector in shared memory; exact products accumulated
// in float64.  16-byte loads where the row starts on a 16-byte boundary and
// holds a multiple of four elements.
__device__ __forceinline__ double row_dot(const float* row, const double* v,
                                          int n, int wlane) {
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  if ((n & 3) == 0 && (reinterpret_cast<size_t>(row) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
    for (int i = wlane; i < n / 4; i += kWarp) {
      const float4 h = __ldg(row4 + i);
      const double* vv = v + 4 * i;
      a0 = fma(static_cast<double>(h.x), vv[0], a0);
      a1 = fma(static_cast<double>(h.y), vv[1], a1);
      a2 = fma(static_cast<double>(h.z), vv[2], a2);
      a3 = fma(static_cast<double>(h.w), vv[3], a3);
    }
  } else {
#pragma unroll 4
    for (int i = wlane; i < n; i += kWarp)
      a0 = fma(static_cast<double>(__ldg(row + i)), v[i], a0);
  }
  return (a0 + a1) + (a2 + a3);
}

// ---------------------------------------------------------------------------
// lanes_product: one block's share of a tall-skinny product over the lanes.
//
//   C[r, lane] = sum_d M[r, d] * V[lane, d]   r in [row_lo, row_hi),
//                                             lane in act[0 .. nact)
//
// M is a row-major float32 matrix in device memory (leading dimension ldm),
// V holds one float32 vector per lane (lane-major, leading dimension ldv) in
// the scratch the blocks of a cooperative grid exchange their iterates
// through.  Both leading dimensions are multiples of four floats, both
// bases 16-byte aligned, and whatever lies between `depth` and the leading
// dimension is zero, so every load is a 16-byte load and needs no mask
// along the depth.  epi(r, lane, c) receives each sum rounded once to
// float32.
//
// What it is for.  A kernel that gives one block one lane reads M again for
// every lane, through one SM's few loads in flight, and converts every
// element to float64 once per lane.  Here a block owns rows of M and all
// the lanes: the depth is walked in chunks; a chunk of M's rows and of
// every active lane's vector is loaded (the next chunk's loads are started
// into registers before the current chunk is computed on, so they are in
// flight meanwhile), converted to float64 ONCE and laid in
// shared memory; each thread keeps a 4 x 4 register tile of float64 sums
// (rows x lanes) and takes its operands as 16-byte shared loads of two
// depths at a time.  One load and one conversion of a matrix element then
// serves every lane.  Tiles are few when rows are few (q / 132 rows of a
// block against up to 128 lanes), so the threads left over split each
// chunk's depth among them (S slices), and the slices' sums are added in
// slice order through shared memory: no atomics, the same bits every run.
// Rows beyond what 256 threads' tiles cover are taken in further passes.
// Every chunk costs two block barriers and one exposed load latency, which
// is all there is to pay when lanes are few, so the same shared memory is
// cut deeper then: 64 rows + 128 lanes at 64 deep, 32 + 64 at 128, 16 + 32
// at 256 (the same registers per thread for the loads in each).
//
// Products of two float32 values are exact in float64; the sum is rounded
// once to float32, as the plain forms' float64 matmul is.
// ---------------------------------------------------------------------------
constexpr int kGemmThreads = 256;   // threads of a block that calls it
constexpr int kMaxLanes = 128;      // lanes per launch
constexpr int kTile = 4;            // register tile: kTile rows x kTile lanes
// The largest cut: (64 rows + 128 lanes) x (64 / 2 + 1) double2.
constexpr int kGemmSmemBytes =
    (64 + kMaxLanes) * (64 / 2 + 1) * static_cast<int>(sizeof(double2));

// Rows [lo, hi) of `rows` that block b of nb owns: sizes differ by at most
// one, every row has exactly one owner (kernels/_common.py::row_tile).
__host__ __device__ inline void row_tile(int rows, int b, int nb, int* lo,
                                         int* hi) {
  *lo = static_cast<int>(static_cast<long long>(rows) * b / nb);
  *hi = static_cast<int>(static_cast<long long>(rows) * (b + 1) / nb);
}

// One cut of the shared memory: at most kGemmMaxRows rows of M per pass and
// kGemmLanes active lanes, kGemmChunk deep.
template <int kGemmMaxRows, int kGemmLanes, int kGemmChunk, typename Epilogue>
__device__ __forceinline__ void lanes_product_cut(
    const float* __restrict__ M, int ldm, int row_lo, int row_hi, int depth,
    const float* V, int ldv, const int* act, int nact, double2* smem,
    Epilogue epi) {
  constexpr int kGemmPitch = kGemmChunk / 2 + 1;  // double2 per smem row
  constexpr int kC4 = kGemmChunk / 4;  // float4 per row per chunk
  constexpr int kMReg = kGemmMaxRows * kC4 / kGemmThreads;
  constexpr int kVReg = kGemmLanes * kC4 / kGemmThreads;
  static_assert((kGemmMaxRows + kGemmLanes) * kGemmPitch *
                        static_cast<int>(sizeof(double2)) <= kGemmSmemBytes,
                "the cut does not fit the product's shared memory");
  static_assert(kGemmThreads * kTile * kTile * sizeof(double) <=
                    kGemmSmemBytes, "the slices' sums do not fit");
  if (row_lo >= row_hi || nact <= 0) return;
  const int tid = threadIdx.x;
  const int tiles_l = (nact + kTile - 1) / kTile;
  int tiles_r_max = kGemmThreads / tiles_l;
  if (tiles_r_max > kGemmMaxRows / kTile) tiles_r_max = kGemmMaxRows / kTile;
  const int depth4 = (depth + 3) / 4;
  const int nchunks = (depth4 + kC4 - 1) / kC4;
  double2* Ms = smem;
  double2* Vs = smem + kGemmMaxRows * kGemmPitch;
  double* red = reinterpret_cast<double*>(smem);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int r0 = row_lo; r0 < row_hi; r0 += tiles_r_max * kTile) {
    const int R = min(tiles_r_max * kTile, row_hi - r0);
    const int tiles_r = (R + kTile - 1) / kTile;
    const int ntiles = tiles_r * tiles_l;
    // Depth slices: the largest power of two that the threads allow.
    int S = 1;
    while (2 * S * ntiles <= kGemmThreads && 2 * S <= kGemmChunk / 2) S *= 2;
    const bool worker = tid < S * ntiles;
    const int slice = tid / ntiles;
    const int tile = tid % ntiles;
    // Neighbouring threads take neighbouring rows (distinct shared-memory
    // banks) and the same lanes (one broadcast).
    const int tr = tile % tiles_r, tl = tile / tiles_r;
    const int mrows = tiles_r * kTile, vrows = tiles_l * kTile;

    double acc[kTile][kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[i][j] = 0.0;
    float4 mreg[kMReg], vreg[kVReg];

    // Chunk c + 1 is loaded into registers while chunk c is computed on.
    for (int c = -1; c < nchunks; ++c) {
      if (c >= 0) {
        __syncthreads();  // the last chunk (or the last pass's sums) is read
#pragma unroll
        for (int i = 0; i < kMReg; ++i) {
          const int e = i * kGemmThreads + tid;
          const int row = e / kC4, c4 = e % kC4;
          if (row < mrows) {
            double2* dst = Ms + row * kGemmPitch + 2 * c4;
            dst[0] = make_double2(mreg[i].x, mreg[i].y);
            dst[1] = make_double2(mreg[i].z, mreg[i].w);
          }
        }
#pragma unroll
        for (int i = 0; i < kVReg; ++i) {
          const int e = i * kGemmThreads + tid;
          const int li = e / kC4, c4 = e % kC4;
          if (li < vrows) {
            double2* dst = Vs + li * kGemmPitch + 2 * c4;
            dst[0] = make_double2(vreg[i].x, vreg[i].y);
            dst[1] = make_double2(vreg[i].z, vreg[i].w);
          }
        }
        __syncthreads();
      }
      if (c + 1 < nchunks) {
#pragma unroll
        for (int i = 0; i < kMReg; ++i) {
          const int e = i * kGemmThreads + tid;
          const int row = e / kC4, d4 = (c + 1) * kC4 + e % kC4;
          mreg[i] = (row < R && d4 < depth4)
                        ? __ldg(reinterpret_cast<const float4*>(
                                    M + static_cast<size_t>(r0 + row) * ldm) +
                                d4)
                        : zero4;
        }
#pragma unroll
        for (int i = 0; i < kVReg; ++i) {
          const int e = i * kGemmThreads + tid;
          const int li = e / kC4, d4 = (c + 1) * kC4 + e % kC4;
          // Written by other blocks before the last grid sync: read
          // through L2, not this SM's L1.
          vreg[i] = (li < nact && d4 < depth4)
                        ? __ldcg(reinterpret_cast<const float4*>(
                                     V + static_cast<size_t>(act[li]) * ldv) +
                                 d4)
                        : zero4;
        }
      }
      if (c >= 0 && worker) {
        for (int pp = slice; pp < kGemmChunk / 2; pp += S) {
          double2 a[kTile], b[kTile];
#pragma unroll
          for (int i = 0; i < kTile; ++i)
            a[i] = Ms[(tr + i * tiles_r) * kGemmPitch + pp];
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            b[j] = Vs[(tl + j * tiles_l) * kGemmPitch + pp];
#pragma unroll
          for (int i = 0; i < kTile; ++i)
#pragma unroll
            for (int j = 0; j < kTile; ++j) {
              acc[i][j] = fma(a[i].x, b[j].x, acc[i][j]);
              acc[i][j] = fma(a[i].y, b[j].y, acc[i][j]);
            }
        }
      }
    }
    __syncthreads();
    if (worker) {
      double* dst = red + static_cast<size_t>(tid) * (kTile * kTile);
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) dst[i * kTile + j] = acc[i][j];
    }
    __syncthreads();
    // Output (r, li) sits in tile (r % tiles_r, li % tiles_l), element
    // (r / tiles_r, li / tiles_l); its slices are added in slice order.
    for (int o = tid; o < R * nact; o += kGemmThreads) {
      const int r = o % R, li = o / R;
      const int t = (li % tiles_l) * tiles_r + r % tiles_r;
      const int el = (r / tiles_r) * kTile + li / tiles_l;
      double sum = 0.0;
      for (int s = 0; s < S; ++s)
        sum += red[static_cast<size_t>(s * ntiles + t) * (kTile * kTile) + el];
      epi(r0 + r, act[li], static_cast<float>(sum));
    }
  }
  __syncthreads();  // shared memory is free for the caller's next use
}

template <typename Epilogue>
__device__ __forceinline__ void lanes_product(
    const float* __restrict__ M, int ldm, int row_lo, int row_hi, int depth,
    const float* V, int ldv, const int* act, int nact, double2* smem,
    Epilogue epi) {
  // nact is the same in every thread of the grid: no divergence.
  if (nact <= 32)
    lanes_product_cut<16, 32, 256>(M, ldm, row_lo, row_hi, depth, V, ldv, act,
                                   nact, smem, epi);
  else if (nact <= 64)
    lanes_product_cut<32, 64, 128>(M, ldm, row_lo, row_hi, depth, V, ldv, act,
                                   nact, smem, epi);
  else
    lanes_product_cut<64, kMaxLanes, 64>(M, ldm, row_lo, row_hi, depth, V,
                                         ldv, act, nact, smem, epi);
}

// Sum N per-thread values over a warp's lanes, then over the blocks'
// partial sums: thread w of a warp takes blocks w, w + 32, ... and the warp
// reduces by shuffles, a fixed tree, so every block that adds the same
// partials reaches the same totals to the bit.  partial[b * stride + k] is
// block b's k-th sum; read through L2.
template <int N>
__device__ __forceinline__ void grid_totals(const double* partial,
                                            size_t stride, int nblocks,
                                            int wlane, double (&s)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = 0.0;
  for (int b = wlane; b < nblocks; b += kWarp) {
#pragma unroll
    for (int k = 0; k < N; ++k) s[k] += __ldcg(partial + b * stride + k);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = warp_sum(s[k]);
}

// The same totals from partial sums laid out sum-major,
// partial[k * nblocks + b]: a warp's load of one sum is contiguous over the
// blocks (a quarter of the L2 sectors of the block-major layout), and the
// loads of up to 160 blocks are all in flight before the first is added.
// Thread w adds blocks w, w + 32, ... in that order, as grid_totals does.
template <int N>
__device__ __forceinline__ void grid_totals_by_sum(const double* partial,
                                                   int nblocks, int wlane,
                                                   double (&s)[N]) {
  constexpr int kRounds = 5;
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = 0.0;
  for (int b0 = 0; b0 < nblocks; b0 += kRounds * kWarp) {
    double v[kRounds][N];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int b = b0 + r * kWarp + wlane;
#pragma unroll
      for (int k = 0; k < N; ++k)
        v[r][k] = b < nblocks ? __ldcg(partial + k * nblocks + b) : 0.0;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int k = 0; k < N; ++k) s[k] += v[r][k];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = warp_sum(s[k]);
}

// Largest dynamic shared memory a block may ask for on sm_90, keeping 2 KB
// for the static reduction scratch.
constexpr int kMaxDynamicSmem = 232448 - 2048;

template <typename Kernel>
inline cudaError_t set_dynamic_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace admm
