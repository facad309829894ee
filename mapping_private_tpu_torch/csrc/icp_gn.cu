// The Gauss-Newton step of a point-to-plane ICP sweep for Hopper (sm_90a):
// all of registration/icp.py::icp_point_to_plane's sweep but the
// correspondence search, for CUDA tensors.
//
// Replaces no Pallas kernel: the JAX package leaves the sweep's GN work
// (se3_apply, _gn_from_corr, the unrolled 6x6 Cholesky, se3_exp) to XLA,
// which fuses it into a few programs.  The port enqueued it op by op from
// Python: ~330 launches a sweep of a few microseconds each, so the card
// waited on the host for most of every sweep.  Here a sweep is three
// launches beside the search, and nothing is read back to the host.
//
// Contract (the plain version is se3_apply + _gn_from_corr in
// registration/icp.py, which CPU tensors run):
//   T (4, 4) f32, on the card, read by stage 0 and rewritten in place by
//   stage 2; src, p, queries (n, 3) f32; mask (n,) bool; idx (n,) int32
//   (-1: no correspondence), sq (n,) f32; tgt, nrm (m, 3) f32;
//   params (3,) f32: max_corr_dist^2, huber_delta, damping.
//   Every float operation of a point is rounded on its own (no fused
//   multiply-adds), in the order of the plain version's tensor code.
//   Stage 0, apply: p = T src, each coordinate ((R0 x + R1 y) + R2 z) + t,
//     se3_apply's order; where `queries` is given, also the NN queries: p
//     on live rows, -PAD_COORD on dead ones.
//   Stage 1, partials: per point ok = mask & idx >= 0 & sq <= max^2;
//     q, n gathered at max(idx, 0); r = (n0 (p0 - q0) + n1 (p1 - q1)) +
//     n2 (p2 - q2); the Huber weight w (1 where |r| <= delta, else delta /
//     max(|r|, 1e-12)), 0 where not ok; J = [n, p x n], Jw = J w in f32.
//     Each block sums, in float64 from the exact products of those f32
//     values, the 21 entries of J^T W J that the Cholesky reads (J_i Jw_j,
//     i >= j), the 6 of J^T W r (Jw_i r), sum (w r) r, sum w and the count
//     of ok, and writes them as one row of `work`: no float atomics, so the
//     result does not depend on how the blocks are scheduled.
//   Stage 2, solve (one block): the rows merged in ascending block order in
//     float64, then rounded to f32; the damping added to the diagonal; the
//     Cholesky and both substitutions of core/linalg.py's
//     cholesky_solve_unrolled, in its order, the pivot clamped to 1e-20
//     before its square root; xi = -x; T <- se3_exp(xi) T with
//     core/se3.py's f32 formulas (the small-angle series below theta^2 =
//     1e-8, theta = sqrt(theta^2 + 1e-9)); rmse = sqrt(sum w r^2 /
//     max(sum w, 1e-12)) and the count written to this sweep's slots.
//   The plain version sums J^T W J and J^T W r as f32 matrix products; the
//   float64 sums here are no less precise, and the two agree to f32
//   rounding of those 27 sums.
//
// What bounds it: bytes, and at the scans' sizes the launch latency.  A
// point costs ~45 bytes in stage 1 (p, idx, sq, mask, the gathered q and
// n) and 37 in stage 0; at 20,000 points a sweep moves ~1.6 MB, ~0.5 us
// at 3.35 TB/s, below the few microseconds any launch takes.
//
// What the design does about that: the fewest launches that keep the
// reduction deterministic without atomics (a last-block ticket would save
// one, at the cost of counters that must be reset), one point a thread
// where the grid allows, and the single-thread solve, a chain of ~500
// dependent f32 operations, kept in registers (every loop unrolled at
// compile time).

#include <cuda_runtime.h>

namespace {

constexpr int kApplyBlock = 256;  // threads of a stage-0 block
constexpr int kBlock = 128;       // threads of a stage-1 block
constexpr int kMaxBlocks = 1024;  // stage-1 blocks at most; a grid-stride loop beyond
constexpr int kH = 21;            // J^T W J's lower triangle, row by row
constexpr int kSums = kH + 6 + 3;  // + J^T W r, sum w r^2, sum w, count
constexpr int kRow = 32;          // doubles in a row of the workspace
constexpr int kMerge = 8;         // rows loaded at once by the merge
constexpr float kPadCoord = 1.0e8f;  // PAD_COORD of the JAX package
constexpr unsigned kFull = 0xffffffffu;

enum Stage { kApply = 0, kPartials = 1, kSolve = 2 };

// torch.clamp_min: NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__global__ void __launch_bounds__(kApplyBlock)
    apply_kernel(const float* __restrict__ T, const float* __restrict__ src,
                 const unsigned char* __restrict__ mask, float* __restrict__ p,
                 float* __restrict__ queries, int n) {
  const int i = blockIdx.x * kApplyBlock + threadIdx.x;
  if (i >= n) return;
  const size_t o = 3 * static_cast<size_t>(i);
  const float x = src[o], y = src[o + 1], z = src[o + 2];
  const bool live = mask[i] != 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float v = __fadd_rn(dot3(T[4 * r], T[4 * r + 1], T[4 * r + 2], x, y, z), T[4 * r + 3]);
    p[o + r] = v;
    if (queries) queries[o + r] = live ? v : -kPadCoord;
  }
}

__global__ void __launch_bounds__(kBlock)
    partials_kernel(const float* __restrict__ p, const int* __restrict__ idx,
                    const float* __restrict__ sq, const unsigned char* __restrict__ mask,
                    const float* __restrict__ tgt, const float* __restrict__ nrm,
                    const float* __restrict__ params, double* __restrict__ work, int n) {
  __shared__ double warp_sums[kBlock / 32][kSums];
  const float max_sq = params[0], delta = params[1];
  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;

  for (int i = blockIdx.x * kBlock + threadIdx.x; i < n; i += gridDim.x * kBlock) {
    const int j = idx[i];
    const bool ok = mask[i] != 0 && j >= 0 && sq[i] <= max_sq;
    const size_t o = 3 * static_cast<size_t>(i), g = 3 * static_cast<size_t>(max(j, 0));
    const float px = p[o], py = p[o + 1], pz = p[o + 2];
    const float nx = nrm[g], ny = nrm[g + 1], nz = nrm[g + 2];
    const float r = dot3(nx, ny, nz, __fsub_rn(px, tgt[g]), __fsub_rn(py, tgt[g + 1]),
                         __fsub_rn(pz, tgt[g + 2]));
    const float absr = fabsf(r);
    float w = absr <= delta ? 1.0f : __fdiv_rn(delta, clamp_min(absr, 1e-12f));
    w = ok ? w : 0.0f;
    const float J[6] = {nx, ny, nz, __fsub_rn(__fmul_rn(py, nz), __fmul_rn(pz, ny)),
                        __fsub_rn(__fmul_rn(pz, nx), __fmul_rn(px, nz)),
                        __fsub_rn(__fmul_rn(px, ny), __fmul_rn(py, nx))};
    float jw[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) jw[a] = __fmul_rn(J[a], w);
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) acc[k++] += static_cast<double>(J[a]) * jw[b];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[kH + a] += static_cast<double>(jw[a]) * r;
    acc[kH + 6] += static_cast<double>(__fmul_rn(w, r)) * r;
    acc[kH + 7] += w;
    acc[kH + 8] += ok ? 1.0 : 0.0;
  }

  // the block's sums: a fixed tree in each warp, then the warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    double v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double s = warp_sums[0][threadIdx.x];
#pragma unroll
    for (int wp = 1; wp < kBlock / 32; ++wp) s += warp_sums[wp][threadIdx.x];
    work[static_cast<size_t>(blockIdx.x) * kRow + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(32)
    solve_kernel(const double* __restrict__ work, int blocks, const float* __restrict__ params,
                 float* __restrict__ T, float* __restrict__ rmse, int* __restrict__ cnt) {
  __shared__ double sums[kSums];
  const int t = threadIdx.x;
  if (t < kSums) {
    // ascending block order; kMerge loads in flight before they are added
    double s = 0.0;
    int b = 0;
    for (; b + kMerge <= blocks; b += kMerge) {
      double v[kMerge];
#pragma unroll
      for (int u = 0; u < kMerge; ++u) v[u] = work[static_cast<size_t>(b + u) * kRow + t];
#pragma unroll
      for (int u = 0; u < kMerge; ++u) s += v[u];
    }
    for (; b < blocks; ++b) s += work[static_cast<size_t>(b) * kRow + t];
    sums[t] = s;
  }
  __syncthreads();
  if (t != 0) return;

  const float damping = params[2];
  float L[6][6], g[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = __double2float_rn(sums[k++]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = __double2float_rn(sums[kH + i]);
  if (damping != 0.0f) {
#pragma unroll
    for (int i = 0; i < 6; ++i) L[i][i] = __fadd_rn(L[i][i], damping);
  }
  // Cholesky in place over the lower triangle: H = L L^T
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = L[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) s = __fsub_rn(s, __fmul_rn(L[i][m], L[j][m]));
      L[i][j] = i == j ? __fsqrt_rn(clamp_min(s, 1e-20f)) : __fdiv_rn(s, L[j][j]);
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {  // L y = g
    float s = g[i];
#pragma unroll
    for (int m = 0; m < i; ++m) s = __fsub_rn(s, __fmul_rn(L[i][m], y[m]));
    y[i] = __fdiv_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {  // L^T x = y
    float s = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s = __fsub_rn(s, __fmul_rn(L[m][i], x[m]));
    x[i] = __fdiv_rn(s, L[i][i]);
  }

  // se3_exp(xi), xi = -x = [v, w]
  const float v[3] = {-x[0], -x[1], -x[2]};
  const float w0 = -x[3], w1 = -x[4], w2 = -x[5];
  const float th2 = dot3(w0, w1, w2, w0, w1, w2);
  const float th = __fsqrt_rn(__fadd_rn(th2, 1e-9f));
  const bool big = th2 > 1e-8f;
  const float sn = sinf(th), cs = cosf(th);
  const float a = big ? __fdiv_rn(sn, th) : __fsub_rn(1.0f, __fdiv_rn(th2, 6.0f));
  const float b = big ? __fdiv_rn(__fsub_rn(1.0f, cs), th2) : __fsub_rn(0.5f, __fdiv_rn(th2, 24.0f));
  const float c = big ? __fdiv_rn(__fsub_rn(th, sn), __fmul_rn(th2, th))
                      : __fsub_rn(static_cast<float>(1.0 / 6.0), __fdiv_rn(th2, 120.0f));
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  // exp(xi) = [R | V v] over [0, 0, 0, 1]
  float E[4][4] = {{}, {}, {}, {0.0f, 0.0f, 0.0f, 1.0f}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float WW = dot3(W[i][0], W[i][1], W[i][2], W[0][j], W[1][j], W[2][j]);
      const float id = i == j ? 1.0f : 0.0f;
      E[i][j] = __fadd_rn(__fadd_rn(id, __fmul_rn(a, W[i][j])), __fmul_rn(b, WW));
      V[j] = __fadd_rn(__fadd_rn(id, __fmul_rn(b, W[i][j])), __fmul_rn(c, WW));
    }
    E[i][3] = dot3(V[0], V[1], V[2], v[0], v[1], v[2]);
  }
  // T <- exp(xi) T, every product over the four terms in order
  float Tn[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = __fmul_rn(E[i][0], T[j]);
#pragma unroll
      for (int m = 1; m < 4; ++m) s = __fadd_rn(s, __fmul_rn(E[i][m], T[4 * m + j]));
      Tn[i][j] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) T[4 * i + j] = Tn[i][j];
  }
  const float swr2 = __double2float_rn(sums[kH + 6]), sw = __double2float_rn(sums[kH + 7]);
  *rmse = __fsqrt_rn(__fdiv_rn(swr2, clamp_min(sw, 1e-12f)));
  *cnt = static_cast<int>(sums[kH + 8]);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `stage` is 0 (apply), 1
// (partials) or 2 (solve); each reads the pointers the contract above names
// for it and ignores the others (`queries` may be null in stage 0).
// `blocks` is stage 1's grid, 1..1024, and the rows of `work` (kRow = 32
// doubles each) that stage 2 merges.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError(); anything out of range is
// refused with cudaErrorInvalidValue and nothing is launched.
extern "C" int icp_gn_launch(int stage, int n, int blocks, void* T, const void* src,
                             const void* mask, void* p, void* queries, const void* idx,
                             const void* sq, const void* tgt, const void* nrm,
                             const void* params, void* work, void* rmse, void* cnt,
                             void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (n < 0 || (stage != kApply && (blocks < 1 || blocks > kMaxBlocks))) return invalid;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kApply:
      if (!T || !src || !mask || !p) return invalid;
      if (n == 0) return 0;
      apply_kernel<<<(n + kApplyBlock - 1) / kApplyBlock, kApplyBlock, 0, s>>>(
          static_cast<const float*>(T), static_cast<const float*>(src),
          static_cast<const unsigned char*>(mask), static_cast<float*>(p),
          static_cast<float*>(queries), n);
      break;
    case kPartials:
      if (!p || !idx || !sq || !mask || !tgt || !nrm || !params || !work) return invalid;
      partials_kernel<<<blocks, kBlock, 0, s>>>(
          static_cast<const float*>(p), static_cast<const int*>(idx),
          static_cast<const float*>(sq), static_cast<const unsigned char*>(mask),
          static_cast<const float*>(tgt), static_cast<const float*>(nrm),
          static_cast<const float*>(params), static_cast<double*>(work), n);
      break;
    case kSolve:
      if (!work || !params || !T || !rmse || !cnt) return invalid;
      solve_kernel<<<1, 32, 0, s>>>(static_cast<const double*>(work), blocks,
                                    static_cast<const float*>(params), static_cast<float*>(T),
                                    static_cast<float*>(rmse), static_cast<int*>(cnt));
      break;
    default:
      return invalid;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* icp_gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
