// Fused 1-NN + gather for Hopper (sm_90a).
//
// Replaces mapping_private_tpu/ops/pallas_nn.py::_make_gather_kernel (the
// Pallas TPU kernel behind nn_gather_prepared): for every query the squared
// distance to its nearest ref together with that ref's xyz and its aux row
// (a normal), so the caller needs no index and no second gather.
//
// Contract (shared with nn_gather_plain in ops/nn_gather.py):
//   q  (nq, 3) f32 row-major queries; dead queries carry -PAD_COORD.
//   rt (3, nr) f32 x/y/z rows, nt (3, nr) f32 aux rows (prepare_nn_ref);
//      dead refs carry +PAD_COORD.
//   sq (nq,) f32, q_sel (nq, 3) f32, n_sel (nq, 3) f32.
//   Distance modes, every product and sum rounded to f32 on its own:
//     vpu       d2 = (dx*dx + dy*dy) + dz*dz from direct differences
//     mxu       d2 = (q2 + r2) - 2*cross, q2 = (qx*qx + qy*qy) + qz*qz, r2
//               likewise, cross = (qx*rx + qy*ry) + qz*rz
//     mxu_fast  as mxu, but the cross term's inputs are first rounded to
//               bf16 (round to nearest even); q2, r2 and all sums stay f32.
//               The selection is approximate, the gathered rows are exact.
//   Ties: the refs are split into aligned windows of kTieWindow.  Inside a
//   window every ref whose d2 equals the window's minimum counts, and the
//   result is their average (xyz and aux, each weighted 1/count, summed in
//   ascending index).  A later window replaces the carried result only on a
//   strictly smaller minimum.  This is what the TPU kernel's one-hot product
//   and strict '<' carry make observable, and parity is row by row.
//
// What bounds it: FP32 issue slots, as nn_argmin.cu; the gather adds 24
// bytes per query, nothing beside nq*nr pair evaluations.
//
// What the design does about that: the TPU kernel gathers with a one-hot
// matrix product because its hardware has no cheap indexed read; here the
// gather is an indexed read of the winner.  The tie rule needs nothing per
// pair either: the window that ends up carried is the first one that holds
// the global minimum, and the first ref that reaches the global minimum
// lies in it.  So one thread owns one query and its hot loop is the plain
// running (minimum, first index) with a strict '<' of nn_argmin.cu and
// nn_matmul.cu, with no window structure, hit count or tie compare.  Refs
// stream through shared memory as there (for the expansion modes r2 is
// staged too, computed once per ref and not per pair; mxu_fast stages the
// bf16-rounded coordinates).  After the last tile the rest of the winner's
// window is walked once, from the winner to the window's end (at most
// kTieWindow refs, read by index from device memory, d2 recomputed with the
// same operations), and the refs that tie are counted; the lanes of a warp
// share each query's walk so that the loads are coalesced.  A single
// winner's row is then read once; only a tie walks the window a second time,
// in its own thread, to average in ascending index.
// Products and sums use __fmul_rn/__fadd_rn so nvcc cannot contract them
// and d2 matches the plain version bit for bit (fma(-2, cross, q2 + r2) has
// an exact product, so it rounds like the two-step form).  The tail of the
// last tile holds NaN refs: their d2 is NaN, which neither wins nor ties.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

enum Mode { kVpu = 0, kMxu = 1, kMxuFast = 2 };

constexpr int kBlock = 128;           // queries (threads) per block
constexpr int kTieWindow = 512;       // the reference's tie window, in refs
constexpr int kTile = 2048;          // refs per shared-memory tile (32 KB at most)

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (cx, cy, cz) are the query coordinates that enter the distance: the exact
// ones, or the bf16-rounded ones in mxu_fast.  (rx, ry, rz, r2) come from
// shared memory and are staged to match.
template <int MODE>
__device__ __forceinline__ float dist2(float cx, float cy, float cz, float q2,
                                       float rx, float ry, float rz, float r2) {
  if (MODE == kVpu) {
    const float dx = cx - rx;
    const float dy = cy - ry;
    const float dz = cz - rz;
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
  }
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(cx, rx), __fmul_rn(cy, ry)), __fmul_rn(cz, rz));
  return __fmaf_rn(-2.0f, cross, __fadd_rn(q2, r2));
}

// d2 of ref j read from device memory, staged as the tile loop stages it.
template <int MODE>
__device__ __forceinline__ float ref_dist2(const float* __restrict__ rt, size_t stride,
                                           size_t j, float cx, float cy, float cz,
                                           float q2) {
  const float x = __ldg(rt + j), y = __ldg(rt + stride + j), z = __ldg(rt + 2 * stride + j);
  if (MODE == kVpu) return dist2<MODE>(cx, cy, cz, q2, x, y, z, 0.f);
  const float r2 = sq_norm(x, y, z);
  if (MODE == kMxuFast)
    return dist2<MODE>(cx, cy, cz, q2, bf16_round(x), bf16_round(y), bf16_round(z), r2);
  return dist2<MODE>(cx, cy, cz, q2, x, y, z, r2);
}

__device__ __forceinline__ void consider(float d, int j, float& best_d, int& best_i) {
  if (d < best_d) {
    best_d = d;
    best_i = j;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kBlock)
    nn_gather_kernel(const float* __restrict__ q, int nq,
                     const float* __restrict__ rt, const float* __restrict__ nt,
                     int nr, float* __restrict__ sq_out,
                     float* __restrict__ qsel_out, float* __restrict__ nsel_out) {
  __shared__ __align__(16) float sx[kTile];
  __shared__ __align__(16) float sy[kTile];
  __shared__ __align__(16) float sz[kTile];
  __shared__ __align__(16) float s2[MODE == kVpu ? 4 : kTile];

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * static_cast<size_t>(i)];
    qy = q[3 * static_cast<size_t>(i) + 1];
    qz = q[3 * static_cast<size_t>(i) + 2];
  }
  const float q2 = sq_norm(qx, qy, qz);
  const float cx = MODE == kMxuFast ? bf16_round(qx) : qx;
  const float cy = MODE == kMxuFast ? bf16_round(qy) : qy;
  const float cz = MODE == kMxuFast ? bf16_round(qz) : qz;

  const size_t stride = static_cast<size_t>(nr);
  float best_d = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < nr; base += kTile) {
    const int n = min(kTile, nr - base);
    const int n4 = (n + 3) & ~3;  // walk whole float4s; tail padded below
    __syncthreads();  // previous tile fully consumed
    for (int j = threadIdx.x; j < n4; j += kBlock) {
      float x = CUDART_NAN_F, y = CUDART_NAN_F, z = CUDART_NAN_F;
      if (j < n) {
        x = rt[base + j];
        y = rt[stride + base + j];
        z = rt[2 * stride + base + j];
      }
      if (MODE != kVpu) s2[j] = sq_norm(x, y, z);
      sx[j] = MODE == kMxuFast ? bf16_round(x) : x;
      sy[j] = MODE == kMxuFast ? bf16_round(y) : y;
      sz[j] = MODE == kMxuFast ? bf16_round(z) : z;
    }
    __syncthreads();
    const float4* sx4 = reinterpret_cast<const float4*>(sx);
    const float4* sy4 = reinterpret_cast<const float4*>(sy);
    const float4* sz4 = reinterpret_cast<const float4*>(sz);
    const float4* s24 = reinterpret_cast<const float4*>(s2);
#pragma unroll 2
    for (int j4 = 0; j4 < n4 / 4; ++j4) {
      const float4 x = sx4[j4], y = sy4[j4], z = sz4[j4];
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (MODE != kVpu) w = s24[j4];
      const int j = base + 4 * j4;
      consider(dist2<MODE>(cx, cy, cz, q2, x.x, y.x, z.x, w.x), j, best_d, best_i);
      consider(dist2<MODE>(cx, cy, cz, q2, x.y, y.y, z.y, w.y), j + 1, best_d, best_i);
      consider(dist2<MODE>(cx, cy, cz, q2, x.z, y.z, z.z, w.z), j + 2, best_d, best_i);
      consider(dist2<MODE>(cx, cy, cz, q2, x.w, y.w, z.w, w.w), j + 3, best_d, best_i);
    }
  }
  // The carried window is the winner's; its ties lie between the winner and
  // the window's end.  The warp counts them for one of its queries at a
  // time: every lane takes every 32nd ref of that query's walk, so the loads
  // are coalesced.  (Each thread walking alone reads one word per cache
  // line: at 20,000 x 20,000 on an H100, 700 W, the vpu kernel then took
  // 0.46-0.47 ms, with this walk 0.36 ms.)  If no ref ever won, best_d is
  // +inf and row 0 is returned alone.
  const unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int walk = live && best_d < CUDART_INF_F;
  int cnt = 1;
  for (int l = 0; l < 32; ++l) {
    if (!__shfl_sync(kFull, walk, l)) continue;  // the same for the whole warp
    const int bi = __shfl_sync(kFull, best_i, l);
    const float bd = __shfl_sync(kFull, best_d, l);
    const float ax = __shfl_sync(kFull, cx, l);
    const float ay = __shfl_sync(kFull, cy, l);
    const float az = __shfl_sync(kFull, cz, l);
    const float a2 = __shfl_sync(kFull, q2, l);
    const int e = min(nr, (bi / kTieWindow + 1) * kTieWindow);
    int c = 0;
#pragma unroll 4
    for (int j = bi + 1 + lane; j < e; j += 32)
      c += ref_dist2<MODE>(rt, stride, j, ax, ay, az, a2) == bd ? 1 : 0;
    c = __reduce_add_sync(kFull, c);
    if (lane == l) cnt += c;
  }
  if (!live) return;
  const int w1 = min(nr, (best_i / kTieWindow + 1) * kTieWindow);
  float bq0, bq1, bq2, bn0, bn1, bn2;
  if (cnt == 1) {
    const size_t g = static_cast<size_t>(best_i);
    bq0 = rt[g];
    bq1 = rt[stride + g];
    bq2 = rt[2 * stride + g];
    bn0 = nt[g];
    bn1 = nt[stride + g];
    bn2 = nt[2 * stride + g];
  } else {
    // exact tie inside the window: average the tied refs, ascending
    const float wgt = __fdiv_rn(1.0f, static_cast<float>(cnt));
    bq0 = bq1 = bq2 = bn0 = bn1 = bn2 = 0.f;
    for (int j = best_i; j < w1; ++j) {
      if (ref_dist2<MODE>(rt, stride, j, cx, cy, cz, q2) == best_d) {
        const size_t g = static_cast<size_t>(j);
        bq0 = __fadd_rn(bq0, __fmul_rn(wgt, rt[g]));
        bq1 = __fadd_rn(bq1, __fmul_rn(wgt, rt[stride + g]));
        bq2 = __fadd_rn(bq2, __fmul_rn(wgt, rt[2 * stride + g]));
        bn0 = __fadd_rn(bn0, __fmul_rn(wgt, nt[g]));
        bn1 = __fadd_rn(bn1, __fmul_rn(wgt, nt[stride + g]));
        bn2 = __fadd_rn(bn2, __fmul_rn(wgt, nt[2 * stride + g]));
      }
    }
  }
  const size_t o = 3 * static_cast<size_t>(i);
  sq_out[i] = best_d;
  qsel_out[o] = bq0;
  qsel_out[o + 1] = bq1;
  qsel_out[o + 2] = bq2;
  nsel_out[o] = bn0;
  nsel_out[o + 1] = bn1;
  nsel_out[o + 2] = bn2;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `mode` is 0 (vpu), 1 (mxu) or
// 2 (mxu_fast).  Launches on `stream` and does not synchronise; returns
// cudaGetLastError() (0 on success), so a refused launch is reported by the
// caller.
extern "C" int nn_gather_launch(int mode, const void* q, int nq, const void* rt,
                                const void* nt, int nr, void* sq, void* qsel,
                                void* nsel, void* stream) {
  if (nq <= 0 || nr <= 0 || mode < kVpu || mode > kMxuFast)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* rf = static_cast<const float*>(rt);
  const float* nf = static_cast<const float*>(nt);
  float* o0 = static_cast<float*>(sq);
  float* o1 = static_cast<float*>(qsel);
  float* o2 = static_cast<float*>(nsel);
  if (mode == kVpu)
    nn_gather_kernel<kVpu><<<grid, kBlock, 0, s>>>(qf, nq, rf, nf, nr, o0, o1, o2);
  else if (mode == kMxu)
    nn_gather_kernel<kMxu><<<grid, kBlock, 0, s>>>(qf, nq, rf, nf, nr, o0, o1, o2);
  else
    nn_gather_kernel<kMxuFast><<<grid, kBlock, 0, s>>>(qf, nq, rf, nf, nr, o0, o1, o2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nn_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
