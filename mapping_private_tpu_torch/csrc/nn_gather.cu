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
//   In vpu mode the refs end as if padded to a whole window with refs at
//   (PAD_COORD, PAD_COORD, PAD_COORD) whose aux row is 0, as the TPU
//   kernel's refs are (prepare_nn_ref pads its 8 rows with PAD_COORD): such
//   a ref ties with a dead one, so where the last window is partial and
//   holds the minimum the missing rows join the average.  In the mxu modes
//   the TPU kernel's padding has r2 = 8 PAD_COORD^2 against a dead ref's 3,
//   never ties, and nothing is added.
//
// What bounds it: FP32 issue slots, as nn_argmin.cu; the gather adds 24
// bytes per query, nothing beside nq*nr pair evaluations.
//
// What the design does about that: the search is nn_search.cuh's, the
// skeleton of nn_argmin.cu and nn_matmul.cu (refs split across blocks, two
// queries a thread, a tree minimum of 8 in the hot loop, the index found
// late), with their pairs from nn_pairs.cuh: DirectPair for vpu, and
// ExpansionForm staged here from (3, nr) rows for the mxu modes (r2 a
// fourth row computed once per ref, the bf16-rounded coordinates staged in
// mxu_fast).  The TPU kernel gathers with a one-hot matrix product because
// its hardware has no cheap indexed read; here the gather is an indexed
// read of the winner.  The tie rule needs no window structure in the hot
// loop either: the window that ends up carried is the first one that
// holds the global minimum, and the lowest index that reaches it, which
// the skeleton finds, lies in it.  So all of the gather is the output
// policy Gather, run once per query by the block that writes the outputs
// (the only one, or the one that merges the stretches).  It asks the
// skeleton for the tie flag (about 2 instructions a group of 8 refs): a
// query whose d2 no other ref reaches, nearly every query of a scan, reads
// its winner's rows and is done.  (When every query walked, the vpu kernel
// took 0.072 ms more than nn_argmin at 20,000 x 20,000; with the flag it
// takes 0.012 ms more; H100, 700 W.)  For a query that may tie, the
// rest of the winner's window is walked once, from the winner to the
// window's end (at most kTieWindow refs, read by index from device memory,
// so stretch boundaries do not matter, d2 recomputed by dist_at with the
// staging's operations), and the refs that tie are counted; the lanes of
// a warp share each query's walk so that the loads are coalesced.  A
// single winner's row is then read once; only a tie walks the window a
// second time, in its own thread, to average in ascending index, with a
// compensated sum (an average of hundreds of tied rows then stays within
// an ulp or so of the exact one, where a plain running sum drifts by a few
// hundred ulp).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn_pairs.cuh"
#include "nn_search.cuh"

namespace {

using nn_search::sq_norm;

enum Mode { kVpu = 0, kMxu = 1, kMxuFast = 2 };

constexpr int kTieWindow = 512;     // the reference's tie window, in refs
constexpr float kPadCoord = 1.0e8f;  // PAD_COORD of the JAX package
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The expansion form over (3, nr) rows; with kBf16Cross the coordinates
// that enter the cross term are rounded to bf16 (query and ref), q2 and r2
// come from the exact ones.
template <bool kBf16Cross>
struct ExpansionRows : nn_search::ExpansionForm {
  static __device__ __forceinline__ float cross_in(float x) {
    return kBf16Cross ? bf16_round(x) : x;
  }

  static __device__ __forceinline__ Query query(float qx, float qy, float qz) {
    return {cross_in(qx), cross_in(qy), cross_in(qz), sq_norm(qx, qy, qz)};
  }

  static __device__ __forceinline__ float4 staged(float x, float y, float z) {
    return make_float4(cross_in(x), cross_in(y), cross_in(z), sq_norm(x, y, z));
  }

  // The tail is filled with NaN refs: d2 is NaN, which fminf drops and which
  // is never '<' or '==' anything (+inf refs would give inf - inf).
  static __device__ __forceinline__ void stage(const float* __restrict__ rt, int nr, int base,
                                               int n, int n_pad,
                                               float (*s)[nn_search::kTile]) {
    const float* rx = rt + base;
    const float* ry = rx + static_cast<size_t>(nr);
    const float* rz = ry + static_cast<size_t>(nr);
    for (int j = threadIdx.x; j < n_pad; j += nn_search::kBlock) {
      float x = CUDART_NAN_F, y = CUDART_NAN_F, z = CUDART_NAN_F;
      if (j < n) {
        x = rx[j];
        y = ry[j];
        z = rz[j];
      }
      const float4 v = staged(x, y, z);
      s[0][j] = v.x;
      s[1][j] = v.y;
      s[2][j] = v.z;
      s[3][j] = v.w;
    }
  }
};

// d2 of query q to ref j of (3, nr) rows, read from device memory and put
// through the pair's staged(): the bits of the search loop's d2
template <class Pair>
__device__ __forceinline__ float dist_at(const typename Pair::Query& q,
                                         const float* __restrict__ rt, int nr, int j) {
  const size_t n = static_cast<size_t>(nr);
  const float4 v = Pair::staged(__ldg(rt + j), __ldg(rt + n + j), __ldg(rt + 2 * n + j));
  return Pair::dist(q, v.x, v.y, v.z, v.w);
}

// a pair's query from lane `src`, member by member (a copy through an array
// would go to local memory)
__device__ __forceinline__ nn_search::DirectPair::Query shfl(
    const nn_search::DirectPair::Query& q, int src) {
  return {__shfl_sync(kFull, q.x, src), __shfl_sync(kFull, q.y, src),
          __shfl_sync(kFull, q.z, src)};
}

__device__ __forceinline__ nn_search::ExpansionForm::Query shfl(
    const nn_search::ExpansionForm::Query& q, int src) {
  return {__shfl_sync(kFull, q.x, src), __shfl_sync(kFull, q.y, src),
          __shfl_sync(kFull, q.z, src), __shfl_sync(kFull, q.q2, src)};
}

// Kahan's compensated sum
struct Sum {
  float s = 0.f, c = 0.f;

  __device__ __forceinline__ void add(float x) {
    const float y = __fsub_rn(x, c);
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
  }
};

struct GatherArgs {
  const float* nt;
  float* sq;
  float* qsel;
  float* nsel;
};

// The output policy: from the final (least d2, lowest index) to sq and
// the tie window's average of the xyz and aux rows.  kPadWindow: the refs
// end as if padded to a whole window (vpu mode; see the contract above).
template <class Pair, bool kPadWindow>
struct Gather {
  using Args = GatherArgs;
  static constexpr bool kTies = true;

  static __device__ __forceinline__ void write(const Args& a, const typename Pair::Query& qu,
                                               const float* __restrict__ rt, int nr, int i,
                                               bool live, float d, int ix, bool tie) {
    // padding refs are nr, nr + 1, ... up to the end of the last window
    int pads = 0;
    if (kPadWindow && nr % kTieWindow != 0) {
      const float4 v = Pair::staged(kPadCoord, kPadCoord, kPadCoord);
      const float p = Pair::dist(qu, v.x, v.y, v.z, v.w);
      if (p < d) {
        d = p;
        ix = nr;
      }
      if (p == d && ix >= (nr - 1) / kTieWindow * kTieWindow) pads = kTieWindow - nr % kTieWindow;
    }
    // Only a query that the search saw tie walks.  The warp counts the ties
    // after the winner for one of those queries at a time: every lane takes
    // every 32nd ref of that query's walk, so the loads are coalesced.
    // (Each thread walking alone reads one word per cache line: at 20,000 x
    // 20,000 on an H100, 700 W, the first vpu kernel then took 0.46-0.47 ms,
    // with this walk 0.36 ms.)  If no ref ever won, d is +inf and row 0 is
    // returned alone.
    const int lane = threadIdx.x & 31;
    int cnt = 1;
    // the lanes that walk, lowest first; the mask is the same for the whole warp
    for (unsigned m = __ballot_sync(kFull, live && tie && d < CUDART_INF_F); m; m &= m - 1) {
      const int l = __ffs(m) - 1;
      const int wi = __shfl_sync(kFull, ix, l);
      const float wd = __shfl_sync(kFull, d, l);
      const typename Pair::Query wq = shfl(qu, l);
      const int e = min(nr, (wi / kTieWindow + 1) * kTieWindow);
      int c = 0;
#pragma unroll 2
      for (int j = wi + 1 + lane; j < e; j += 32)
        c += dist_at<Pair>(wq, rt, nr, j) == wd ? 1 : 0;
      c = __reduce_add_sync(kFull, c);
      if (lane == l) cnt += c;
    }
    if (!live) return;
    const size_t stride = static_cast<size_t>(nr);
    const int n = (ix < nr ? cnt : 0) + pads;
    float out[6];
    if (n == 1 && pads == 0) {
      const size_t g = static_cast<size_t>(ix);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        out[r] = rt[r * stride + g];
        out[3 + r] = a.nt[r * stride + g];
      }
    } else {
      // exact tie inside the window: average the tied refs, ascending
      const float wgt = __fdiv_rn(1.0f, static_cast<float>(n));
      Sum acc[6];
      const int e = min(nr, (ix / kTieWindow + 1) * kTieWindow);
      // not unrolled: unrolled, it spills in vpu mode, whose 24.5 KB tile lets
      // ptxas aim at 9 blocks an SM and so at 56 registers
#pragma unroll 1
      for (int j = ix; j < e; ++j) {
        if (dist_at<Pair>(qu, rt, nr, j) == d) {
          const size_t g = static_cast<size_t>(j);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            acc[r].add(__fmul_rn(wgt, rt[r * stride + g]));
            acc[3 + r].add(__fmul_rn(wgt, a.nt[r * stride + g]));
          }
        }
      }
      const float wp = __fmul_rn(wgt, kPadCoord);  // a padding ref's aux rows are 0
      for (int k = 0; k < pads; ++k) {
#pragma unroll
        for (int r = 0; r < 3; ++r) acc[r].add(wp);
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) out[r] = acc[r].s;
    }
    const size_t o = 3 * static_cast<size_t>(i);
    a.sq[i] = d;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      a.qsel[o + r] = out[r];
      a.nsel[o + r] = out[3 + r];
    }
  }
};

template <class Pair, bool kPadWindow>
int launch_mode(const void* q, int nq, const void* rt, int nr, int stretch, int rows,
                void* part_d, void* part_i, int n_counters, void* counters,
                const GatherArgs& out, void* stream) {
  return nn_search::launch<Pair, Gather<Pair, kPadWindow>>(
      q, nq, rt, nr, stretch, rows, part_d, part_i, n_counters, counters, out, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes; see nn_search::launch.  `mode`
// is 0 (vpu), 1 (mxu) or 2 (mxu_fast); anything else is refused with
// cudaErrorInvalidValue.
extern "C" int nn_gather_launch(const void* q, int nq, const void* rt, int nr, int stretch,
                                int rows, void* part_d, void* part_i, int n_counters,
                                void* counters, int mode, const void* nt, void* sq,
                                void* qsel, void* nsel, void* stream) {
  const GatherArgs out{static_cast<const float*>(nt), static_cast<float*>(sq),
                       static_cast<float*>(qsel), static_cast<float*>(nsel)};
  switch (mode) {
    case kVpu:
      return launch_mode<nn_search::DirectPair, true>(q, nq, rt, nr, stretch, rows, part_d,
                                                      part_i, n_counters, counters, out, stream);
    case kMxu:
      return launch_mode<ExpansionRows<false>, false>(q, nq, rt, nr, stretch, rows, part_d,
                                                      part_i, n_counters, counters, out, stream);
    case kMxuFast:
      return launch_mode<ExpansionRows<true>, false>(q, nq, rt, nr, stretch, rows, part_d,
                                                     part_i, n_counters, counters, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* nn_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
