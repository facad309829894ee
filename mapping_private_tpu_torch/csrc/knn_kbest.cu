// The k smallest squared distances from each point of a set to the others,
// for Hopper (sm_90a): the search of the statistical outlier filter
// (ops/filters.py::statistical_outlier_mask).
//
// Replaces no Pallas kernel: the JAX package ranks a dense distance matrix
// with top_k (mapping_private_tpu/ops/neighbors.py::knn_bruteforce).  It was
// added because that search, as dense distance blocks and torch.topk over
// every row of a 307,200-row Kinect frame, was 97% of the tabletop frame on
// an H100.  The denoise needs only each point's mean distance to its k
// nearest, so this kernel writes the k distances and no indices.
//
// Contract (shared with knn_kbest_plain in ops/knn_kbest.py):
//   rt  (3, n) f32 x/y/z rows of the live points (prepare_nn_ref_argmin's
//       layout); the queries are the same points.
//   out (n, k) f32: row i holds the k smallest d2 over j != i (by index:
//       duplicates of point i keep their zero distances), ascending, +inf
//       in the slots past n - 1.  d2 = (dx*dx + dy*dy) + dz*dz from direct
//       differences, nn_pairs.cuh's DirectPair, bit for bit.
//
// What bounds it: FP32 issue slots, as nn_search.cuh says of the 1-NN
// searches.  A pair costs the 8 unfused instructions of the distance and
// one compare against the k-th best so far; the n^2 pairs move no
// device-memory bytes to speak of.  What the design does about that:
//
// * The skeleton of nn_search.cuh: a thread owns kQueries = 2 queries, a
//   block kBlock = 128 threads, refs are staged in kTile shared-memory tiles
//   by DirectPair::stage and read kGroup = 8 at a time as broadcast 16-byte
//   loads, shared by both queries.
// * No split of the refs across blocks, so no k-lists to merge: at the
//   tabletop's ~97,200 live points the queries alone make ~380 blocks, 2.9
//   an SM.  A split is later work, for a cloud small enough to leave the
//   card unfilled.
// * Each query keeps its k-list sorted ascending in registers: K slots, K
//   the bucket of k (a multiple of kStep), unrolled at compile time so that
//   it never spills to local memory.  The K - k lowest slots hold -inf and
//   never move, so the last slot is always the k-th best.
// * Insertion, not the distance, is the slow path: each list takes ~k ln(n/k)
//   insertions in a random order of points, and a warp waits for the union
//   of its 64 queries'.  Measured on an H100 (700 W) at the tabletop's 97,495
//   points, k = 20: 5.63 ms in the frame's order, against a bound of 2.56.
//   Putting the points in z-order first took it to 4.43 ms: ~1.2 ms of a
//   ~78 ms frame, too little to keep a permutation and its inverse for.
// * The hot loop takes the tree minimum of a group's 8 distances and
//   compares it with the last slot: arithmetic, one min a pair and one
//   compare a group.  Only a group whose minimum beats it takes the slow
//   path, which inserts each of its refs that (still) beats the last slot
//   and is not the query itself.  Insertion is a compare-and-shift down the
//   list; a strict '<' keeps the earlier ref on exact ties (the output is
//   the same either way: it holds distances only).
// * No tensor cores: the distance is part of the contract bit for bit, and
//   the expansion form in TF32 would be less precise than float32.

#include "nn_pairs.cuh"
#include "nn_search.cuh"

namespace knn_kbest {

using nn_search::DirectPair;
using nn_search::kBlock;
using nn_search::kGroup;
using nn_search::kQueries;
using nn_search::kTile;

constexpr int kStep = 8;  // K buckets: k rounded up to a multiple of kStep
constexpr int kMax = 64;  // the largest k

// d into the ascending list a, dropping its last entry.
template <int K>
__device__ __forceinline__ void insert(float (&a)[K], float d) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) a[s] = d < a[s - 1] ? a[s - 1] : fminf(d, a[s]);
  a[0] = fminf(d, a[0]);
}

template <int K>
__global__ void __launch_bounds__(kBlock)
    kbest_kernel(const float* __restrict__ rt, int n, int k, float* __restrict__ out) {
  __shared__ __align__(16) float s[DirectPair::kRows][kTile];

  const int i0 = blockIdx.x * (kBlock * kQueries) + threadIdx.x;
  DirectPair::Query qu[kQueries];
  float a[kQueries][K];
#pragma unroll
  for (int t = 0; t < kQueries; ++t) {
    const int i = i0 + t * kBlock;
    const bool live = i < n;
    qu[t] = DirectPair::query(live ? rt[i] : 0.f, live ? rt[n + i] : 0.f,
                              live ? rt[2 * static_cast<size_t>(n) + i] : 0.f);
    // a slot past n is all -inf: it never takes the slow path
#pragma unroll
    for (int m = 0; m < K; ++m) a[t][m] = live && m >= K - k ? CUDART_INF_F : -CUDART_INF_F;
  }

  for (int base = 0; base < n; base += kTile) {
    const int nt = min(kTile, n - base);
    const int n_pad = (nt + kGroup - 1) / kGroup * kGroup;
    __syncthreads();  // previous tile fully consumed
    DirectPair::stage(rt, n, base, nt, n_pad, s);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < n_pad; j += kGroup) {
      float4 r[DirectPair::kRows][kGroup / 4];
      nn_search::load_group<DirectPair>(s, j, r);
#pragma unroll
      for (int t = 0; t < kQueries; ++t) {
        float d[kGroup];
        nn_search::group_dists<DirectPair>(qu[t], r, d);
        float m = d[0];
#pragma unroll
        for (int g = 1; g < kGroup; ++g) m = fminf(m, d[g]);
        if (m < a[t][K - 1]) {
          // the refs of the group that beat the k-th best, one bit each
          unsigned int hits = 0;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) hits |= (d[g] < a[t][K - 1] ? 1u : 0u) << g;
          const int self = i0 + t * kBlock - base - j;  // the query's own slot in the group
          if (self >= 0 && self < kGroup) hits &= ~(1u << self);
          while (hits) {
            const int g = __ffs(hits) - 1;
            hits &= hits - 1;
            float dg = d[0];  // d[g] by constant indices: indexed by g, d would live in local memory
#pragma unroll
            for (int h = 1; h < kGroup; ++h) dg = g == h ? d[h] : dg;
            if (dg < a[t][K - 1]) insert(a[t], dg);
          }
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kQueries; ++t) {
    const int i = i0 + t * kBlock;
    if (i < n) {
      float* row = out + static_cast<size_t>(i) * k;
#pragma unroll
      for (int m = 0; m < K; ++m)
        if (m >= K - k) row[m - (K - k)] = a[t][m];
    }
  }
}

template <int K>
int launch_bucket(const float* rt, int n, int k, float* out, cudaStream_t stream) {
  constexpr int tile_q = kBlock * kQueries;
  kbest_kernel<K><<<(n + tile_q - 1) / tile_q, kBlock, 0, stream>>>(rt, n, k, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace knn_kbest

// Plain C entry point, loaded with ctypes.  Launches on `stream` and does
// not synchronise; returns cudaGetLastError() (0 on success).  n > 0 and
// 1 <= k <= 64, or cudaErrorInvalidValue and nothing is launched.
extern "C" int knn_kbest_launch(const void* rt, int n, int k, void* out, void* stream) {
  using namespace knn_kbest;
  if (n <= 0 || k < 1 || k > kMax) return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const float*>(rt);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((k + kStep - 1) / kStep) {
    case 1: return launch_bucket<8>(r, n, k, o, st);
    case 2: return launch_bucket<16>(r, n, k, o, st);
    case 3: return launch_bucket<24>(r, n, k, o, st);
    case 4: return launch_bucket<32>(r, n, k, o, st);
    case 5: return launch_bucket<40>(r, n, k, o, st);
    case 6: return launch_bucket<48>(r, n, k, o, st);
    case 7: return launch_bucket<56>(r, n, k, o, st);
    default: return launch_bucket<64>(r, n, k, o, st);
  }
}

extern "C" const char* knn_kbest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
