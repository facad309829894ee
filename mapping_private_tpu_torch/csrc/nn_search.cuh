// Skeleton shared by the exact 1-NN searches for Hopper (sm_90a):
// nn_argmin.cu, nn_matmul.cu and nn_gather.cu instantiate it with a "pair"
// policy that says how a tile of refs is staged and how one query-ref
// distance is computed (the shared ones are in nn_pairs.cuh), and an
// "output" policy that says what becomes of each query's final (least d2,
// lowest index): stored as they are, or turned into the gathered rows of
// the winner's tie window.  Everything else is here: the split of the refs
// across blocks, the hot loop, the late search for the index and the merge.
//
// What bounds such a search: FP32 issue slots.  A pair costs 8 or 7
// arithmetic instructions that must not be fused (the squared distance is
// part of the contract bit for bit) and moves no device-memory bytes to
// speak of, so the card is as fast as its schedulers can issue: one warp
// instruction per clock on each of 4 schedulers per SM.  Three things keep
// a scheduler from that rate: SMs that get more blocks than others,
// instructions beside the arithmetic, and the 16-byte shared-memory loads
// that bring the refs, each of which costs a scheduler about four slots
// (measured: with one more load per four refs and one arithmetic
// instruction fewer per pair, nn_matmul takes nn_argmin's time).
//
// What the design does about that:
//
// * Refs split across blocks.  The queries alone give too few blocks to
//   share evenly among 132 SMs (79 tiles of 256 at 20,000 queries), so
//   gridDim.y blocks share a query tile, each searching one contiguous
//   stretch of the refs; the wrapper picks the number that fills the last
//   round of blocks (5 x 79 = 395 = 2.99 a SM).  Every block writes its
//   (d2, index) to a workspace; the block that finishes last for its query
//   tile (one atomic ticket per block) merges the stretches in ascending
//   order with a strict '<' and resets the ticket counter, so the result
//   does not depend on which block was last, no second launch is needed and
//   the counters are zero again when the kernel ends.  With one stretch the
//   block writes the outputs itself and touches no workspace.
// * No serial minimum per ref, and the index found late.  The hot loop
//   takes the minimum of kGroup distances as a tree and only then looks at
//   the running best: one compare and two predicated moves per group keep
//   (least d2 so far, first group that reached it).  Per pair that is the
//   arithmetic plus one min and 3/kGroup instructions more, where a running
//   (d2, index) per ref costs a compare and two selects that each wait for
//   the one before.  The strict '<' between groups and the ascending walk
//   keep the first group that holds the tile's minimum; after the tile, a
//   thread whose best improved recomputes that one group from shared memory
//   (the same instructions, so the same bits) and takes the first ref in it
//   that equals the minimum: the lowest index on exact ties.  Nothing in
//   the hot loop diverges, whatever the order of the refs and however many
//   ties there are.
// * kQueries queries per thread.  Each group of refs is loaded once and
//   used for every query of the thread, which halves the loads per pair,
//   and the queries' independent arithmetic hides latency inside one warp:
//   from 3 resident warps per scheduler on, the time no longer depends on
//   how many there are.
// * Staging is a plain copy between two barriers: another block of the SM
//   computes while one waits for its tile, and no time was found to win by
//   overlapping the copy inside a block.
//
// The ragged ends are masked here: the output policy is told which queries
// lie past nq, and a tile's tail up to a whole group is filled by the pair
// policy with refs that never win.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace nn_search {

constexpr int kBlock = 128;        // threads per block
constexpr int kQueries = 2;        // queries per thread
constexpr int kTile = 2048;        // refs per shared-memory tile
constexpr int kGroup = 8;          // refs per tree minimum; a multiple of 4

// A pair policy provides:
//   kRows                      floats kept per ref in shared memory (3 or 4)
//   Query, query(qx, qy, qz)   what a thread keeps of a query, and how it is made
//   dist(query, x, y, z, w)    the squared distance to the ref whose rows hold
//                              x, y, z (and w where kRows == 4)
//   stage(refs, nr, base, n, n_pad, s)
//                              all threads: copy refs [base, base + n) into
//                              s[row][0, n) and fill [n, n_pad) with refs whose
//                              distance is never '<' anything
//
// An output policy provides:
//   Args                       its outputs and extra inputs, one struct passed
//                              by value to the kernel
//   kTies                      whether it is told of ties (below); carrying the
//                              flag costs about 2 instructions a group of refs
//   write(args, query, refs, nr, i, live, d2, idx, tie)
//                              called once per query slot of a thread, by all
//                              32 lanes of a warp together (it may shuffle with
//                              a full mask): query i's final least d2 and the
//                              lowest index that reaches it; with kTies, `tie`
//                              is false only if no other ref has that d2 (true
//                              may also mean an equal d2 the search could not
//                              rule out); `live` is false for a slot past nq,
//                              whose other arguments mean nothing

// The output of nn_argmin and nn_matmul: the index and d2 as they are.
struct StoreIndex {
  static constexpr bool kTies = false;

  struct Args {
    int* idx;
    float* sq;
  };

  template <class Query>
  static __device__ __forceinline__ void write(const Args& a, const Query&, const float*, int,
                                               int i, bool live, float d, int ix, bool) {
    if (live) {
      a.idx[i] = ix;
      a.sq[i] = d;
    }
  }
};

// One group of refs out of shared memory: kGroup / 4 16-byte loads per row,
// each a broadcast (every thread of the warp reads the same words).
template <class Pair>
__device__ __forceinline__ void load_group(const float (*s)[kTile], int j,
                                           float4 (&r)[Pair::kRows][kGroup / 4]) {
#pragma unroll
  for (int row = 0; row < Pair::kRows; ++row) {
#pragma unroll
    for (int k = 0; k < kGroup / 4; ++k)
      r[row][k] = *reinterpret_cast<const float4*>(&s[row][j + 4 * k]);
  }
}

template <class Pair>
__device__ __forceinline__ void group_dists(const typename Pair::Query& qu,
                                            const float4 (&r)[Pair::kRows][kGroup / 4],
                                            float (&d)[kGroup]) {
#pragma unroll
  for (int k = 0; k < kGroup / 4; ++k) {
    const float4 x = r[0][k], y = r[1][k], z = r[2][k];
    const float4 w = r[Pair::kRows - 1][k];  // the fourth row where there is one
    d[4 * k] = Pair::dist(qu, x.x, y.x, z.x, w.x);
    d[4 * k + 1] = Pair::dist(qu, x.y, y.y, z.y, w.y);
    d[4 * k + 2] = Pair::dist(qu, x.z, y.z, z.z, w.z);
    d[4 * k + 3] = Pair::dist(qu, x.w, y.w, z.w, w.w);
  }
}

template <class Pair, class Out>
__global__ void __launch_bounds__(kBlock)
    search_kernel(const float* __restrict__ q, int nq, const float* __restrict__ refs,
                  int nr, int stretch, float* part_d, int* part_i,
                  unsigned int* counters, const typename Out::Args out) {
  __shared__ __align__(16) float s[Pair::kRows][kTile];
  __shared__ bool merges;

  // query t of this thread; consecutive threads own consecutive queries
  const int i0 = blockIdx.x * (kBlock * kQueries) + threadIdx.x;
  typename Pair::Query qu[kQueries];
  float best_d[kQueries];
  int best_i[kQueries];
  bool tie[kQueries];  // with Out::kTies: another ref may have best_d
#pragma unroll
  for (int t = 0; t < kQueries; ++t) {
    const int i = i0 + t * kBlock;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (i < nq) {
      qx = q[3 * static_cast<size_t>(i)];
      qy = q[3 * static_cast<size_t>(i) + 1];
      qz = q[3 * static_cast<size_t>(i) + 2];
    }
    qu[t] = Pair::query(qx, qy, qz);
    best_d[t] = CUDART_INF_F;
    best_i[t] = 0;
    tie[t] = false;
  }

  const int begin = blockIdx.y * stretch;
  const int end = min(nr, begin + stretch);
  for (int base = begin; base < end; base += kTile) {
    const int n = min(kTile, end - base);
    const int n_pad = (n + kGroup - 1) / kGroup * kGroup;
    __syncthreads();  // previous tile fully consumed
    Pair::stage(refs, nr, base, n, n_pad, s);
    __syncthreads();
    float run_d[kQueries];
    int run_g[kQueries];
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
      run_d[t] = best_d[t];
      run_g[t] = -1;
    }
#pragma unroll 2
    for (int j = 0; j < n_pad; j += kGroup) {
      float4 r[Pair::kRows][kGroup / 4];
      load_group<Pair>(s, j, r);
#pragma unroll
      for (int t = 0; t < kQueries; ++t) {
        float d[kGroup];
        group_dists<Pair>(qu[t], r, d);
#pragma unroll
        for (int w = kGroup / 2; w > 0; w /= 2) {
#pragma unroll
          for (int k = 0; k < w; ++k) d[k] = fminf(d[k], d[k + w]);
        }
        const bool better = d[0] < run_d[t];
        // a group that reaches the running best without beating it ties
        if constexpr (Out::kTies) tie[t] = !better && (tie[t] || d[0] == run_d[t]);
        if (better) {
          run_d[t] = d[0];
          run_g[t] = j;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
      if (run_g[t] >= 0) {  // the first group of this tile that holds its minimum
        float4 r[Pair::kRows][kGroup / 4];
        float d[kGroup];
        load_group<Pair>(s, run_g[t], r);
        group_dists<Pair>(qu[t], r, d);
        int hits = 0;
#pragma unroll
        for (int k = kGroup - 1; k >= 0; --k) {
          if (d[k] == run_d[t]) {
            best_d[t] = d[k];
            best_i[t] = base + run_g[t] + k;
            ++hits;
          }
        }
        if constexpr (Out::kTies) tie[t] = tie[t] || hits > 1;
      }
    }
  }

  if (gridDim.y == 1) {
#pragma unroll
    for (int t = 0; t < kQueries; ++t) {
      const int i = i0 + t * kBlock;
      Out::write(out, qu[t], refs, nr, i, i < nq, best_d[t], best_i[t], tie[t]);
    }
    return;
  }
  const size_t nq_s = static_cast<size_t>(nq);
#pragma unroll
  for (int t = 0; t < kQueries; ++t) {
    const int i = i0 + t * kBlock;
    if (i < nq) {
      part_d[blockIdx.y * nq_s + i] = best_d[t];
      // with kTies a tie is stored as ~index, < 0 (indices are < 2^31)
      part_i[blockIdx.y * nq_s + i] = Out::kTies && tie[t] ? ~best_i[t] : best_i[t];
    }
  }
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) {
    merges = atomicAdd(&counters[blockIdx.x], 1u) == gridDim.y - 1;
    if (merges) counters[blockIdx.x] = 0u;  // every block of the tile has its ticket
  }
  __syncthreads();
  if (!merges) return;
  __threadfence();
  for (int t = 0; t < kQueries; ++t) {  // every lane takes every turn: write() is warp-wide
    const int i = i0 + t * kBlock;
    const bool live = i < nq;
    float d = CUDART_INF_F;
    int ix = 0;
    if (live) {
      // __ldcg reads from L2, where the other blocks' stores are
      d = __ldcg(&part_d[i]);
      ix = __ldcg(&part_i[i]);
      for (unsigned int k = 1; k < gridDim.y; ++k) {
        const float dk = __ldcg(&part_d[k * nq_s + i]);
        const int ik = __ldcg(&part_i[k * nq_s + i]);
        if constexpr (Out::kTies) {
          // an equal partial ties; a smaller one brings its own flag
          if (dk == d && ix >= 0) ix = ~ix;
        }
        if (dk < d) {
          d = dk;
          ix = ik;
        }
      }
    }
    // qu[t] picked by constant indices: indexed by t, the array would live
    // in local memory
    typename Pair::Query qt = qu[0];
#pragma unroll
    for (int k = 1; k < kQueries; ++k)
      if (t == k) qt = qu[k];
    const bool t_ix = Out::kTies && ix < 0;
    Out::write(out, qt, refs, nr, i, live, d, t_ix ? ~ix : ix, t_ix);
  }
}

// Launches on `stream` and does not synchronise; returns cudaGetLastError()
// (0 on success).  The caller owns the geometry of the split: `stretch` refs
// go to each block of a query tile, which makes ceil(nr / stretch) stretches.
// More than one needs a workspace of `rows` x nq floats and ints and
// `n_counters` zeroed ticket counters, one per query tile of kBlock x
// kQueries queries; a grid that would write past either is refused with
// cudaErrorInvalidValue and nothing is launched.  `out` holds the output
// policy's pointers.
template <class Pair, class Out>
int launch(const void* q, int nq, const void* refs, int nr, int stretch, int rows,
           void* part_d, void* part_i, int n_counters, void* counters,
           const typename Out::Args& out, void* stream) {
  if (nq <= 0 || nr <= 0 || stretch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int tile_q = kBlock * kQueries;
  const dim3 grid((nq + tile_q - 1) / tile_q, (nr + stretch - 1) / stretch);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  if (grid.y > 1u && (!part_d || !part_i || !counters || rows < 0 || n_counters < 0 ||
                      grid.y > static_cast<unsigned>(rows) ||
                      grid.x > static_cast<unsigned>(n_counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  search_kernel<Pair, Out><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), nq, static_cast<const float*>(refs), nr, stretch,
      static_cast<float*>(part_d), static_cast<int*>(part_i),
      static_cast<unsigned int*>(counters), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nn_search
