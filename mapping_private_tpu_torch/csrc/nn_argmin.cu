// Exact 1-NN argmin for Hopper (sm_90a).
//
// Replaces mapping_private_tpu/ops/pallas_nn.py::_make_argmin_kernel (the
// Pallas TPU kernel behind nn_argmin_prepared), the correspondence search
// of every ICP sweep.
//
// Contract (shared with nn_argmin_plain in ops/nn_argmin.py):
//   q   (nq, 3) f32 row-major queries; dead queries carry -PAD_COORD.
//   rt  (3, nr) f32 x/y/z rows (prepare_nn_ref_argmin); dead refs +PAD_COORD.
//   idx (nq,) int32, sq (nq,) f32: index and squared distance of the
//   nearest ref, d2 = (dx*dx + dy*dy) + dz*dz from direct differences;
//   exact ties go to the lowest ref index.
//
// What bounds it: FP32 issue slots.  Each query-ref pair costs 3 subtracts,
// 3 multiplies and 2 adds that must stay unfused, plus finding the minimum,
// and no device-memory bytes to speak of: a ref is read once per block from
// device memory (from L2 by all blocks but the first) and then from shared
// memory by every thread of the block.
//
// What the design does about that is in nn_search.cuh, the skeleton shared
// with nn_matmul.cu: the refs are split across blocks so that 20,000
// queries fill the card, a thread searches for two queries with each ref it
// loads, the hot loop takes a tree minimum of 8 distances and carries only
// (least d2, first group that reached it), and the index is found
// afterwards in that one group.  This file adds the pair: x/y/z
// rows staged as they lie in device memory, the tail of a tile filled with
// +inf refs (d2 = +inf, never '<' anything), and d2 written with
// __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract it into FMAs: the
// last bit of d2 then matches the plain version and near-tie indices do not
// flip.  All threads of a warp read the same shared-memory words (a
// broadcast, no bank conflicts), four refs per 16-byte load.

#include "nn_search.cuh"

namespace {

struct DirectPair {
  static constexpr int kRows = 3;

  struct Query {
    float x, y, z;
  };

  static __device__ __forceinline__ Query query(float qx, float qy, float qz) {
    return {qx, qy, qz};
  }

  static __device__ __forceinline__ float dist(const Query& q, float rx, float ry,
                                               float rz, float) {
    const float dx = __fsub_rn(q.x, rx);
    const float dy = __fsub_rn(q.y, ry);
    const float dz = __fsub_rn(q.z, rz);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }

  static __device__ __forceinline__ void stage(const float* __restrict__ rt, int nr,
                                               int base, int n, int n_pad,
                                               float (*s)[nn_search::kTile]) {
    const float* rx = rt + base;
    const float* ry = rx + static_cast<size_t>(nr);
    const float* rz = ry + static_cast<size_t>(nr);
    for (int j = threadIdx.x; j < n_pad; j += nn_search::kBlock) {
      const bool in = j < n;
      s[0][j] = in ? rx[j] : CUDART_INF_F;
      s[1][j] = in ? ry[j] : CUDART_INF_F;
      s[2][j] = in ? rz[j] : CUDART_INF_F;
    }
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes; see nn_search::launch.
extern "C" int nn_argmin_launch(const void* q, int nq, const void* rt, int nr,
                                int stretch, int rows, void* part_d, void* part_i,
                                int n_counters, void* counters, void* idx, void* sq,
                                void* stream) {
  return nn_search::launch<DirectPair>(q, nq, rt, nr, stretch, rows, part_d, part_i,
                                  n_counters, counters, idx, sq, stream);
}

extern "C" const char* nn_argmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
