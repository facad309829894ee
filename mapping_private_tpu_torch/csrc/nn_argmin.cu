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
// with nn_matmul.cu and nn_gather.cu: the refs are split across blocks so that 20,000
// queries fill the card, a thread searches for two queries with each ref it
// loads, the hot loop takes a tree minimum of 8 distances and carries only
// (least d2, first group that reached it), and the index is found
// afterwards in that one group.  The pair is nn_pairs.cuh's DirectPair,
// which nn_gather.cu's "vpu" mode shares: x/y/z rows staged as they lie in
// device memory, the tail of a tile filled with +inf refs (d2 = +inf, never
// '<' anything), and d2 written so that nvcc cannot contract it into FMAs.
// All threads of a warp read the same shared-memory words (a broadcast, no
// bank conflicts), four refs per 16-byte load.

#include "nn_pairs.cuh"
#include "nn_search.cuh"

// Plain C entry point, loaded with ctypes; see nn_search::launch.
extern "C" int nn_argmin_launch(const void* q, int nq, const void* rt, int nr,
                                int stretch, int rows, void* part_d, void* part_i,
                                int n_counters, void* counters, void* idx, void* sq,
                                void* stream) {
  return nn_search::launch<nn_search::DirectPair, nn_search::StoreIndex>(
      q, nq, rt, nr, stretch, rows, part_d, part_i, n_counters, counters,
      {static_cast<int*>(idx), static_cast<float*>(sq)}, stream);
}

extern "C" const char* nn_argmin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
