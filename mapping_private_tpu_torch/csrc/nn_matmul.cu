// Matmul-form 1-NN for Hopper (sm_90a).
//
// Replaces mapping_private_tpu/ops/pallas_nn.py::_nn_kernel (the Pallas TPU
// kernel behind nn_pallas): nearest ref index and squared distance in the
// expansion form d2 = q2 + r2 - 2 q.r, the cross term computed here in the
// kernel's body.
//
// Contract (shared with nn_matmul_plain in ops/nn_matmul.py):
//   q   (nq, 3) f32 row-major queries.
//   r   (nr, 3) f32 row-major refs; dead refs carry +PAD_COORD.
//   idx (nq,) int32, sq (nq,) f32, with every product and sum rounded to f32
//   on its own, in this order:
//     q2    = (qx*qx + qy*qy) + qz*qz        r2 likewise
//     cross = (qx*rx + qy*ry) + qz*rz
//     d2    = (q2 + r2) - 2*cross
//   The lowest ref index wins among equal d2 (the TPU kernel's first index
//   inside a ref tile and strict '<' across tiles amount to the same).  d2
//   is not clamped: cancellation can leave it slightly negative, as in the
//   TPU kernel.
//
// What bounds it: FP32 issue slots.  Per query-ref pair 3 multiplies, 3
// adds and one fused multiply-add, plus finding the minimum; a ref is read
// once per block from device memory, so bytes are negligible.
//
// What the design does about that is in nn_search.cuh, the skeleton shared
// with nn_argmin.cu and nn_gather.cu: refs split across blocks, two queries per thread, a
// tree minimum of 8 distances in the hot loop, the index found afterwards
// in one group, a
// merge by the last block in ascending stretch order (a slightly negative
// d2 needs no special care there: the merge compares floats, not bits).
// The distance is nn_pairs.cuh's ExpansionForm, which nn_gather.cu's "mxu"
// modes share (written so that d2 matches the plain version bit for bit).
// This file adds the staging: r2 is computed once per ref while the tile is
// staged, not once per pair, and the row-major (nr, 3) refs are split into
// x/y/z/r2 rows in shared memory so a warp reads one word per row as a
// broadcast, four refs per 16-byte load.  The tail of a tile is filled with NaN
// refs: their d2 is NaN, which fminf drops and which is never '<' or '=='
// anything (+inf refs would give inf - inf).

#include "nn_pairs.cuh"
#include "nn_search.cuh"

namespace {

using nn_search::sq_norm;

// the distance is nn_pairs.cuh's; the staging reads (nr, 3) refs
struct ExpansionPair : nn_search::ExpansionForm {
  static __device__ __forceinline__ void stage(const float* __restrict__ r, int,
                                               int base, int n, int n_pad,
                                               float (*s)[nn_search::kTile]) {
    for (int j = threadIdx.x; j < n_pad; j += nn_search::kBlock) {
      float x = CUDART_NAN_F, y = CUDART_NAN_F, z = CUDART_NAN_F;
      if (j < n) {
        const float* p = r + 3 * static_cast<size_t>(base + j);
        x = p[0];
        y = p[1];
        z = p[2];
      }
      s[0][j] = x;
      s[1][j] = y;
      s[2][j] = z;
      s[3][j] = sq_norm(x, y, z);
    }
  }
};

}  // namespace

// Plain C entry point, loaded with ctypes; see nn_search::launch.
extern "C" int nn_matmul_launch(const void* q, int nq, const void* r, int nr,
                                int stretch, int rows, void* part_d, void* part_i,
                                int n_counters, void* counters, void* idx, void* sq,
                                void* stream) {
  return nn_search::launch<ExpansionPair, nn_search::StoreIndex>(
      q, nq, r, nr, stretch, rows, part_d, part_i, n_counters, counters,
      {static_cast<int*>(idx), static_cast<float*>(sq)}, stream);
}

extern "C" const char* nn_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
