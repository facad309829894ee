// Pair policies of nn_search.cuh that more than one kernel uses.
//
// Every distance is written with __fsub_rn/__fmul_rn/__fadd_rn so nvcc
// cannot contract it into FMAs: its last bit then matches the plain
// PyTorch versions, and near-tie indices do not flip.
//
// * DirectPair: d2 = (dx*dx + dy*dy) + dz*dz from direct differences, over
//   refs as (3, nr) x/y/z rows (nn_argmin, nn_gather "vpu").
// * ExpansionForm: d2 = (q2 + r2) - 2*cross, q2 = (qx*qx + qy*qy) + qz*qz,
//   r2 likewise, cross = (qx*rx + qy*ry) + qz*rz, with r2 a fourth shared
//   row computed once per ref while staging.  fma(-2, cross, q2 + r2) has
//   an exact product (a power of two), so it rounds like the two-step
//   form.  It holds the distance only: nn_matmul stages it from (nr, 3)
//   refs, nn_gather ("mxu", "mxu_fast") from (3, nr) rows.
//
// A pair that nn_gather.cu uses also says in staged(x, y, z) what one ref
// of (3, nr) rows puts in its shared rows, so that a distance recomputed
// from device memory has the bits of the one the search loop computed.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nn_search.cuh"

namespace nn_search {

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

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

  // the rows as they lie in device memory
  static __device__ __forceinline__ float4 staged(float x, float y, float z) {
    return make_float4(x, y, z, 0.f);
  }

  // The tail is filled with +inf refs: d2 = +inf, never '<' anything.
  // (Written per row, not through staged(): nn_argmin took 1% longer at
  // every shape that way, measured on an H100, 700 W.)
  static __device__ __forceinline__ void stage(const float* __restrict__ rt, int nr, int base,
                                               int n, int n_pad, float (*s)[kTile]) {
    const float* rx = rt + base;
    const float* ry = rx + static_cast<size_t>(nr);
    const float* rz = ry + static_cast<size_t>(nr);
    for (int j = threadIdx.x; j < n_pad; j += kBlock) {
      const bool in = j < n;
      s[0][j] = in ? rx[j] : CUDART_INF_F;
      s[1][j] = in ? ry[j] : CUDART_INF_F;
      s[2][j] = in ? rz[j] : CUDART_INF_F;
    }
  }
};

struct ExpansionForm {
  static constexpr int kRows = 4;  // x, y, z, r2

  struct Query {
    float x, y, z, q2;  // x, y, z: what enters the cross term
  };

  static __device__ __forceinline__ Query query(float qx, float qy, float qz) {
    return {qx, qy, qz, sq_norm(qx, qy, qz)};
  }

  static __device__ __forceinline__ float dist(const Query& q, float rx, float ry,
                                               float rz, float r2) {
    const float cross = __fadd_rn(__fadd_rn(__fmul_rn(q.x, rx), __fmul_rn(q.y, ry)),
                                  __fmul_rn(q.z, rz));
    return __fmaf_rn(-2.0f, cross, __fadd_rn(q.q2, r2));
  }
};

}  // namespace nn_search
