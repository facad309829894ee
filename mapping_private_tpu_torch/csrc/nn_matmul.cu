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
// adds, one fused multiply-add and a compare-select; a ref is read once per
// block from device memory, so bytes are negligible.
//
// What the design does about that: the shape of nn_argmin.cu.  One thread
// owns one query and keeps (best_d, best_i) in registers; the block streams
// the refs through shared memory in ascending index with a strict '<', so
// ties need no cross-thread reduction.  r2 is computed once per ref while
// the tile is staged, not once per pair.  The row-major (nr, 3) refs are
// split into x/y/z rows in shared memory so a warp reads one word per
// coordinate as a broadcast, four refs per 16-byte load.  Products and sums
// are written with __fmul_rn/__fadd_rn so nvcc cannot contract them into
// FMAs and d2 matches the plain version bit for bit; the one FMA used,
// fma(-2, cross, q2 + r2), is exact in its product (a power of two), so it
// rounds like the two-step form.  The tail of the last tile is filled with
// NaN refs, whose d2 is NaN and never '<' anything.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 128;  // queries (threads) per block
constexpr int kTile = 2048;  // refs per shared-memory tile (32 KB: x/y/z/r2)

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ void consider(float qx, float qy, float qz, float q2,
                                         float rx, float ry, float rz, float r2,
                                         int j, float& best_d, int& best_i) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, rx), __fmul_rn(qy, ry)), __fmul_rn(qz, rz));
  const float d = __fmaf_rn(-2.0f, cross, __fadd_rn(q2, r2));
  if (d < best_d) {
    best_d = d;
    best_i = j;
  }
}

__global__ void __launch_bounds__(kBlock)
    nn_matmul_kernel(const float* __restrict__ q, int nq,
                     const float* __restrict__ r, int nr,
                     int* __restrict__ idx_out, float* __restrict__ sq_out) {
  __shared__ __align__(16) float sx[kTile];
  __shared__ __align__(16) float sy[kTile];
  __shared__ __align__(16) float sz[kTile];
  __shared__ __align__(16) float s2[kTile];

  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * static_cast<size_t>(i)];
    qy = q[3 * static_cast<size_t>(i) + 1];
    qz = q[3 * static_cast<size_t>(i) + 2];
  }
  const float q2 = sq_norm(qx, qy, qz);

  float best_d = CUDART_INF_F;
  int best_i = 0;
  for (int base = 0; base < nr; base += kTile) {
    const int n = min(kTile, nr - base);
    const int n4 = (n + 3) & ~3;  // walk whole float4s; tail padded below
    __syncthreads();  // previous tile fully consumed
    for (int j = threadIdx.x; j < n4; j += kBlock) {
      float x = CUDART_NAN_F, y = CUDART_NAN_F, z = CUDART_NAN_F;
      if (j < n) {
        const float* p = r + 3 * static_cast<size_t>(base + j);
        x = p[0];
        y = p[1];
        z = p[2];
      }
      sx[j] = x;
      sy[j] = y;
      sz[j] = z;
      s2[j] = sq_norm(x, y, z);
    }
    __syncthreads();
    const float4* sx4 = reinterpret_cast<const float4*>(sx);
    const float4* sy4 = reinterpret_cast<const float4*>(sy);
    const float4* sz4 = reinterpret_cast<const float4*>(sz);
    const float4* s24 = reinterpret_cast<const float4*>(s2);
#pragma unroll 2
    for (int j4 = 0; j4 < n4 / 4; ++j4) {
      const float4 x = sx4[j4], y = sy4[j4], z = sz4[j4], w = s24[j4];
      const int j = base + 4 * j4;
      consider(qx, qy, qz, q2, x.x, y.x, z.x, w.x, j, best_d, best_i);
      consider(qx, qy, qz, q2, x.y, y.y, z.y, w.y, j + 1, best_d, best_i);
      consider(qx, qy, qz, q2, x.z, y.z, z.z, w.z, j + 2, best_d, best_i);
      consider(qx, qy, qz, q2, x.w, y.w, z.w, w.w, j + 3, best_d, best_i);
    }
  }
  if (live) {
    idx_out[i] = best_i;
    sq_out[i] = best_d;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and does
// not synchronise; returns cudaGetLastError() (0 on success), so a refused
// launch is reported by the caller.
extern "C" int nn_matmul_launch(const void* q, int nq, const void* r, int nr,
                                void* idx, void* sq, void* stream) {
  if (nq <= 0 || nr <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nq + kBlock - 1) / kBlock);
  nn_matmul_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), nq, static_cast<const float*>(r), nr,
      static_cast<int*>(idx), static_cast<float*>(sq));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nn_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
