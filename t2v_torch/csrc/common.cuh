// Helpers shared by the port's CUDA kernels: bf16 <-> float through raw
// 16-bit words (so 16-byte vector loads can be unpacked without unions of
// non-trivial types), and the WMMA fragment types (bf16 in, f32 accumulate).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace t2v {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// eight bf16 values as one 16-byte word
struct Pack8 {
  uint4 u;
  __device__ __forceinline__ unsigned short raw(int i) const {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(&u);
    return s[i];
  }
  __device__ __forceinline__ float get(int i) const {
    return __bfloat162float(__ushort_as_bfloat16(raw(i)));
  }
  __device__ __forceinline__ void set(int i, float v) {
    reinterpret_cast<unsigned short*>(&u)[i] =
        __bfloat16_as_ushort(__float2bfloat16(v));
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint4 zero_uint4() { return make_uint4(0, 0, 0, 0); }

// bytes rounded up to 128 so every shared-memory region stays aligned for
// WMMA loads and 16-byte vector stores
__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

}  // namespace t2v
