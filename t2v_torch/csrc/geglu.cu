// GEGLU combine: out = h * gelu_erf(gate) over a packed (rows, 2*inner)
// projection [h | gate] -> (rows, inner), computed in f32 and rounded once
// to bf16.
//
// Replaces: t2v/kernels/geglu.py::_geglu_kernel (driven by geglu_pallas and
// the dispatch entry geglu). The TPU kernel evaluates erf with the
// Abramowitz-Stegun 7.1.26 polynomial because Pallas on the TPU has no erf
// lowering, and sizes its row block to the VMEM budget; neither is part of
// the contract. Here erf is the CUDA math library's erff.
//
// What bounds it on the H100: it is a pure bandwidth pass. Each output
// value reads 4 bytes (h and gate) and writes 2, for about 20 flops of
// erff and products, far below the 295 flops a byte where the tensor cores
// would take over; at (49152, 2560) it moves 377.5 MB.
//
// Design: one thread owns 8 consecutive columns of one row: a 16-byte load
// of h, a 16-byte load of gate `inner` columns further on the same row, and
// a 16-byte store, so neighbouring threads touch neighbouring 16-byte words.
// The wrapper requires inner % 8 == 0 and 16-byte aligned rows (every
// ModelScope inner is 1280, 2560 or 5120). A grid-stride loop over the
// (row, 8-column group) items keeps the grid at a few blocks per SM.
#include "common.cuh"

using namespace t2v;

namespace {

constexpr int THREADS = 256;
constexpr float RSQRT2 = 0.70710678118654752f;

__global__ void __launch_bounds__(THREADS) geglu_kernel(const bf16* __restrict__ proj,
                                                        bf16* __restrict__ out, long rows,
                                                        int inner) {
  const int groups = inner / 8;
  const long items = rows * groups;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < items;
       i += (long)gridDim.x * THREADS) {
    const long r = i / groups;
    const int c = static_cast<int>(i - r * groups) * 8;
    const bf16* row = proj + r * 2 * inner;
    Pack8 h, g, o;
    h.u = *reinterpret_cast<const uint4*>(row + c);
    g.u = *reinterpret_cast<const uint4*>(row + inner + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float gv = g.get(j);
      const float act = 0.5f * gv * (1.0f + erff(gv * RSQRT2));
      o.set(j, h.get(j) * act);
    }
    *reinterpret_cast<uint4*>(out + r * inner + c) = o.u;
  }
}

}  // namespace

// proj (rows, 2*inner) bf16 -> out (rows, inner) bf16. Returns a CUDA error
// code; 1 (cudaErrorInvalidValue) for an inner that is not a multiple of 8.
extern "C" int t2v_geglu(const void* proj, void* out, long rows, int inner, void* stream) {
  if (inner <= 0 || inner % 8 != 0 || rows < 0) return 1;
  if (rows == 0) return 0;
  const long items = rows * (inner / 8);
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long want = (items + THREADS - 1) / THREADS;
  const long cap = (long)sms * 8;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  geglu_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(proj), static_cast<bf16*>(out), rows, inner);
  return static_cast<int>(cudaGetLastError());
}
