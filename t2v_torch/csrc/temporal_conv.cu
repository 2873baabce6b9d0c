// One layer of the TemporalConvBlock chain:
//   y = conv3d_(3,1,1)( silu( (x - mu) * inv * gn_scale + gn_bias ) ) + bias
//   [+ residual on the last layer], plus per-channel sum / sum^2 of the
//   bf16-rounded y (the next layer's GroupNorm statistics).
//
// Replaces: t2v/kernels/temporal_conv.py::_layer_kernel and, for long
// videos (125 frames at C = 1280, every 250-frame level),
// ::_chunked_layer_kernel (both driven by _layer and the chain _chain /
// temporal_conv_chain). The chunked TPU kernel exists because a full-frame
// tile overflows VMEM; its contract beyond the plain layer is that the
// GroupNorm statistics stay global and exact across frame chunks and that
// the neighbour frames beyond both ends of the video are zero AFTER the
// activation. Both hold here by construction: the statistics arrive
// finalised over the whole sample and leave as per-row-tile partials that
// the caller sums over every tile, and an out-of-range tap writes zeros
// into the A tile whatever frame the row tile sits in. Its halo operand
// and chunk grid are not carried over.
//
// What bounds it on the H100: at the UNet's shapes each layer is a GEMM of
// M = F*HW rows (frame, token) per sample, K = 3*C, N = C: 2*M*3C*C flops
// against ~2*M*C*2 bytes of activations, i.e. hundreds of flops per byte at
// C >= 320 -- above the card's ~295 flop/byte ridge, so the tensor cores
// bound it. The GroupNorm + SiLU prologue is elementwise work on the A
// operand that would otherwise cost a full read and write of the tensor.
//
// Design:
//  * implicit GEMM: a block owns a 64-row x 64-channel output tile of one
//    sample; the K loop walks the three frame taps and 32-channel slices.
//    Rows are (frame, token) pairs, so a tile may span frames (four of them
//    at a 4x4 level) and nothing limits the frame count: 250 frames at a
//    32x32 level are 4,000 row tiles of one sample. Offsets into x are
//    64-bit; the three taps of a tile re-read rows that neighbouring row
//    tiles load too, which the 50 MB L2 serves (a 250-frame sample at
//    C = 320 is 164 MB, a frame 0.66 MB).
//  * the A tile is built while loading: normalise with the finalised
//    per-channel [mu; 1/sigma] in f32, affine, SiLU, round to bf16. A row
//    whose source frame f + tap - 1 lies outside [0, F) is written as zeros
//    (Conv3d zero padding), not as SiLU(norm(0)).
//  * W (3, C, C) is streamed in 32 x 64 slices; it never sits whole in
//    shared memory (9.8 MB at C = 1280).
//  * bf16 WMMA tiles with f32 accumulation; 4 warps, each 32 x 32.
//  * epilogue in the JAX order: bf16(acc) + bf16(bias), then + residual in
//    bf16. Statistics are per-row-tile partials (B, n_row_tiles, 2, C)
//    written once each and summed afterwards by the caller: blocks run in
//    any order and nothing carries between them; no float atomics.
#include "common.cuh"

using namespace t2v;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int NT = 128;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(NT) temporal_conv_layer_kernel(
    const bf16* __restrict__ x, const float* __restrict__ fin,
    const float* __restrict__ gscale, const float* __restrict__ gbias,
    const bf16* __restrict__ w, const bf16* __restrict__ cbias,
    const bf16* __restrict__ residual, bf16* __restrict__ y,
    float* __restrict__ partial, int F, int HW, int C) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int M = F * HW;
  const size_t sample = (size_t)b * M * C;
  const float* mu = fin + (size_t)b * 2 * C;
  const float* inv = mu + C;

  FragAcc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 3; ++tap) {
    for (int c0 = 0; c0 < C; c0 += BK) {
      // A: normalised, activated input rows of frame f + tap - 1
      for (int v = tid; v < BM * BK / 8; v += NT) {
        const int r = v / (BK / 8);
        const int cv = (v % (BK / 8)) * 8;
        const int m = m0 + r;
        Pack8 out;
        out.u = zero_uint4();
        if (m < M) {
          const int f = m / HW;
          const int p = m - f * HW;
          const int fs = f + tap - 1;
          if (fs >= 0 && fs < F) {
            Pack8 in;
            in.u = *reinterpret_cast<const uint4*>(
                x + sample + ((size_t)fs * HW + p) * C + c0 + cv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int c = c0 + cv + e;
              const float xn = (in.get(e) - mu[c]) * inv[c] * gscale[c] + gbias[c];
              out.set(e, xn / (1.0f + expf(-xn)));
            }
          }
        }
        *reinterpret_cast<uint4*>(As + r * LDA + cv) = out.u;
      }
      // B: rows c0..c0+BK of tap's (C_in, C_out) weight, columns n0..n0+BN
      for (int v = tid; v < BK * BN / 8; v += NT) {
        const int r = v / (BN / 8);
        const int cv = (v % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * LDB + cv) =
            *reinterpret_cast<const uint4*>(
                w + ((size_t)tap * C + c0 + r) * C + n0 + cv);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA a[2];
        FragBRow bw[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bw[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN;
    const int col = e % BN;
    const int m = m0 + r;
    const int n = n0 + col;
    float out = 0.0f;
    if (m < M) {
      const size_t idx = sample + (size_t)m * C + n;
      out = round_bf16(round_bf16(Cs[r * LDC + col]) + __bfloat162float(cbias[n]));
      if (residual != nullptr) out = round_bf16(out + __bfloat162float(residual[idx]));
      y[idx] = __float2bfloat16(out);
    }
    Cs[r * LDC + col] = out;  // rows past M contribute 0 to the stats
  }

  if (partial == nullptr) return;
  __syncthreads();
  for (int col = tid; col < BN; col += NT) {
    float s = 0.0f, s2 = 0.0f;
    for (int r = 0; r < BM; ++r) {
      const float v = Cs[r * LDC + col];
      s += v;
      s2 += v * v;
    }
    float* dst = partial + ((size_t)b * gridDim.y + blockIdx.y) * 2 * C + n0 + col;
    dst[0] = s;
    dst[C] = s2;
  }
}

}  // namespace

extern "C" int t2v_temporal_conv_layer(const void* x, const void* fin, const void* gscale,
                                       const void* gbias, const void* w, const void* cbias,
                                       const void* residual, void* y, void* partial, int B,
                                       int F, int HW, int C, void* stream) {
  const dim3 grid(C / BN, (F * HW + BM - 1) / BM, B);
  temporal_conv_layer_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(fin),
      static_cast<const float*>(gscale), static_cast<const float*>(gbias),
      static_cast<const bf16*>(w), static_cast<const bf16*>(cbias),
      static_cast<const bf16*>(residual), static_cast<bf16*>(y),
      static_cast<float*>(partial), F, HW, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int t2v_temporal_conv_row_tiles(int F, int HW) { return (F * HW + BM - 1) / BM; }
