// Flash attention forward over head-folded (B, N, D) queries and (B, S, D)
// keys/values: online softmax over key/value tiles with an f32 running
// max, sum and accumulator; key columns >= S are masked and a row whose sum
// stays 0 is guarded against 0/0.
//
// Replaces: t2v/kernels/flash_attention.py::_flash_kernel (driven by
// flash_attention / _flash_call; the VAE mid-block attention reaches it
// through t2v/kernels/attention.py::attention).
//
// What bounds it on the H100: at the UNet's 32x32 level (N = S = 1024,
// D = 64) each (query tile, key tile) pair does 4*BQ*BKV*D flops on
// 2*BKV*D*2 bytes of K/V, which come from L2 after the first tile of a
// head; with the whole (N, S) score matrix kept on chip the kernel is
// bound by tensor-core work and the softmax's exponentials, not by device
// memory (q, k, v, o are 4 * 31 MB for all 240 heads).
//
// Design:
//  * one block of 4 warps per (batch*head, BQ-row query tile); K and V
//    stream through shared memory in BKV-row tiles; scores and the f32
//    accumulator live in shared memory, so the (N, S) matrix never reaches
//    device memory;
//  * bf16 WMMA tiles with f32 accumulation for both products; the softmax
//    runs on f32 scores, rescales the accumulator by exp(m_old - m_new),
//    and feeds bf16 probabilities to the second product (as the TPU kernel
//    feeds p.astype(v.dtype));
//  * templated on D, the head dim rounded up to a multiple of 16 (the WMMA
//    K step); the real head dim d <= D is a run-time argument: columns
//    d..D of the Q, K and V tiles are zero-filled on load, which adds
//    nothing to a dot product, and only d columns are written back (the
//    VideoCrafter UNet's 40-wide heads run under D = 48). D = 512 (the
//    VAE's single head) is the trap: a 64-row f32 accumulator there is
//    128 KB, so D = 512 takes 16-row query tiles and 32-row K/V tiles
//    (about 120 KB of dynamic shared memory, opted in with
//    cudaFuncSetAttribute); D <= 160 takes 64 x 64 tiles;
//  * the scale multiplies the f32 scores (for a power of two this equals
//    the TPU path's exact pre-scaling of q).
#include "common.cuh"

using namespace t2v;

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;

template <int D, int BQ, int BKV>
struct FlashSmem {
  static constexpr int LDQ = D + 8;     // bf16 Q / K / V rows
  static constexpr int LDS = BKV + 4;   // f32 scores
  static constexpr int LDP = BKV + 8;   // bf16 probabilities
  static constexpr int LDO = D + 4;     // f32 accumulator
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BQ * LDQ * 2);
  static constexpr int V = K + align128(BKV * LDQ * 2);
  static constexpr int S = V + align128(BKV * LDQ * 2);
  static constexpr int P = S + align128(BQ * LDS * 4);
  static constexpr int O = P + align128(BQ * LDP * 2);
  static constexpr int STATS = O + align128(BQ * LDO * 4);
  static constexpr int BYTES = STATS + align128(3 * BQ * 4);
};

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int N, int S, int d, float scale) {
  using L = FlashSmem<D, BQ, BKV>;
  constexpr int TPR = NT / BQ;  // threads per softmax row
  constexpr int CPT = BKV / TPR;  // columns per thread
  static_assert(TPR >= 1 && TPR <= 32 && (32 % TPR) == 0, "row group must tile a warp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);
  float* m_s = reinterpret_cast<float*>(smem + L::STATS);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const size_t bq = (size_t)blockIdx.y * N * d;
  const size_t bkv = (size_t)blockIdx.y * S * d;

  for (int e = tid; e < BQ * D / 8; e += NT) {
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    uint4 val = zero_uint4();
    if (q0 + r < N && c < d)
      val = *reinterpret_cast<const uint4*>(q + bq + (size_t)(q0 + r) * d + c);
    *reinterpret_cast<uint4*>(Qs + r * L::LDQ + c) = val;
  }
  for (int e = tid; e < BQ * D; e += NT) Os[(e / D) * L::LDO + e % D] = 0.0f;
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = -CUDART_INF_F;
    l_s[r] = 0.0f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    for (int e = tid; e < BKV * D / 8; e += NT) {
      const int r = e / (D / 8);
      const int c = (e % (D / 8)) * 8;
      uint4 kval = zero_uint4(), vval = zero_uint4();
      if (kv0 + r < S && c < d) {
        kval = *reinterpret_cast<const uint4*>(k + bkv + (size_t)(kv0 + r) * d + c);
        vval = *reinterpret_cast<const uint4*>(v + bkv + (size_t)(kv0 + r) * d + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * L::LDQ + c) = kval;
      *reinterpret_cast<uint4*>(Vs + r * L::LDQ + c) = vval;
    }
    __syncthreads();

    // scores = Q K^T
    for (int t = warp; t < (BQ / 16) * (BKV / 16); t += NW) {
      const int i = t / (BKV / 16);
      const int j = t % (BKV / 16);
      FragAcc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        FragA a;
        FragBCol bk;
        wmma::load_matrix_sync(a, Qs + i * 16 * L::LDQ + kk, L::LDQ);
        wmma::load_matrix_sync(bk, Ks + j * 16 * L::LDQ + kk, L::LDQ);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Ss + i * 16 * L::LDS + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, TPR threads per query row
    {
      const int row = tid / TPR;
      const int sub = tid % TPR;
      float sv[CPT];
      float mloc = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = sub * CPT + c;
        const float s = (kv0 + col < S) ? Ss[row * L::LDS + col] * scale : -CUDART_INF_F;
        sv[c] = s;
        mloc = fmaxf(mloc, s);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mloc);
      const float m_use = (m_new == -CUDART_INF_F) ? 0.0f : m_new;
      float lsum = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(sv[c] - m_use);
        lsum += p;
        Ps[row * L::LDP + sub * CPT + c] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      __syncwarp();
      if (sub == 0) {
        const float alpha = expf(m_old - m_use);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + lsum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < BQ * D; e += NT) Os[(e / D) * L::LDO + e % D] *= a_s[e / D];
    __syncthreads();

    // acc += P V
    for (int t = warp; t < (BQ / 16) * (D / 16); t += NW) {
      const int i = t / (D / 16);
      const int j = t % (D / 16);
      FragAcc acc;
      wmma::load_matrix_sync(acc, Os + i * 16 * L::LDO + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        FragA a;
        FragBRow bv;
        wmma::load_matrix_sync(a, Ps + i * 16 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(bv, Vs + kk * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + i * 16 * L::LDO + j * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D;
    const int c = e % D;
    if (q0 + r < N && c < d) {
      const float l = l_s[r];
      const float safe = (l == 0.0f) ? 1.0f : l;
      o[bq + (size_t)(q0 + r) * d + c] = __float2bfloat16(Os[r * L::LDO + c] / safe);
    }
  }
}

template <int D, int BQ, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int N, int S, int d,
           float scale, cudaStream_t stream) {
  constexpr int bytes = FlashSmem<D, BQ, BKV>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, BQ, BKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BQ - 1) / BQ, B);
  flash_fwd_kernel<D, BQ, BKV><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), N, S, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// returns a CUDA error code; 1 (cudaErrorInvalidValue) for an unsupported
// head dim (not a multiple of 8, or above 160 and not 512)
extern "C" int t2v_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int B, int N, int S, int D, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 48) return launch<48, 64, 64>(q, k, v, o, B, N, S, D, scale, st);
  if (D <= 64) return launch<64, 64, 64>(q, k, v, o, B, N, S, D, scale, st);
  if (D <= 80) return launch<80, 64, 64>(q, k, v, o, B, N, S, D, scale, st);
  if (D <= 160) return launch<160, 64, 64>(q, k, v, o, B, N, S, D, scale, st);
  if (D == 512) return launch<512, 16, 32>(q, k, v, o, B, N, S, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
