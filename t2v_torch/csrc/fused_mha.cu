// Self-attention over B independent short sequences (N < 512) read in the
// packed-head (B, N, H*64) layout that the q/k/v projections emit: head h
// is the strided 64-wide column slice [h*64, h*64 + 64) of every row, so
// there is no head fold and no transpose. f32 softmax; keys >= N masked.
//
// Replaces: t2v/kernels/fused_mha.py::_self_mha_kernel (driven by
// fused_self_mha; dispatched from t2v/kernels/attention.py::
// self_attention_packed for N < FLASH_MIN_KV). The TPU kernel's
// block-diagonal (bt*N)^2 packing was a workaround for the 128x128 MXU and
// is not part of the contract.
//
// What bounds it on the H100: the problems are tiny (N = 24 frames over
// 64-wide heads: 2*2*24*24*64 flops per head on 4*24*64*2 bytes), so the
// kernel moves q, k, v and o once and is bound by device memory and by
// how well 10,240 (sequence, head) problems fill 132 SMs.
//
// Design:
//  * each warp owns one (sequence, head, 16-row query tile) work item and
//    runs on its own: keys/values stream through the warp's shared-memory
//    slice in 32-row tiles with online softmax (N = 256 would need a
//    256 KB f32 score tile otherwise), synchronised with __syncwarp only;
//  * 4 warps, i.e. 4 work items, per block, so 2048 x 5 heads x 2 query
//    tiles at N = 24 make 5,120 blocks;
//  * bf16 WMMA with f32 accumulation; the ragged edge (N = 24 is not a
//    multiple of 16 or 32) is zero-filled on load and masked to -inf in
//    the scores.
#include "common.cuh"

using namespace t2v;

namespace {

constexpr int DH = 64;
constexpr int QT = 16;
constexpr int KT = 32;
constexpr int WARPS = 4;
constexpr int LDQ = DH + 8;
constexpr int LDS = KT + 4;
constexpr int LDP = KT + 8;
constexpr int LDO = DH + 4;
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + align128(QT * LDQ * 2);
constexpr int OFF_V = OFF_K + align128(KT * LDQ * 2);
constexpr int OFF_S = OFF_V + align128(KT * LDQ * 2);
constexpr int OFF_P = OFF_S + align128(QT * LDS * 4);
constexpr int OFF_O = OFF_P + align128(QT * LDP * 2);
constexpr int OFF_STATS = OFF_O + align128(QT * LDO * 4);
constexpr int WARP_BYTES = OFF_STATS + align128(3 * QT * 4);
constexpr int BLOCK_BYTES = WARPS * WARP_BYTES;

__global__ void __launch_bounds__(WARPS * 32) self_mha_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int B, int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_qt = (N + QT - 1) / QT;
  const long item = (long)blockIdx.x * WARPS + warp;
  if (item >= (long)B * H * n_qt) return;  // warp-uniform; no block barrier below
  const int qt = item % n_qt;
  const int bh = item / n_qt;
  const int b = bh / H;
  const int h = bh % H;
  const int hd = H * DH;
  const size_t base = (size_t)b * N * hd + (size_t)h * DH;
  const int q0 = qt * QT;

  unsigned char* ws = smem + warp * WARP_BYTES;
  bf16* Qs = reinterpret_cast<bf16*>(ws + OFF_Q);
  bf16* Ks = reinterpret_cast<bf16*>(ws + OFF_K);
  bf16* Vs = reinterpret_cast<bf16*>(ws + OFF_V);
  float* Ss = reinterpret_cast<float*>(ws + OFF_S);
  bf16* Ps = reinterpret_cast<bf16*>(ws + OFF_P);
  float* Os = reinterpret_cast<float*>(ws + OFF_O);
  float* m_s = reinterpret_cast<float*>(ws + OFF_STATS);
  float* l_s = m_s + QT;
  float* a_s = l_s + QT;

  for (int e = lane; e < QT * DH / 8; e += 32) {
    const int r = e / (DH / 8);
    const int c = (e % (DH / 8)) * 8;
    uint4 val = zero_uint4();
    if (q0 + r < N) val = *reinterpret_cast<const uint4*>(q + base + (size_t)(q0 + r) * hd + c);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) = val;
  }
  for (int e = lane; e < QT * DH; e += 32) Os[(e / DH) * LDO + e % DH] = 0.0f;
  if (lane < QT) {
    m_s[lane] = -CUDART_INF_F;
    l_s[lane] = 0.0f;
  }

  const int row = lane / 2;  // two lanes per query row
  const int sub = lane % 2;
  for (int kv0 = 0; kv0 < N; kv0 += KT) {
    for (int e = lane; e < KT * DH / 8; e += 32) {
      const int r = e / (DH / 8);
      const int c = (e % (DH / 8)) * 8;
      uint4 kval = zero_uint4(), vval = zero_uint4();
      if (kv0 + r < N) {
        kval = *reinterpret_cast<const uint4*>(k + base + (size_t)(kv0 + r) * hd + c);
        vval = *reinterpret_cast<const uint4*>(v + base + (size_t)(kv0 + r) * hd + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDQ + c) = kval;
      *reinterpret_cast<uint4*>(Vs + r * LDQ + c) = vval;
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        FragA a;
        FragBCol bk;
        wmma::load_matrix_sync(a, Qs + kk, LDQ);
        wmma::load_matrix_sync(bk, Ks + j * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Ss + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    {
      constexpr int CPT = KT / 2;
      float sv[CPT];
      float mloc = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = sub * CPT + c;
        const float s = (kv0 + col < N) ? Ss[row * LDS + col] * scale : -CUDART_INF_F;
        sv[c] = s;
        mloc = fmaxf(mloc, s);
      }
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mloc);
      const float m_use = (m_new == -CUDART_INF_F) ? 0.0f : m_new;
      float lsum = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(sv[c] - m_use);
        lsum += p;
        Ps[row * LDP + sub * CPT + c] = __float2bfloat16(p);
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      __syncwarp();
      if (sub == 0) {
        const float alpha = expf(m_old - m_use);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + lsum;
        m_s[row] = m_new;
      }
    }
    __syncwarp();

    for (int e = lane; e < QT * DH; e += 32) Os[(e / DH) * LDO + e % DH] *= a_s[e / DH];
    __syncwarp();

#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      FragAcc acc;
      wmma::load_matrix_sync(acc, Os + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        FragA a;
        FragBRow bv;
        wmma::load_matrix_sync(a, Ps + kk, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + j * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int e = lane; e < QT * DH; e += 32) {
    const int r = e / DH;
    const int c = e % DH;
    if (q0 + r < N) {
      const float l = l_s[r];
      const float safe = (l == 0.0f) ? 1.0f : l;
      o[base + (size_t)(q0 + r) * hd + c] = __float2bfloat16(Os[r * LDO + c] / safe);
    }
  }
}

}  // namespace

extern "C" int t2v_fused_self_mha(const void* q, const void* k, const void* v, void* o, int B,
                                  int N, int H, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(self_mha_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BLOCK_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long items = (long)B * H * ((N + QT - 1) / QT);
  const unsigned blocks = static_cast<unsigned>((items + WARPS - 1) / WARPS);
  self_mha_kernel<<<blocks, WARPS * 32, BLOCK_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), B, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}
