// Packed-head attention over short key sequences, read in the (B, N, H*D)
// layout that the q/k/v projections emit: head h is the strided D-wide
// column slice [h*D, h*D + D) of every row, so there is no head fold and no
// transpose. f32 softmax; keys past the sequence end are masked. Two kernels:
//
//  * packed_mha_kernel: q (B, N, H*D) over k/v (B, S, H*D), any N and S,
//    keys streamed with an online softmax. The self-attention entry
//    (S = N < 512) and cross-attention over contexts too long for the kernel
//    below go here.
//  * cross_mha_kernel: q (B, N, H*D) with many rows over a short context
//    k/v (B, S, H*D), S <= 128 (the 77-token text context): K and V of one
//    head sit whole in shared memory and are shared by every query tile of
//    the block, so the scores of a tile are complete and need no online
//    rescaling.
//
// Replaces: t2v/kernels/fused_mha.py::_self_mha_kernel (driven by
// fused_self_mha; dispatched from t2v/kernels/attention.py::
// self_attention_packed for N < FLASH_MIN_KV) and
// t2v/kernels/fused_mha.py::_cross_mha_kernel (driven by fused_cross_mha;
// dispatched from cross_attention_packed for S < FLASH_MIN_KV). The TPU
// self kernel's block-diagonal (bt*N)^2 packing and the cross kernel's
// row-block budget were workarounds for the 128x128 MXU and VMEM and are not
// part of the contract.
//
// What bounds them on the H100: the problems are tiny (N = 24 frames over
// 64-wide heads: 2*2*24*24*64 flops per head on 4*24*64*2 bytes; 77 keys
// per query row in the cross case: 4*77*D flops on 4*D bytes of q and o),
// so both move q, k, v and o once and are bound by device memory and by
// how well the (sequence, head, tile) items fill 132 SMs.
//
// Design:
//  * the head dim is a template parameter DP, a multiple of 16 (the WMMA
//    K step); a head of D <= DP columns (D = 40 under DP = 48) is
//    zero-filled to DP on load, which adds nothing to a dot product, and
//    only its D columns are written back;
//  * self: each warp owns one (sequence, head, 16-row query tile) item and
//    runs on its own: keys/values stream through the warp's shared-memory
//    slice in 32-row tiles with online softmax (N = 256 would need a
//    256 KB f32 score tile otherwise), synchronised with __syncwarp only;
//    4 warps, i.e. 4 items, per block;
//  * cross: a block owns (sample, head, a run of query tiles); its 4 warps
//    walk the run's 16-row tiles over the block's K/V. The context is
//    padded to a multiple of 16 rows and masked to -inf in the scores;
//  * bf16 WMMA with f32 accumulation; ragged edges are zero-filled on load
//    and masked in the scores.
#include "common.cuh"

using namespace t2v;

namespace {

constexpr int QT = 16;
constexpr int KT = 32;
constexpr int WARPS = 4;

template <int DP>
struct StreamSmem {
  static constexpr int LDQ = DP + 8;
  static constexpr int LDS = KT + 4;
  static constexpr int LDP = KT + 8;
  static constexpr int LDO = DP + 4;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + align128(QT * LDQ * 2);
  static constexpr int OFF_V = OFF_K + align128(KT * LDQ * 2);
  static constexpr int OFF_S = OFF_V + align128(KT * LDQ * 2);
  static constexpr int OFF_P = OFF_S + align128(QT * LDS * 4);
  static constexpr int OFF_O = OFF_P + align128(QT * LDP * 2);
  static constexpr int OFF_STATS = OFF_O + align128(QT * LDO * 4);
  static constexpr int WARP_BYTES = OFF_STATS + align128(3 * QT * 4);
  static constexpr int BLOCK_BYTES = WARPS * WARP_BYTES;
};

// rows [r0, r0 + rows) of one head's D-wide column slice -> a zero-filled
// (rows, DP) shared-memory tile with leading dimension ld; n_valid rows exist
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, size_t row_stride,
                                          int r0, int rows, int n_valid, int D, int lane,
                                          int nthreads) {
  for (int e = lane; e < rows * DP / 8; e += nthreads) {
    const int r = e / (DP / 8);
    const int c = (e % (DP / 8)) * 8;
    uint4 val = zero_uint4();
    if (r0 + r < n_valid && c < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(WARPS * 32) packed_mha_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int B, int N, int S, int H, int D, float scale) {
  using L = StreamSmem<DP>;
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
  const int hd = H * D;
  const bf16* qb = q + (size_t)b * N * hd + (size_t)h * D;
  const bf16* kb = k + (size_t)b * S * hd + (size_t)h * D;
  const bf16* vb = v + (size_t)b * S * hd + (size_t)h * D;
  bf16* ob = o + (size_t)b * N * hd + (size_t)h * D;
  const int q0 = qt * QT;

  unsigned char* ws = smem + warp * L::WARP_BYTES;
  bf16* Qs = reinterpret_cast<bf16*>(ws + L::OFF_Q);
  bf16* Ks = reinterpret_cast<bf16*>(ws + L::OFF_K);
  bf16* Vs = reinterpret_cast<bf16*>(ws + L::OFF_V);
  float* Ss = reinterpret_cast<float*>(ws + L::OFF_S);
  bf16* Ps = reinterpret_cast<bf16*>(ws + L::OFF_P);
  float* Os = reinterpret_cast<float*>(ws + L::OFF_O);
  float* m_s = reinterpret_cast<float*>(ws + L::OFF_STATS);
  float* l_s = m_s + QT;
  float* a_s = l_s + QT;

  load_tile<DP>(Qs, L::LDQ, qb, hd, q0, QT, N, D, lane, 32);
  for (int e = lane; e < QT * DP; e += 32) Os[(e / DP) * L::LDO + e % DP] = 0.0f;
  if (lane < QT) {
    m_s[lane] = -CUDART_INF_F;
    l_s[lane] = 0.0f;
  }

  const int row = lane / 2;  // two lanes per query row
  const int sub = lane % 2;
  for (int kv0 = 0; kv0 < S; kv0 += KT) {
    load_tile<DP>(Ks, L::LDQ, kb, hd, kv0, KT, S, D, lane, 32);
    load_tile<DP>(Vs, L::LDQ, vb, hd, kv0, KT, S, D, lane, 32);
    __syncwarp();

#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        FragA a;
        FragBCol bk;
        wmma::load_matrix_sync(a, Qs + kk, L::LDQ);
        wmma::load_matrix_sync(bk, Ks + j * 16 * L::LDQ + kk, L::LDQ);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Ss + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    {
      constexpr int CPT = KT / 2;
      float sv[CPT];
      float mloc = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = sub * CPT + c;
        const float s = (kv0 + col < S) ? Ss[row * L::LDS + col] * scale : -CUDART_INF_F;
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
        Ps[row * L::LDP + sub * CPT + c] = __float2bfloat16(p);
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

    for (int e = lane; e < QT * DP; e += 32) Os[(e / DP) * L::LDO + e % DP] *= a_s[e / DP];
    __syncwarp();

#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      FragAcc acc;
      wmma::load_matrix_sync(acc, Os + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        FragA a;
        FragBRow bv;
        wmma::load_matrix_sync(a, Ps + kk, L::LDP);
        wmma::load_matrix_sync(bv, Vs + kk * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + j * 16, acc, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // walks the padded width so that row and column come from compile-time
  // divisions; columns D..DP are dropped
  for (int e = lane; e < QT * DP; e += 32) {
    const int r = e / DP;
    const int c = e % DP;
    if (q0 + r < N && c < D) {
      const float l = l_s[r];
      const float safe = (l == 0.0f) ? 1.0f : l;
      ob[(size_t)(q0 + r) * hd + c] = __float2bfloat16(Os[r * L::LDO + c] / safe);
    }
  }
}

// shared-memory layout of cross_mha_kernel for a context padded to SP rows
template <int DP>
struct CrossSmem {
  static constexpr int LDK = DP + 8;
  static constexpr int LDO = DP + 4;
  int lds, ldp, off_v, off_warps, off_s, off_p, off_o, off_l, warp_bytes, block_bytes;
  __host__ __device__ explicit CrossSmem(int SP) {
    lds = SP + 4;
    ldp = SP + 8;
    off_v = align128(SP * LDK * 2);
    off_warps = off_v + align128(SP * LDK * 2);
    off_s = align128(QT * LDK * 2);
    off_p = off_s + align128(QT * lds * 4);
    off_o = off_p + align128(QT * ldp * 2);
    off_l = off_o + align128(QT * LDO * 4);
    warp_bytes = off_l + align128(QT * 4);
    block_bytes = off_warps + WARPS * warp_bytes;
  }
};

template <int DP>
__global__ void __launch_bounds__(WARPS * 32) cross_mha_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int N, int S, int SP, int H, int D, int tiles_per_block,
    float scale) {
  const CrossSmem<DP> L(SP);
  constexpr int LDK = CrossSmem<DP>::LDK;
  constexpr int LDO = CrossSmem<DP>::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hd = H * D;
  const bf16* qb = q + (size_t)b * N * hd + (size_t)h * D;
  const bf16* kb = k + (size_t)b * S * hd + (size_t)h * D;
  const bf16* vb = v + (size_t)b * S * hd + (size_t)h * D;
  bf16* ob = o + (size_t)b * N * hd + (size_t)h * D;

  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.off_v);
  unsigned char* ws = smem + L.off_warps + warp * L.warp_bytes;
  bf16* Qs = reinterpret_cast<bf16*>(ws);
  float* Ss = reinterpret_cast<float*>(ws + L.off_s);
  bf16* Ps = reinterpret_cast<bf16*>(ws + L.off_p);
  float* Os = reinterpret_cast<float*>(ws + L.off_o);
  float* l_s = reinterpret_cast<float*>(ws + L.off_l);

  load_tile<DP>(Ks, LDK, kb, hd, 0, SP, S, D, threadIdx.x, WARPS * 32);
  load_tile<DP>(Vs, LDK, vb, hd, 0, SP, S, D, threadIdx.x, WARPS * 32);
  __syncthreads();  // the only block barrier: warps run on their own below

  const int row = lane / 2;  // two lanes per query row, interleaved columns
  const int sub = lane % 2;
  for (int ti = warp; ti < tiles_per_block; ti += WARPS) {
    const int q0 = (blockIdx.x * tiles_per_block + ti) * QT;
    if (q0 >= N) break;
    load_tile<DP>(Qs, LDK, qb, hd, q0, QT, N, D, lane, 32);
    __syncwarp();

    for (int j = 0; j < SP / 16; ++j) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        FragA a;
        FragBCol bk;
        wmma::load_matrix_sync(a, Qs + kk, LDK);
        wmma::load_matrix_sync(bk, Ks + j * 16 * LDK + kk, LDK);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Ss + j * 16, acc, L.lds, wmma::mem_row_major);
    }
    __syncwarp();

    {
      float m = -CUDART_INF_F;
      for (int col = sub; col < S; col += 2) m = fmaxf(m, Ss[row * L.lds + col] * scale);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      const float m_use = (m == -CUDART_INF_F) ? 0.0f : m;
      float lsum = 0.0f;
      for (int col = sub; col < SP; col += 2) {
        float p = 0.0f;
        if (col < S) p = expf(Ss[row * L.lds + col] * scale - m_use);
        lsum += p;
        Ps[row * L.ldp + col] = __float2bfloat16(p);
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      if (sub == 0) l_s[row] = lsum;
    }
    __syncwarp();

#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      FragAcc acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < SP; kk += 16) {
        FragA a;
        FragBRow bv;
        wmma::load_matrix_sync(a, Ps + kk, L.ldp);
        wmma::load_matrix_sync(bv, Vs + kk * LDK + j * 16, LDK);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + j * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();

    for (int e = lane; e < QT * DP; e += 32) {
      const int r = e / DP;
      const int c = e % DP;
      if (q0 + r < N && c < D) {
        const float l = l_s[r];
        const float safe = (l == 0.0f) ? 1.0f : l;
        ob[(size_t)(q0 + r) * hd + c] = __float2bfloat16(Os[r * LDO + c] / safe);
      }
    }
    __syncwarp();  // Qs, Ss, Ps, Os are reused by the next tile
  }
}

template <int DP>
int launch_stream(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int S,
                  int H, int D, float scale, cudaStream_t stream) {
  constexpr int bytes = StreamSmem<DP>::BLOCK_BYTES;
  cudaError_t err = cudaFuncSetAttribute(packed_mha_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long items = (long)B * H * ((N + QT - 1) / QT);
  const unsigned blocks = static_cast<unsigned>((items + WARPS - 1) / WARPS);
  packed_mha_kernel<DP><<<blocks, WARPS * 32, bytes, stream>>>(q, k, v, o, B, N, S, H, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_cross(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int S,
                 int H, int D, float scale, cudaStream_t stream) {
  const int SP = (S + 15) / 16 * 16;
  const CrossSmem<DP> L(SP);
  cudaError_t err = cudaFuncSetAttribute(cross_mha_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.block_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the longest run of query tiles per block that still leaves two blocks
  // for each of the card's SMs; short runs re-read K/V more often
  const int tiles = (N + QT - 1) / QT;
  int tpb = 32;
  while (tpb > WARPS && (long)((tiles + tpb - 1) / tpb) * H * B < 264) tpb /= 2;
  const dim3 grid((tiles + tpb - 1) / tpb, H, B);
  cross_mha_kernel<DP><<<grid, WARPS * 32, L.block_bytes, stream>>>(q, k, v, o, N, S, SP, H, D,
                                                                   tpb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries return a CUDA error code; 1 (cudaErrorInvalidValue) for a
// head dim that is not a multiple of 8 or above 160.
#define T2V_DISPATCH_DP(fn, ...)                      \
  if (D % 8 != 0) return 1;                           \
  if (D <= 48) return fn<48>(__VA_ARGS__);            \
  if (D <= 64) return fn<64>(__VA_ARGS__);            \
  if (D <= 80) return fn<80>(__VA_ARGS__);            \
  if (D <= 160) return fn<160>(__VA_ARGS__);          \
  return 1;

// q (B, N, H*D) over k/v (B, S, H*D), streamed keys (self-attention: S = N)
extern "C" int t2v_fused_self_mha(const void* q, const void* k, const void* v, void* o, int B,
                                  int N, int S, int H, int D, float scale, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T2V_DISPATCH_DP(launch_stream, qp, kp, vp, op, B, N, S, H, D, scale, st)
}

// q (B, N, H*D) over a short context k/v (B, S, H*D), S <= 128
extern "C" int t2v_fused_cross_mha(const void* q, const void* k, const void* v, void* o, int B,
                                   int N, int S, int H, int D, float scale, void* stream) {
  if (S > 128) return 1;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T2V_DISPATCH_DP(launch_cross, qp, kp, vp, op, B, N, S, H, D, scale, st)
}
