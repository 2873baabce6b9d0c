// Flash attention backward over head-folded (B, N, D) queries and (B, S, D)
// keys/values: the scores are recomputed tile by tile from the saved
// (q, k, v, lse), so no (N, S) matrix reaches device memory in training
// either. Two kernels, both fed delta = rowsum(dO * O) in f32 by the wrapper:
//
//   p  = exp(q . k^T * scale - lse), 0 for key columns >= S and rows >= N
//   dv += p^T . dO            dp = dO . v^T
//   ds = p * (dp - delta) * scale
//   dk += ds^T . q            dq += ds . k
//
// Replaces: t2v/kernels/flash_attention.py::_flash_bwd_dkv_kernel (dk, dv
// accumulated over query blocks) and ::_flash_bwd_dq_kernel (dq accumulated
// over key/value blocks), both driven by flash_attention_bwd.
//
// What bounds them on the H100: at the UNet's 32x32 level (N = S = 1024)
// each (query tile, key tile) pair does four (dkv) or three (dq) 2*BQ*BKV*D
// flop products on tiles that come from L2 after a head's first pass, so
// both are bound by tensor-core work and the exponentials, not by device
// memory (q, k, v, dO in, dq / dk, dv out: 6-7 tensors of B*N*D bf16).
//
// Design, as the forward kernel's:
//  * dkv: one block of 4 warps per (batch*head, BKV-row key tile); K and V
//    stay in shared memory, Q and dO stream through in BQ-row tiles; dk and
//    dv accumulate in f32 in shared memory over the loop. dq: one block per
//    (batch*head, BQ-row query tile) with Q and dO resident and K, V
//    streamed. A block owns its outputs, so there are no float atomics and
//    the results are the same from run to run;
//  * bf16 WMMA tiles with f32 accumulation for every product; p and ds are
//    rounded to bf16 before their products, as the TPU kernels round them;
//  * templated on D, the head dim rounded up to a multiple of 16; columns
//    d..D of the Q, K, V and dO tiles are zero-filled on load and only d
//    columns are written back. At D = 160 the tiles pass 48 KB (dq 178 KB,
//    dkv 171 KB with 32-row query tiles), opted in with cudaFuncSetAttribute.
#include "common.cuh"

using namespace t2v;

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;

using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

template <int D, int BQ, int BKV, int ACC_ROWS, int N_ACC>
struct BwdSmem {
  static constexpr int LDQ = D + 8;     // bf16 Q / dO / K / V rows
  static constexpr int LDS = BKV + 4;   // f32 scores and dP
  static constexpr int LDP = BKV + 8;   // bf16 p and ds
  static constexpr int LDO = D + 4;     // f32 accumulators
  static constexpr int Q = 0;
  static constexpr int DO = Q + align128(BQ * LDQ * 2);
  static constexpr int K = DO + align128(BQ * LDQ * 2);
  static constexpr int V = K + align128(BKV * LDQ * 2);
  static constexpr int S = V + align128(BKV * LDQ * 2);
  static constexpr int DP = S + align128(BQ * LDS * 4);
  static constexpr int P = DP + align128(BQ * LDS * 4);
  static constexpr int DS = P + align128(BQ * LDP * 2);
  static constexpr int ACC = DS + align128(BQ * LDP * 2);
  static constexpr int ROWS = ACC + N_ACC * align128(ACC_ROWS * LDO * 4);
  static constexpr int BYTES = ROWS + align128(2 * BQ * 4);
};

// rows x D bf16 tile from a (len, d) matrix, zero beyond len and d
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int row0,
                                          int rows, int len, int d, int tid) {
  for (int e = tid; e < rows * D / 8; e += NT) {
    const int r = e / (D / 8);
    const int c = (e % (D / 8)) * 8;
    uint4 val = zero_uint4();
    if (row0 + r < len && c < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// out (BQ x BKV, f32) = A (BQ x D) . B^T (BKV x D), both bf16 row-major
template <int D, int BQ, int BKV, int LD, int LDS>
__device__ __forceinline__ void scores_tile(float* out, const bf16* a_rows, const bf16* b_rows,
                                            int warp) {
  for (int t = warp; t < (BQ / 16) * (BKV / 16); t += NW) {
    const int i = t / (BKV / 16);
    const int j = t % (BKV / 16);
    FragAcc acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      FragA a;
      FragBCol b;
      wmma::load_matrix_sync(a, a_rows + i * 16 * LD + kk, LD);
      wmma::load_matrix_sync(b, b_rows + j * 16 * LD + kk, LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(out + i * 16 * LDS + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

// p and ds of one (BQ x BKV) tile from its scores and dP
template <int BQ, int BKV, int LDS, int LDP>
__device__ __forceinline__ void softmax_grad_tile(const float* Ss, const float* dPs,
                                                  const float* lse_s, const float* delta_s,
                                                  bf16* Ps, bf16* DSs, int q0, int kv0, int N,
                                                  int S, float scale, int tid) {
  for (int e = tid; e < BQ * BKV; e += NT) {
    const int r = e / BKV;
    const int c = e % BKV;
    const bool valid = (q0 + r < N) && (kv0 + c < S);
    const float p = valid ? expf(Ss[r * LDS + c] * scale - lse_s[r]) : 0.0f;
    const float ds = p * (dPs[r * LDS + c] - delta_s[r]) * scale;
    if (Ps != nullptr) Ps[r * LDP + c] = __float2bfloat16(p);
    DSs[r * LDP + c] = __float2bfloat16(ds);
  }
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int S,
    int d, float scale) {
  using L = BwdSmem<D, BQ, BKV, BKV, 2>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::DO);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);
  bf16* DSs = reinterpret_cast<bf16*>(smem + L::DS);
  float* dKs = reinterpret_cast<float*>(smem + L::ACC);
  float* dVs = dKs + align128(BKV * L::LDO * 4) / 4;
  float* lse_s = reinterpret_cast<float*>(smem + L::ROWS);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int kv0 = blockIdx.x * BKV;
  const size_t bq = (size_t)blockIdx.y * N * d;
  const size_t bkv = (size_t)blockIdx.y * S * d;
  const size_t brow = (size_t)blockIdx.y * N;

  load_tile<D, L::LDQ>(Ks, k + bkv, kv0, BKV, S, d, tid);
  load_tile<D, L::LDQ>(Vs, v + bkv, kv0, BKV, S, d, tid);
  for (int e = tid; e < BKV * D; e += NT) {
    dKs[(e / D) * L::LDO + e % D] = 0.0f;
    dVs[(e / D) * L::LDO + e % D] = 0.0f;
  }

  for (int q0 = 0; q0 < N; q0 += BQ) {
    load_tile<D, L::LDQ>(Qs, q + bq, q0, BQ, N, d, tid);
    load_tile<D, L::LDQ>(dOs, dout + bq, q0, BQ, N, d, tid);
    for (int r = tid; r < BQ; r += NT) {
      const bool in = q0 + r < N;
      lse_s[r] = in ? lse[brow + q0 + r] : 0.0f;
      delta_s[r] = in ? delta[brow + q0 + r] : 0.0f;
    }
    __syncthreads();

    scores_tile<D, BQ, BKV, L::LDQ, L::LDS>(Ss, Qs, Ks, warp);    // q . k^T
    scores_tile<D, BQ, BKV, L::LDQ, L::LDS>(dPs, dOs, Vs, warp);  // dO . v^T
    __syncthreads();

    softmax_grad_tile<BQ, BKV, L::LDS, L::LDP>(Ss, dPs, lse_s, delta_s, Ps, DSs, q0, kv0, N, S,
                                               scale, tid);
    __syncthreads();

    // dv += p^T . dO and dk += ds^T . q: the transposed left operand is the
    // row-major (BQ x BKV) tile read as a column-major fragment
    for (int t = warp; t < 2 * (BKV / 16) * (D / 16); t += NW) {
      const bool is_dv = t < (BKV / 16) * (D / 16);
      const int tt = is_dv ? t : t - (BKV / 16) * (D / 16);
      const int i = tt / (D / 16);
      const int j = tt % (D / 16);
      float* acc_s = (is_dv ? dVs : dKs) + i * 16 * L::LDO + j * 16;
      const bf16* left = is_dv ? Ps : DSs;
      const bf16* right = is_dv ? dOs : Qs;
      FragAcc acc;
      wmma::load_matrix_sync(acc, acc_s, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        FragACol a;
        FragBRow b;
        wmma::load_matrix_sync(a, left + kk * L::LDP + i * 16, L::LDP);
        wmma::load_matrix_sync(b, right + kk * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(acc_s, acc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int e = tid; e < BKV * D; e += NT) {
    const int r = e / D;
    const int c = e % D;
    if (kv0 + r < S && c < d) {
      const size_t at = bkv + (size_t)(kv0 + r) * d + c;
      dk[at] = __float2bfloat16(dKs[r * L::LDO + c]);
      dv[at] = __float2bfloat16(dVs[r * L::LDO + c]);
    }
  }
}

template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int N, int S, int d, float scale) {
  using L = BwdSmem<D, BQ, BKV, BQ, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::DO);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  bf16* DSs = reinterpret_cast<bf16*>(smem + L::DS);
  float* dQs = reinterpret_cast<float*>(smem + L::ACC);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROWS);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const size_t bq = (size_t)blockIdx.y * N * d;
  const size_t bkv = (size_t)blockIdx.y * S * d;
  const size_t brow = (size_t)blockIdx.y * N;

  load_tile<D, L::LDQ>(Qs, q + bq, q0, BQ, N, d, tid);
  load_tile<D, L::LDQ>(dOs, dout + bq, q0, BQ, N, d, tid);
  for (int r = tid; r < BQ; r += NT) {
    const bool in = q0 + r < N;
    lse_s[r] = in ? lse[brow + q0 + r] : 0.0f;
    delta_s[r] = in ? delta[brow + q0 + r] : 0.0f;
  }
  for (int e = tid; e < BQ * D; e += NT) dQs[(e / D) * L::LDO + e % D] = 0.0f;

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    load_tile<D, L::LDQ>(Ks, k + bkv, kv0, BKV, S, d, tid);
    load_tile<D, L::LDQ>(Vs, v + bkv, kv0, BKV, S, d, tid);
    __syncthreads();

    scores_tile<D, BQ, BKV, L::LDQ, L::LDS>(Ss, Qs, Ks, warp);    // q . k^T
    scores_tile<D, BQ, BKV, L::LDQ, L::LDS>(dPs, dOs, Vs, warp);  // dO . v^T
    __syncthreads();

    softmax_grad_tile<BQ, BKV, L::LDS, L::LDP>(Ss, dPs, lse_s, delta_s, nullptr, DSs, q0, kv0,
                                               N, S, scale, tid);
    __syncthreads();

    // dq += ds . k
    for (int t = warp; t < (BQ / 16) * (D / 16); t += NW) {
      const int i = t / (D / 16);
      const int j = t % (D / 16);
      float* acc_s = dQs + i * 16 * L::LDO + j * 16;
      FragAcc acc;
      wmma::load_matrix_sync(acc, acc_s, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        FragA a;
        FragBRow b;
        wmma::load_matrix_sync(a, DSs + i * 16 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(b, Ks + kk * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(acc_s, acc, L::LDO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D;
    const int c = e % D;
    if (q0 + r < N && c < d)
      dq[bq + (size_t)(q0 + r) * d + c] = __float2bfloat16(dQs[r * L::LDO + c]);
  }
}

template <int D, int BQ, int BKV>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int N, int S, int d, float scale,
               cudaStream_t stream) {
  constexpr int bytes = BwdSmem<D, BQ, BKV, BKV, 2>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, BQ, BKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BKV - 1) / BKV, B);
  flash_bwd_dkv_kernel<D, BQ, BKV><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, S, d,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ, int BKV>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int N, int S, int d, float scale,
              cudaStream_t stream) {
  constexpr int bytes = BwdSmem<D, BQ, BKV, BQ, 1>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, BQ, BKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BQ - 1) / BQ, B);
  flash_bwd_dq_kernel<D, BQ, BKV><<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), N, S, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return a CUDA error code; 1 (cudaErrorInvalidValue) for an
// unsupported head dim (not a multiple of 8, or above 160).
extern "C" int t2v_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int B, int N,
                                           int S, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 48) return launch_dkv<48, 64, 64>(q, k, v, dout, lse, delta, dk, dv, B, N, S, D, scale, st);
  if (D <= 64) return launch_dkv<64, 64, 64>(q, k, v, dout, lse, delta, dk, dv, B, N, S, D, scale, st);
  if (D <= 80) return launch_dkv<80, 64, 64>(q, k, v, dout, lse, delta, dk, dv, B, N, S, D, scale, st);
  if (D <= 160) return launch_dkv<160, 32, 64>(q, k, v, dout, lse, delta, dk, dv, B, N, S, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int t2v_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int B, int N, int S, int D, float scale,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 48) return launch_dq<48, 64, 64>(q, k, v, dout, lse, delta, dq, B, N, S, D, scale, st);
  if (D <= 64) return launch_dq<64, 64, 64>(q, k, v, dout, lse, delta, dq, B, N, S, D, scale, st);
  if (D <= 80) return launch_dq<80, 64, 64>(q, k, v, dout, lse, delta, dq, B, N, S, D, scale, st);
  if (D <= 160) return launch_dq<160, 64, 64>(q, k, v, dout, lse, delta, dq, B, N, S, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
