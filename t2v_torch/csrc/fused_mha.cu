// Packed-head attention over short key sequences, read in the (B, N, H*D)
// layout that the q/k/v projections emit: head h is the strided D-wide
// column slice [h*D, h*D + D) of every row, so there is no head fold and no
// transpose. f32 softmax; keys past the sequence end are masked. One kernel,
// packed_mha_kernel: q (B, N, H*D) over k/v (B, S, H*D), any N and S < 512.
// The self-attention entry (S = N) and the cross-attention over a short
// shared context (the 77-token text context of a whole video's tokens) run
// it through t2v_fused_self_mha. It is templated on where a sequence's rows
// lie (TokenRows, FrameRows): the frame-axis entry runs the same body over
// the sample-major (B*F, N, H*D) layout, attending across the F frame rows
// of each (sample, spatial token) with a row stride of N*H*D.
//
// Replaces: t2v/kernels/fused_mha.py::_self_mha_kernel (driven by
// fused_self_mha; dispatched from t2v/kernels/attention.py::
// self_attention_packed for N < FLASH_MIN_KV) and
// t2v/kernels/fused_mha.py::_cross_mha_kernel (driven by fused_cross_mha;
// dispatched from cross_attention_packed for S < FLASH_MIN_KV) and
// t2v/kernels/fused_mha.py::_temporal_mha_kernel (driven by
// fused_temporal_mha; dispatched from temporal_attention_packed for
// F < FLASH_MIN_KV). The TPU self and temporal kernels' block-diagonal
// (bt*N)^2 packing, the temporal kernel's frame padding to a multiple of 8
// and its in-VMEM frame<->token swap, and the cross kernel's row-block
// budget were workarounds for the 128x128 MXU, the (8, 128) tiling and VMEM
// and are not part of the contract: here the swap is an address map.
//
// What bounds them on the H100: device memory. At the dominant shape,
// (48, 256, 640) with 10 heads of 64, q, k, v and o are 63 MB (0.0188 ms at
// 3.35 TB/s) against 16 GFLOP of QK^T and PV (0.0163 ms at 989 TFLOP/s);
// at 24 frames the sequences are 24 rows and the flops are a tenth of the
// bytes' time. So the design reads every (sequence, head)'s K and V from
// device memory once, and keeps scores and outputs out of shared memory.
//
// Design of packed_mha_kernel (FlashAttention-2 style, mma.sync):
//  * a block owns one (sequence, head) pair and a run of its 16-row query
//    tiles, or, for sequences of one key chunk, several pairs (temporal
//    attention at 24 frames: four pairs of two tiles). Its warps take the
//    block's (pair, query tile) items in rounds. The per-shape plan (pairs
//    and tiles a block, warps, key chunk, whether K/V stay resident) comes
//    from kernels/fused_mha.py::self_mha_plan;
//  * K and V arrive by cp.async in chunks of 32 or 64 rows into shared
//    memory that every warp of the block reads (rows padded by 8 bf16 so
//    that ldmatrix is free of bank conflicts; rows past S and columns past
//    D are zero-filled by the copy). When the block's whole K/V fits (every
//    path shape), it is loaded once, one cp.async group a chunk so that the
//    first round computes on the first chunks while the rest arrive, and
//    serves every round; otherwise (head dim 160 with S above about 280)
//    the chunks stream through a double buffer once a round;
//  * a warp's query tile lives in registers as mma A fragments; scores S
//    (16 x chunk) and the output O (16 x DP) are f32 mma accumulators in
//    registers; P is rounded to bf16 and repacked in registers as the A
//    fragments of the PV product (the C layout of m16n8 is the A layout of
//    m16k16). The softmax is online across chunks only, in the log2 domain
//    with the scale folded into the exponent's FMA, and masks keys only in
//    a ragged last chunk; a sequence of one chunk is a single pass;
//  * the head dim is a template parameter DP, a multiple of 16; a head of
//    D <= DP columns (D = 40 under DP = 48) is zero-filled on load, and
//    only its D columns are written back. O leaves through the warp's
//    query staging tile as 16-byte rows;
//  * up to DP = 80 a thread is held to 128 registers, so that two blocks
//    of 8 warps share an SM (faster than one block with more registers).
//
// Cross-attention over the 77-token text context (N >> S): one (sample,
// head) pair's K/V, three 32-row chunks (96 padded keys where 64-row ones
// pad to 128), resident in shared memory for a block's 32 query tiles.
//
// Measured (chip_smoke.py on an "NVIDIA H100 80GB HBM3, 700.00 W"): the
// packed self-attention at (48, 256, 640), 10 heads, 0.0541 ms against its
// bound 0.0188 ms (bytes) and SDPA's 0.0535; the frame-axis entry at
// (48, 1024, 320), 5 heads, F = 24, 0.0671 ms against 0.0376 and SDPA's
// 0.1769; the cross-attention at q (2, 16384, 320) over 77 tokens, 8
// heads, 0.0474 ms by CUDA events (0.0262 ms of device time under 40 us of
// the wrapper's host time) against 0.0126 and SDPA's 0.0694. What holds
// the kernel back is `ldmatrix` traffic per mma.sync and one exp2 per
// score, not bytes.
#include "mma_sync.cuh"

using namespace t2v;

namespace {

constexpr int QT = 16;
constexpr int MAX_SMEM = 232448;

// Where the rows of one attention sequence lie in a packed (rows, H*D)
// tensor, in rows: the first row of sequence `seq` of length `len`, and the
// step between its positions. `inner` is the token count N of the frame
// layout (unused by TokenRows).
struct TokenRows {  // (B, N, H*D): sequence b is rows b*N .. b*N + N - 1
  __device__ static size_t first(long seq, int len, int) { return (size_t)seq * len; }
  __device__ static size_t step(int) { return 1; }
};
struct FrameRows {  // (B*F, N, H*D): sequence (b, n), position f at row (b*F + f)*N + n
  __device__ static size_t first(long seq, int len, int inner) {
    return (size_t)(seq / inner) * len * inner + (size_t)(seq % inner);
  }
  __device__ static size_t step(int inner) { return (size_t)inner; }
};

// shared-memory bytes of packed_mha_kernel: `nbuf` K/V chunk buffers of
// KC padded rows each, and one 16-row query tile a warp (mirrored by
// kernels/fused_mha.py::self_mha_plan)
__host__ __device__ constexpr int packed_smem_bytes(int dp, int kc, int nbuf, int warps) {
  return nbuf * 2 * kc * (dp + 8) * 2 + warps * QT * (dp + 8) * 2;
}

// n_pairs = sequences * H (sequence, head) pairs, pair index seq * H + h.
// A block owns pairs [blockIdx.x / qsplit * ppb, + ppb) and query tiles
// [blockIdx.x % qsplit * tpb, + tpb) of each; resident != 0: the block's
// whole K/V sits in ppb * n_chunks buffers, loaded once (ppb > 1 only
// then); otherwise two buffers stream the chunks of its single pair.
// head dims up to 80 are capped at 128 registers, so that two blocks of 8
// warps share an SM (measured faster than one block with more registers)
template <int DP, int KC, class Rows>
__global__ void __launch_bounds__(256, DP <= 80 ? 2 : 1) packed_mha_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, long n_pairs, int N, int S, int H, int D, int inner, float scale_log2,
    int ppb, int tpb, int qsplit, int resident) {
  constexpr int LD = DP + 8;     // padded row: ldmatrix rows land in distinct banks
  constexpr int SEGS = DP / 8;   // 16-byte segments of a row
  constexpr int NB = KC / 8;     // key n-blocks of a chunk
  constexpr int NO = DP / 8;     // output n-blocks
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int n_qt = (N + QT - 1) / QT;
  const int n_chunks = (S + KC - 1) / KC;
  const long pair0 = (long)(blockIdx.x / qsplit) * ppb;
  const int np = static_cast<int>(min((long)ppb, n_pairs - pair0));
  const int t0 = (blockIdx.x % qsplit) * tpb;
  const int nt = min(tpb, n_qt - t0);
  if (np <= 0 || nt <= 0) return;  // block-uniform
  const int items = np * nt;
  const int hd = H * D;
  const size_t row_stride = Rows::step(inner) * hd;
  const int nbuf = resident ? ppb * n_chunks : 2;
  bf16* kv = reinterpret_cast<bf16*>(smem);
  bf16* qtile = kv + (size_t)nbuf * 2 * KC * LD + warp * QT * LD;

  // K and V rows of chunk c of local pair p -> buffer bi, by every thread
  auto load_chunk = [&](int bi, int p, int c) {
    const long pr = pair0 + p;
    const long seq = pr / H;
    const size_t col = (size_t)(pr % H) * D;
    const bf16* kb = k + Rows::first(seq, S, inner) * hd + col;
    const bf16* vb = v + Rows::first(seq, S, inner) * hd + col;
    bf16* ks = kv + (size_t)bi * 2 * KC * LD;
    for (int e = threadIdx.x; e < KC * SEGS; e += blockDim.x) {
      const int r = e / SEGS;
      const int sg = e % SEGS;
      const int key = c * KC + r;
      const bool ok = key < S && sg * 8 < D;
      const size_t off = ok ? (size_t)key * row_stride + sg * 8 : 0;
      cp_async16(smem_u32(ks + r * LD + sg * 8), kb + off, ok);
      cp_async16(smem_u32(ks + (KC + r) * LD + sg * 8), vb + off, ok);
    }
  };

  // this warp's query tile of round `rd`: the item's pair and first row
  auto item_of = [&](int rd, int& p, int& q0, size_t& qoff) {
    const int item = rd * warps + warp;
    const bool valid = item < items;
    p = valid ? item / nt : 0;
    q0 = (t0 + (valid ? item % nt : 0)) * QT;
    const long pr = pair0 + p;
    qoff = Rows::first(pr / H, N, inner) * hd + (size_t)(pr % H) * D;
    return valid;
  };
  auto load_q = [&](int q0, size_t qoff) {
    for (int e = lane; e < QT * SEGS; e += 32) {
      const int r = e / SEGS;
      const int sg = e % SEGS;
      const bool ok = q0 + r < N && sg * 8 < D;
      const size_t off = ok ? (size_t)(q0 + r) * row_stride + sg * 8 : 0;
      cp_async16(smem_u32(qtile + r * LD + sg * 8), q + qoff + off, ok);
    }
  };

  // the first round's queries, then a resident block's K/V, one cp.async
  // group a chunk, so that the first round computes on chunk c while the
  // later chunks are still arriving
  {
    int p, q0;
    size_t qoff;
    if (item_of(0, p, q0, qoff)) load_q(q0, qoff);
    cp_async_commit();
  }
  if (resident) {
    for (int pc = 0; pc < np * n_chunks; ++pc) {
      load_chunk(pc, pc / n_chunks, pc % n_chunks);
      cp_async_commit();
    }
  }
  const int rounds = (items + warps - 1) / warps;
  for (int rd = 0; rd < rounds; ++rd) {
    int p, q0;
    size_t qoff;
    const bool valid = item_of(rd, p, q0, qoff);
    if (rd > 0 && valid) load_q(q0, qoff);
    if (!resident) load_chunk(0, 0, 0);
    if (rd > 0 || !resident) cp_async_commit();

    uint32_t qf[DP / 16][4];
    float acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.0f, 0.0f};

    for (int c = 0; c < n_chunks; ++c) {
      if (resident) {
        if (rd == 0 && ppb == 1) {  // the queries and chunks 0..c have landed
          cp_async_wait_at_most(n_chunks - 1 - c);
          __syncthreads();
        } else if (c == 0) {  // several pairs: all of them; later rounds: the queries
          cp_async_wait<0>();
          if (rd == 0) __syncthreads(); else __syncwarp();
        }
      } else {
        if (c + 1 < n_chunks) {
          load_chunk((c + 1) & 1, 0, c + 1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      if (valid) {
        if (c == 0) {
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            ldsm_x4(smem_u32(qtile + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                             (lane >> 4) * 8), qf[kk]);
        }
        const bf16* ks = kv + (size_t)(resident ? p * n_chunks + c : (c & 1)) * 2 * KC * LD;
        const bf16* vs = ks + KC * LD;

        // S = Q K^T for this chunk's KC keys
        float sc[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
          for (int nb = 0; nb < NB; nb += 2) {
            uint32_t bk[4];
            ldsm_x4(smem_u32(ks + (nb * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8), bk);
            mma_16816(sc[nb], qf[kk], bk[0], bk[1]);
            mma_16816(sc[nb + 1], qf[kk], bk[2], bk[3]);
          }
        }
        // online softmax in the log2 domain, on this lane's rows g and g + 8;
        // keys past S exist only in the last chunk
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
        const bool ragged = (c + 1) * KC > S;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (ragged && c * KC + nb * 8 + t4 * 2 + (e & 1) >= S) sc[nb][e] = -CUDART_INF_F;
            mx[e / 2] = fmaxf(mx[e / 2], sc[nb][e]);
          }
        }
        float alpha[2], use[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m_run[i], mx[i] * scale_log2);  // scale > 0
          use[i] = m_new == -CUDART_INF_F ? 0.0f : m_new;  // a row with no key yet
          alpha[i] = exp2f(m_run[i] - use[i]);
          m_run[i] = m_new;
        }
        float ls[2] = {0.0f, 0.0f};
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[nb][e] = exp2f(fmaf(sc[nb][e], scale_log2, -use[e / 2]));
            ls[e / 2] += sc[nb][e];
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + ls[i];
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          acc[j][0] *= alpha[0];
          acc[j][1] *= alpha[0];
          acc[j][2] *= alpha[1];
          acc[j][3] *= alpha[1];
        }
        // O += P V, P rounded to bf16 in registers as A fragments
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                                  pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                                  pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                                  pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
          for (int j = 0; j < NO; j += 2) {
            uint32_t bv[4];
            ldsm_x4_trans(smem_u32(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                   j * 8 + (lane >> 4) * 8), bv);
            mma_16816(acc[j], pa, bv[0], bv[1]);
            mma_16816(acc[j + 1], pa, bv[2], bv[3]);
          }
        }
      }
      if (!resident) __syncthreads();  // the buffer is refilled two chunks on
    }

    if (valid) {
      // rows of the quad's four lanes hold partial sums of l; a fully
      // masked row (l == 0) is written as 0
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_run[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[i] = 1.0f / (l == 0.0f ? 1.0f : l);
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        *reinterpret_cast<uint32_t*>(qtile + g * LD + j * 8 + t4 * 2) =
            pack_bf16(acc[j][0] * inv[0], acc[j][1] * inv[0]);
        *reinterpret_cast<uint32_t*>(qtile + (g + 8) * LD + j * 8 + t4 * 2) =
            pack_bf16(acc[j][2] * inv[1], acc[j][3] * inv[1]);
      }
      __syncwarp();
      for (int e = lane; e < QT * SEGS; e += 32) {
        const int r = e / SEGS;
        const int sg = e % SEGS;
        if (q0 + r < N && sg * 8 < D)
          *reinterpret_cast<uint4*>(o + qoff + (size_t)(q0 + r) * row_stride + sg * 8) =
              *reinterpret_cast<const uint4*>(qtile + r * LD + sg * 8);
      }
      __syncwarp();  // the tile takes the next round's queries
    }
  }
}

// n_seq sequences of N queries over S keys, laid out as Rows says, under
// the plan of kernels/fused_mha.py::self_mha_plan
template <int DP, class Rows>
int launch_packed(const bf16* q, const bf16* k, const bf16* v, bf16* o, long n_seq, int N, int S,
                  int H, int D, int inner, float scale, const int* plan, cudaStream_t stream) {
  const int kc = plan[0], warps = plan[1], ppb = plan[2], tpb = plan[3], resident = plan[4];
  const int n_chunks = (S + kc - 1) / kc;
  const int n_qt = (N + QT - 1) / QT;
  const int nbuf = resident ? ppb * n_chunks : 2;
  const int bytes = packed_smem_bytes(DP, kc, nbuf, warps);
  if ((kc != 32 && kc != 64) || warps < 1 || warps > 8 || ppb < 1 || tpb < 1 ||
      (ppb > 1 && !resident) || bytes > MAX_SMEM || N < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n_pairs = n_seq * H;
  const int qsplit = (n_qt + tpb - 1) / tpb;
  const long blocks = (n_pairs + ppb - 1) / ppb * qsplit;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = scale * 1.4426950408889634f;
  auto kernel = kc == 32 ? packed_mha_kernel<DP, 32, Rows> : packed_mha_kernel<DP, 64, Rows>;
  static bool opted_in[2] = {false, false};  // the shared-memory attribute, once per kernel
  if (!opted_in[kc == 64]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[kc == 64] = true;
  }
  kernel<<<static_cast<unsigned>(blocks), warps * 32, bytes, stream>>>(
      q, k, v, o, n_pairs, N, S, H, D, inner, scale_log2, ppb, tpb, qsplit, resident);
  return static_cast<int>(cudaGetLastError());
}

// self-attention over (B, N, H*D), or q (B, N, H*D) over k/v (B, S, H*D)
template <int DP>
int launch_self(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int S,
                int H, int D, float scale, const int* plan, cudaStream_t stream) {
  return launch_packed<DP, TokenRows>(q, k, v, o, B, N, S, H, D, 1, scale, plan, stream);
}

// attention across the F frame rows of every (sample, token) of (B*F, N, H*D)
template <int DP>
int launch_temporal(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int F, int N,
                    int H, int D, float scale, const int* plan, cudaStream_t stream) {
  return launch_packed<DP, FrameRows>(q, k, v, o, (long)B * N, F, F, H, D, N, scale, plan,
                                      stream);
}

}  // namespace

// The entries return a CUDA error code; 1 (cudaErrorInvalidValue) for a
// head dim that is not a multiple of 8 or above 160.
#define T2V_DISPATCH_DP(fn, ...)                      \
  if (D % 8 != 0) return 1;                           \
  if (D <= 48) return fn<48>(__VA_ARGS__);            \
  if (D <= 64) return fn<64>(__VA_ARGS__);            \
  if (D <= 80) return fn<80>(__VA_ARGS__);            \
  if (D <= 160) return fn<160>(__VA_ARGS__);          \
  return 1;

// The packed entries take the plan of kernels/fused_mha.py::self_mha_plan:
// key chunk rows, warps a block, (sequence, head) pairs a block, query
// tiles a block, and whether the block's K/V stay resident.
#define T2V_PLAN_ARGS int kc, int warps, int ppb, int tpb, int resident

// q (B, N, H*D) over k/v (B, S, H*D): self-attention (S = N), and
// cross-attention over a shared context of S < 512 rows
extern "C" int t2v_fused_self_mha(const void* q, const void* k, const void* v, void* o, int B,
                                  int N, int S, int H, int D, float scale, T2V_PLAN_ARGS,
                                  void* stream) {
  const int plan[5] = {kc, warps, ppb, tpb, resident};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T2V_DISPATCH_DP(launch_self, qp, kp, vp, op, B, N, S, H, D, scale, plan, st)
}

// frame-axis self-attention over sample-major q/k/v (B*F, N, H*D): for every
// sample b, spatial token n and head, the F rows (b*F + f, n) attend each
// other
extern "C" int t2v_fused_temporal_mha(const void* q, const void* k, const void* v, void* o,
                                      int B, int F, int N, int H, int D, float scale,
                                      T2V_PLAN_ARGS, void* stream) {
  const int plan[5] = {kc, warps, ppb, tpb, resident};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  T2V_DISPATCH_DP(launch_temporal, qp, kp, vp, op, B, F, N, H, D, scale, plan, st)
}
