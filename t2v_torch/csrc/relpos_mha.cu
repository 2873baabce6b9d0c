// Temporal self-attention with learned relative-position score and value
// biases, in the resident layout:
//   sim[tq, tk] = (q[tq] . k[tk] + q[tq] . K2[tq, tk]) * scale      (f32)
//   P           = softmax_tk(sim), rounded to bf16
//   out[tq]     = sum_tk P[tq, tk] * v[tk] + sum_tk P[tq, tk] * V2[tq, tk]
// (both sums in f32, one bf16 rounding) for every (sample, spatial token,
// head). q/k/v/out are (B*T, N, H*D): sample-major frames, then spatial
// tokens, heads packed in the last axis, exactly as the per-token
// projections emit them; K2/V2 are (T, T, D). T <= 64, D a multiple of 8
// up to 160.
//
// Replaces: t2v/kernels/relpos_mha.py::_kernel (driven by
// fused_relpos_temporal_mha; reached from t2v/models/videocrafter_unet.py::
// TemporalCrossAttention with frame_split). As there, the frame <-> token
// fold happens in index arithmetic and never in device memory.
//
// What bounds it on the H100: device memory. Per (token, head) the work is
// 8*T*T*D flops on 4*T*D*2 bytes of q, k, v and out, 2*T = 32 flops a byte
// at T = 16, far below the card's ~295 flop/byte ridge; K2 and V2 are the
// same for every sample, token and head. At the dominant shape, q/k/v
// (32, 1024, 320) with 8 heads of 40 and T = 16, the bound is 84 MB at
// 3.35 TB/s = 0.0251 ms.
//
// Design: all four products on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulators), under two row maps of one shared-memory tile.
//  * A tile is (sample, a run of spatial tokens, all heads or a head
//    group): P <= 16 (token, head) pairs. Persistent blocks (one an SM)
//    walk the tiles; warp 0 brings each tile's q, k and v in by 1-D bulk
//    copies, one a frame row (a contiguous stretch of the (B*T, N, H*D)
//    tensor), completing on an mbarrier, and sends the output back the
//    same way; a tile's copy is issued as soon as its buffer is free, so
//    with two buffers the next tile arrives during this one's compute.
//  * Shared memory holds rows (frame t, pair p) of D columns, a frame row
//    padded to an odd count of 16-byte chunks. ldmatrix takes eight
//    arbitrary row addresses, so one tile is read frame-major (rows t of a
//    pair, stride one frame row) and token-major (rows p of a frame,
//    consecutive). Frames past T are zero; a head dim D below the padded
//    width DP (a template parameter) reads its columns past D from a zero
//    chunk; rows of tokens past N are never read into another row.
//  * Token-major, per query frame tq and 16-row group of pairs (a warp an
//    item): the score bias q_p[tq] . K2[tq]^T and, later, P_p[tq] . V2[tq]
//    are plain GEMMs whose B operand, K2[tq] or V2[tq] (T x D), is the same
//    for all 16 rows. The tables are staged in shared memory once a block
//    where that pays (relpos_plan), else read into registers as B
//    fragments from device memory (L1/L2) once per (tq, group); never once
//    per pair.
//  * Frame-major, one pair a warp item: S = q . k^T (up to 64 keys, 16-row
//    query tiles) in registers, plus the bias, the softmax in f32 in the
//    log2 domain with the scale folded into the exponent's FMA (keys past T
//    masked), P normalised and rounded to bf16, then O1 = P . v, with P
//    repacked from the C layout into A fragments where T <= 16.
//  * The exchanges go through shared memory: the f32 bias [p][tq][tk]
//    (token-major -> frame-major) into a slot a pair, whose rows then take
//    the pair's bf16 P, read back token-major as the A operand of P . V2;
//    O1 in f32 over the pair's q and k rows, which only its warp read in
//    that phase, added to P . V2 before the one bf16 rounding into an
//    output region (two, so that a tile's output copy overlaps the next).
//  * Three block barriers a tile: after the bias, the frame-major phase
//    and the output. The per-shape plan (tokens and heads a tile, warps,
//    table staging, one or two buffers, blocks) comes from
//    kernels/relpos_mha.py::relpos_plan.
//
// Measured (chip_smoke.py, tools/relpos_ab.py and tools/relpos_split.py
// on an "NVIDIA H100 80GB HBM3, 700.00 W"): 0.060-0.062 ms a launch at
// the dominant shape by CUDA events (0.046-0.057 ms of device time), against
// 0.187-0.189 ms for the CUDA-core kernel it replaced in the same call and the
// bound's 0.0251; the other three VideoCrafter levels 0.024-0.048 ms
// against 0.060-0.134. What holds it back: at D = 40 the data movement
// alone (0.038 ms) and the compute alone (0.035) each take about 60% of
// the full time and overlap only in part; at D = 80 and 160 the compute
// alone takes 72-98% of it. Three short dependent phases a tile meet at
// block barriers, and 16 warps do not fill their latencies.
#include <type_traits>

#include "mma_sync.cuh"

using namespace t2v;

namespace {

constexpr int MAX_SMEM = 232448;
constexpr int MAX_D = 160;

// shared-memory layout (bytes), mirrored by kernels/relpos_mha.py::relpos_smem_bytes:
// a zero chunk and two mbarriers; K2 and V2 when staged (rows (tq, tk), tk
// padded to tp); one or two tile buffers, each a q, a k and a v region of
// tp frame rows of `pairs` dense D-wide rows; two output regions of t such
// frame rows; and a slot a pair for its f32 bias rows, whose first halves
// later take its bf16 P rows
__host__ __device__ constexpr int table_row_bytes(int d) { return 2 * ((d / 8) % 2 ? d : d + 8); }
__host__ __device__ constexpr int frame_bytes(int d, int pairs) {
  return 16 * ((pairs * d / 8) | 1);  // an odd count of 16-byte chunks
}
__host__ __device__ constexpr int slot_row_words(int tp) { return tp + 4; }
__host__ __device__ constexpr int slot_words(int tp) { return tp * (tp + 4) + 4; }
__host__ __device__ constexpr int relpos_smem_bytes(int tp, int d, int pairs, int t, int tables,
                                                   int nbuf) {
  return 32 + (tables ? 2 * t * tp * table_row_bytes(d) : 0) +
         (nbuf * 3 * tp + 2 * t) * frame_bytes(d, pairs) + pairs * slot_words(tp) * 4;
}

__device__ __forceinline__ uint32_t ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint32_t ldg_u16(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// DP: head dim rounded up to a multiple of 16; KT: 16-frame tiles (T <= 16 * KT).
// Persistent: block i takes tiles i, i + gridDim.x, ...; warp 0 moves every
// tile by bulk copies (one a frame row of q, k, v or out), so the other
// warps never wait on a load they issue; a tile's load is issued as soon
// as its buffer is free, so with two buffers the next tile arrives while
// this one is computed. Up to DP = 80, 16 warps of at most 128
// registers; at DP = 160, 8 warps of up to 255.
template <int DP, int KT>
__global__ void __launch_bounds__(DP <= 80 ? 512 : 256, 1) relpos_mha_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ k2, const bf16* __restrict__ v2, bf16* __restrict__ o, int B, int T,
    int N, int H, int D, int nt, int hb, int tables, int nbuf, float scale_log2) {
  constexpr int TP = 16 * KT;  // frames padded to whole query tiles
  constexpr int NB = TP / 8;   // key n-blocks
  constexpr int KD = DP / 16;  // k steps over the head dim
  constexpr int NO = DP / 8;   // output n-blocks
  constexpr int XR = slot_row_words(TP);
  constexpr int XP = slot_words(TP);
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;

  // a tile: sample b, tokens n0 .. n0 + nt - 1, heads h0 .. h0 + hb - 1 (heads fastest)
  const int hgroups = H / hb;
  const int runs = (N + nt - 1) / nt;
  const int tiles = B * runs * hgroups;  // below 2^31 (checked at launch)
  const int P = nt * hb;
  const int G = (P + 15) / 16;
  const int segs = D / 8;  // 16-byte chunks of a head's row
  const int RD = 2 * D;    // bytes of a (frame, pair) row
  const int HALF = D / 2;  // O1 columns kept in the q row; the rest in the k row
  const size_t hd = (size_t)H * D;
  const int RT = table_row_bytes(D);
  const int FP = frame_bytes(D, P);
  const int REG = TP * FP;  // a q, k or v region
  const uint32_t zero = smem_u32(smem);
  const uint32_t bars = zero + 16;  // buffer i's mbarrier at + 8 i
  unsigned char* k2s = smem + 32;
  unsigned char* v2s = k2s + (tables ? T * TP * RT : 0);
  unsigned char* bufs = v2s + (tables ? T * TP * RT : 0);
  unsigned char* outs = bufs + nbuf * 3 * REG;  // output region i at + i T FP
  float* slots = reinterpret_cast<float*>(outs + 2 * T * FP);

  // a tile's first element (frame 0 of its sample, first token and head),
  // first token and tokens that exist (32-bit divisions: a 64-bit one is a
  // long routine)
  auto tile_at = [&](int tile, size_t& base, int& n0, int& valid) {
    const int rest = tile / hgroups;
    const int b = rest / runs;
    n0 = (rest - b * runs) * nt;
    valid = min(nt, N - n0);
    base = ((size_t)b * T * N + n0) * hd + (size_t)(tile - rest * hgroups) * hb * D;
  };
  // warp 0: q, k and v of a tile into buffer i by bulk copies, one a frame
  // row of a token run (hb == H) or of a token (a head group)
  auto load_tile = [&](int tile, int i) {
    size_t base;
    int n0, valid;
    tile_at(tile, base, n0, valid);
    const int runs_of = hb == H ? 1 : valid;  // copies a frame row and tensor
    const int bytes = (hb == H ? valid : 1) * hb * RD;
    const uint32_t bar = bars + 8 * i;
    const uint32_t dst = smem_u32(bufs + i * 3 * REG);
    if (lane == 0) mbar_expect_tx(bar, 3 * T * runs_of * bytes);
    __syncwarp();
    for (int c = lane; c < 3 * T * runs_of; c += 32) {
      const int x = c / (T * runs_of);  // q, k, v
      const int t = (c - x * T * runs_of) / runs_of;
      const int j = c - (x * T + t) * runs_of;
      const bf16* src = (x == 0 ? q : x == 1 ? k : v) + base + ((size_t)t * N + j) * hd;
      bulk_load(dst + x * REG + t * FP + j * hb * RD, src, bytes, bar);
    }
  };
  // warp 0: the output rows of a tile (output region i) back by bulk copies
  auto store_tile = [&](int tile, int i) {
    size_t base;
    int n0, valid;
    tile_at(tile, base, n0, valid);
    const int runs_of = hb == H ? 1 : valid;
    const int bytes = (hb == H ? valid : 1) * hb * RD;
    const uint32_t src = smem_u32(outs + i * T * FP);
    for (int c = lane; c < T * runs_of; c += 32) {
      const int t = c / runs_of;
      const int j = c - t * runs_of;
      bulk_store(o + base + ((size_t)t * N + j) * hd, src + t * FP + j * hb * RD, bytes);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };

  // B fragments of K2[tq]^T for k step kk (columns kk*16 ..) and key
  // n-blocks nb, nb + 1 (bk[0..1], bk[2..3]), from the staged table or
  // from device memory (`staged` a compile-time bool, so that the phases'
  // unrolled loops hold no branch)
  auto k2_frags = [&](auto staged, int tq, int nb, int kk, uint32_t* bk) {
    if constexpr (decltype(staged)::value) {
      const int key = nb * 8 + (lane & 7) + (lane >> 4) * 8;
      const int c = kk * 2 + ((lane >> 3) & 1);
      ldsm_x4(c < segs ? smem_u32(k2s + (tq * TP + key) * RT + c * 16) : zero, bk);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tk = (nb + i) * 8 + g;
        const int d0 = kk * 16 + t4 * 2;
        const bf16* src = k2 + ((size_t)tq * T + tk) * D + d0;
        bk[2 * i] = tk < T && d0 < D ? ldg_u32(src) : 0u;
        bk[2 * i + 1] = tk < T && d0 + 8 < D ? ldg_u32(src + 8) : 0u;
      }
    }
  };
  // B fragments of V2[tq] for k step kk (keys kk*16 ..) and column
  // n-blocks j, j + 1 (bv[0..1], bv[2..3])
  auto v2_frags = [&](auto staged, int tq, int kk, int j, uint32_t* bv) {
    if constexpr (decltype(staged)::value) {
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = j + (lane >> 4);
      ldsm_x4_trans(c < segs ? smem_u32(v2s + (tq * TP + key) * RT + c * 16) : zero, bv);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = (j + i) * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tk = kk * 16 + h * 8 + t4 * 2;
          const bf16* src = v2 + ((size_t)tq * T + tk) * D + d;
          const uint32_t lo = tk < T && d < D ? ldg_u16(src) : 0u;
          const uint32_t hi = tk + 1 < T && d < D ? ldg_u16(src + D) : 0u;
          bv[2 * i + h] = lo | (hi << 16);
        }
      }
    }
  };
  // O1[row][d] in f32: columns below HALF over the q row, the rest over the k row
  auto o1_at = [&](unsigned char* qk, int row_ofs, int d) {
    return d < HALF ? reinterpret_cast<float*>(qk + row_ofs) + d
                    : reinterpret_cast<float*>(qk + REG + row_ofs) + (d - HALF);
  };

  // zero chunk, mbarriers, zeroed buffers (frames past T stay zero: v rows
  // there meet P = 0), and the tables once a block (rows past T zero)
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem)[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = threadIdx.x; e < nbuf * 3 * REG / 16; e += blockDim.x)
    reinterpret_cast<uint4*>(bufs)[e] = make_uint4(0u, 0u, 0u, 0u);
  if (tables) {
    for (int e = threadIdx.x; e < T * TP * segs; e += blockDim.x) {
      const int row = e / segs;  // tq * TP + tk
      const int sg = e - row * segs;
      const int tq = row / TP;
      const int tk = row - tq * TP;
      const bool ok = tk < T;
      const size_t src = ok ? ((size_t)tq * T + tk) * D + sg * 8 : 0;
      cp_async16(smem_u32(k2s + row * RT + sg * 16), k2 + src, ok);
      cp_async16(smem_u32(v2s + row * RT + sg * 16), v2 + src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before the bulk copies
  __syncthreads();

  int tile = blockIdx.x;
  const int stride = gridDim.x;
  if (warp == 0)
    for (int i = 0; i < nbuf; ++i)
      if (tile + i * stride < tiles) load_tile(tile + i * stride, i);
  uint32_t phase = 0;  // bit i: parity of buffer i's next load
  for (int it = 0; tile < tiles; tile += stride, ++it) {
    const int cur = it & (nbuf - 1);
    unsigned char* qk = bufs + cur * 3 * REG;  // k region at + REG, v at + 2 REG
    unsigned char* vs = qk + 2 * REG;
    mbar_wait(bars + 8 * cur, (phase >> cur) & 1);
    phase ^= 1u << cur;

    // 1. token-major: bias[p][tq][tk] = q_p[tq] . K2[tq, tk], 16 pairs an mma row block
    auto bias_phase = [&](auto staged) {
      for (int w = warp; w < T * G; w += warps) {
        const int tq = G == 1 ? w : w / G;
        const int p0 = (w - tq * G) * 16;
        const int pa = p0 + (lane & 15);
        uint32_t aq[KD][4];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int c = kk * 2 + (lane >> 4);
          ldsm_x4(pa < P && c < segs ? smem_u32(qk + tq * FP + pa * RD + c * 16) : zero, aq[kk]);
        }
        float acc[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.0f;
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            uint32_t bk[4];
            k2_frags(staged, tq, nb, kk, bk);
            mma_16816(acc[nb], aq[kk], bk[0], bk[1]);
            mma_16816(acc[nb + 1], aq[kk], bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = p0 + g + half * 8;
          float* dst = slots + min(p, P - 1) * XP + tq * XR + t4 * 2;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            if (p < P)
              *reinterpret_cast<float2*>(dst + nb * 8) =
                  make_float2(acc[nb][2 * half], acc[nb][2 * half + 1]);
        }
      }
    };
    if (tables) bias_phase(std::true_type());
    else bias_phase(std::false_type());
    __syncthreads();

    // 2. frame-major, one pair a warp item: S = q k^T + bias, softmax, P
    // (over the first halves of the pair's bias rows); then O1 = P v over
    // the pair's q and k rows (this warp alone reads either here)
    for (int p = warp; p < P; p += warps) {
      float* slot = slots + p * XP;
      uint32_t pw[NB][2];  // the last query tile's P, packed: with KT = 1 the A operand of P v
      for (int mt = 0; mt < KT && mt * 16 < T; ++mt) {
        float sc[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t a[4];
          const int ca = kk * 2 + (lane >> 4);
          ldsm_x4(ca < segs ? smem_u32(qk + (mt * 16 + (lane & 15)) * FP + p * RD + ca * 16)
                            : zero,
                  a);
          const int cb = kk * 2 + ((lane >> 3) & 1);
#pragma unroll
          for (int nb = 0; nb < NB; nb += 2) {
            uint32_t bk[4];
            const int key = nb * 8 + (lane & 7) + (lane >> 4) * 8;
            ldsm_x4(cb < segs ? smem_u32(qk + REG + key * FP + p * RD + cb * 16) : zero, bk);
            mma_16816(sc[nb], a, bk[0], bk[1]);
            mma_16816(sc[nb + 1], a, bk[2], bk[3]);
          }
        }
        // bias, keys past T masked; this lane's rows tq = mt*16 + g and + 8
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tq = mt * 16 + g + half * 8;
          const float* bias = slot + tq * XR + t4 * 2;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            // rows past T read whatever the slot holds and drop it
            const float2 add = *reinterpret_cast<const float2*>(bias + nb * 8);
            const int tk = nb * 8 + t4 * 2;
            float& s0 = sc[nb][2 * half];
            float& s1 = sc[nb][2 * half + 1];
            s0 = tk >= T ? -CUDART_INF_F : tq < T ? s0 + add.x : s0;
            s1 = tk + 1 >= T ? -CUDART_INF_F : tq < T ? s1 + add.y : s1;
            mx[half] = fmaxf(mx[half], fmaxf(s0, s1));
          }
        }
        float inv[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
          const float shift = mx[half] * scale_log2;  // scale > 0; key 0 is never masked
          float sum = 0.0f;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
            for (int e = 2 * half; e < 2 * half + 2; ++e) {
              sc[nb][e] = exp2_ftz(fmaf(sc[nb][e], scale_log2, -shift));
              sum += sc[nb][e];
            }
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          inv[half] = __fdividef(1.0f, sum);
        }
        __syncwarp();  // every lane has read these bias rows
        // P, normalised and rounded to bf16, over the bias rows
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned char* prow =
              reinterpret_cast<unsigned char*>(slot + (mt * 16 + g + half * 8) * XR) + t4 * 4;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            pw[nb][half] =
                pack_bf16(sc[nb][2 * half] * inv[half], sc[nb][2 * half + 1] * inv[half]);
            *reinterpret_cast<uint32_t*>(prow + nb * 16) = pw[nb][half];
          }
        }
      }
      __syncwarp();
      for (int mt = 0; mt < KT && mt * 16 < T; ++mt) {
        float acc[NO][4];
#pragma unroll
        for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t pa[4];
          if constexpr (KT == 1) {  // the C layout of two n-blocks is the A layout of a k step
            pa[0] = pw[0][0];
            pa[1] = pw[0][1];
            pa[2] = pw[1][0];
            pa[3] = pw[1][1];
          } else {
            ldsm_x4(smem_u32(slot + (mt * 16 + (lane & 15)) * XR) + (kk * 2 + (lane >> 4)) * 16,
                    pa);
          }
          const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          // columns past D meet the zero chunk; no branch, so the loads
          // are scheduled ahead
#pragma unroll
          for (int j = 0; j < NO; j += 2) {
            uint32_t bv[4];
            const int c = j + (lane >> 4);
            ldsm_x4_trans(c < segs ? smem_u32(vs + key * FP + p * RD + c * 16) : zero, bv);
            mma_16816(acc[j], pa, bv[0], bv[1]);
            mma_16816(acc[j + 1], pa, bv[2], bv[3]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int tq = mt * 16 + g + half * 8;
#pragma unroll
          for (int j = 0; j < NO; ++j)
            if (tq < T && j < segs)
              *reinterpret_cast<float2*>(o1_at(qk, tq * FP + p * RD, j * 8 + t4 * 2)) =
                  make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        }
      }
    }
    // the output copies of two tiles before (the older of the two groups) have read their region
    if (warp == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();

    // 3. token-major: out = O1 + P_p[tq] . V2[tq], rounded once, into
    // output region it & 1, whose copies of two tiles before have read it
    // (warp 0 waited before the barrier above)
    unsigned char* out = outs + (it & 1) * T * FP;
    auto value_phase = [&](auto staged) {
      for (int w = warp; w < T * G; w += warps) {
        const int tq = G == 1 ? w : w / G;
        const int p0 = (w - tq * G) * 16;
        const int pa = p0 + (lane & 15);
        uint32_t ap[KT][4];
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          ldsm_x4(pa < P ? smem_u32(slots + pa * XP + tq * XR) + (kk * 2 + (lane >> 4)) * 16
                         : zero,
                  ap[kk]);
        // rows of pairs past P read pair P - 1's and store nothing;
        // columns past D meet zeros: no branch, so the loads are
        // scheduled ahead
        int row[2];
#pragma unroll
        for (int half = 0; half < 2; ++half)
          row[half] = tq * FP + min(p0 + g + half * 8, P - 1) * RD;
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          float acc[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            uint32_t bv[4];
            v2_frags(staged, tq, kk, j, bv);
            mma_16816(acc[0], ap[kk], bv[0], bv[1]);
            mma_16816(acc[1], ap[kk], bv[2], bv[3]);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int col = (j + i) * 8 + t4 * 2;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float2 o1 = *reinterpret_cast<const float2*>(o1_at(qk, row[half], col));
              const uint32_t val = pack_bf16(o1.x + acc[i][2 * half], o1.y + acc[i][2 * half + 1]);
              if (p0 + g + half * 8 < P && j + i < segs)
                *reinterpret_cast<uint32_t*>(out + row[half] + col * 2) = val;
            }
          }
        }
      }
    };
    if (tables) value_phase(std::true_type());
    else value_phase(std::false_type());
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the bulk copies
    __syncthreads();
    if (warp == 0) {  // the buffer is free: the tile nbuf on first, then this one's output
      if (tile + nbuf * stride < tiles) load_tile(tile + nbuf * stride, cur);
      store_tile(tile, it & 1);
    }
  }
  if (warp == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int DP, int KT>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* k2, const bf16* v2, bf16* o,
           int B, int T, int N, int H, int D, float scale, const int* plan, cudaStream_t stream) {
  const int nt = plan[0], hb = plan[1], warps = plan[2], tables = plan[3], nbuf = plan[4],
            blocks = plan[5];
  const int bytes = relpos_smem_bytes(16 * KT, D, nt * hb, T, tables, nbuf);
  if (nt < 1 || hb < 1 || H % hb != 0 || warps < 1 || warps > (DP <= 80 ? 16 : 8) ||
      (nbuf != 1 && nbuf != 2) || blocks < 1 ||
      blocks + (long)B * ((N + nt - 1) / nt) * (H / hb) > 0x7fffffffL || bytes > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // the shared-memory attribute, once per kernel
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        relpos_mha_kernel<DP, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  relpos_mha_kernel<DP, KT><<<blocks, warps * 32, bytes, stream>>>(
      q, k, v, k2, v2, o, B, T, N, H, D, nt, hb, tables, nbuf, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_t(const bf16* q, const bf16* k, const bf16* v, const bf16* k2, const bf16* v2, bf16* o,
             int B, int T, int N, int H, int D, float scale, const int* plan, cudaStream_t stream) {
  switch ((T + 15) / 16) {
    case 1: return launch<DP, 1>(q, k, v, k2, v2, o, B, T, N, H, D, scale, plan, stream);
    case 2: return launch<DP, 2>(q, k, v, k2, v2, o, B, T, N, H, D, scale, plan, stream);
    case 3: return launch<DP, 3>(q, k, v, k2, v2, o, B, T, N, H, D, scale, plan, stream);
    case 4: return launch<DP, 4>(q, k, v, k2, v2, o, B, T, N, H, D, scale, plan, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/k/v/o (B*T, N, H*D) bf16, k2/v2 (T, T, D) bf16, under the plan of
// kernels/relpos_mha.py::relpos_plan: nt tokens and hb heads a tile, warps
// a block, whether K2/V2 are staged in shared memory, and the persistent
// blocks. Queries nothing of the device. Returns a CUDA error code; 1
// (cudaErrorInvalidValue) for a head dim that is not a multiple of 8 or
// above 160, T outside 1 .. 64, or a plan the kernel does not take.
extern "C" int t2v_relpos_mha(const void* q, const void* k, const void* v, const void* k2,
                              const void* v2, void* o, int B, int T, int N, int H, int D,
                              float scale, int nt, int hb, int warps, int tables, int nbuf,
                              int blocks, void* stream) {
  if (D % 8 != 0 || D < 8 || D > MAX_D || T < 1 || T > 64 || B < 1 || N < 1 || H < 1) return 1;
  const int plan[6] = {nt, hb, warps, tables, nbuf, blocks};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* k2p = static_cast<const bf16*>(k2);
  const bf16* v2p = static_cast<const bf16*>(v2);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define T2V_RELPOS(dp) return launch_t<dp>(qp, kp, vp, k2p, v2p, op, B, T, N, H, D, scale, plan, st)
  if (D <= 48) T2V_RELPOS(48);
  if (D <= 64) T2V_RELPOS(64);
  if (D <= 80) T2V_RELPOS(80);
  T2V_RELPOS(160);
#undef T2V_RELPOS
}
