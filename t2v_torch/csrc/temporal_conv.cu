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
// finalised over the whole sample (or are finalised from its raw sums)
// and leave as per-row-tile partials that a third launch sums over every
// tile, and the frame padding is the zero fill
// of out-of-range rows in the tensor-memory-accelerator (TMA) loads of the
// already activated input. Its halo operand and chunk grid are not carried
// over.
//
// What bounds it on the H100: each layer is a GEMM of M = F*HW rows
// (frame, token) per sample, K = 3*C (three frame taps), N = C:
// 2*M*3C*C flops against ~2*M*C*2 bytes of activations, hundreds of flops
// per byte at C >= 320, above the card's ~295 flop/byte ridge: the tensor
// cores bound it (0.0305 ms at x (2, 24, 1024, 320)).
//
// Design (three launches per layer, one C entry):
//  * temporal_conv_act_kernel, the prologue, once per element. A thread
//    keeps eight channels at every step and first folds their GroupNorm
//    into one scale and shift each, in registers (xn = x*a + b, f32; inside
//    the chain the block also finalises the statistics from the previous
//    layer's raw sums, so the O(B*C) glue costs no launch), then applies
//    SiLU and rounds to bf16 into a scratch tensor of x's shape: 16-byte
//    loads, four in flight a thread, and 16-byte stores; bound by bytes
//    (4 B an element). A
//    separate pass, not a prologue applied where A is consumed: the frame
//    padding then is TMA's zero fill, and A and W both go to wgmma from
//    shared memory.
//  * temporal_conv_gemm_kernel: an implicit GEMM on wgmma (sm_90a). A block
//    owns a BM x BN output tile of one sample (BM = 64 * consumer
//    warpgroups, BN up to 256; C = 320 runs as a 256-wide and a ragged
//    64-wide column tile); the tile comes from
//    kernels/temporal_conv.py::layer_plan, per shape. One producer thread
//    feeds a ring of `stages` shared-memory stages by TMA through
//    mbarriers: per K step (one frame tap, 64 channels) the
//    activation box (64 channels, BM rows, 1 sample) at row
//    m0 + (tap - 1) * HW of a 3-D tensor map (C, F*HW, B) -- rows outside
//    the sample, i.e. frames -1 and F, arrive as zeros, which is the
//    Conv3d zero padding since the activation was applied before -- and
//    one weight box (64 out-channels, 64 in-channels of W viewed as
//    (3C, C)) for each 64 columns of the tile. Both land 128-byte
//    swizzled; A is read K-major, W MN-major (its out-channels are
//    contiguous), by wgmma straight from shared memory.
//    The consumer warpgroups keep one wgmma group in flight and release a
//    stage when the group that read it has finished.
//  * epilogue in registers in the JAX order: bf16(acc) + bf16(bias), then
//    + residual in bf16; the bf16 tile is staged in the (now free) ring,
//    128-byte swizzled, and leaves by TMA stores, which clip the rows past
//    the sample's end. Statistics: per-column sum and sum^2 of the rounded
//    output reduced with warp shuffles, then across warps in shared
//    memory: one partial row per row tile, (B, n_row_tiles, 2, C), which
//    temporal_conv_stats_kernel, the entry's third launch, sums in a fixed
//    order into (B, 2, C). Blocks run in any order and nothing carries between
//    them; no float atomics, no frame limit (int32 row coordinates hold
//    250 frames x 1024 tokens).
//  * what holds it back: the tiles are L2-bound. Each block streams its
//    A boxes (three times, once a tap) and its W boxes from L2; a 128 x 256
//    tile does 85 flops a byte so moved, at about 47 GB/s of L2 into one
//    SM's shared memory about half the tensor cores' rate. Wider tiles
//    need more than the 168 registers a thread of three warpgroups has (a
//    128 x 320 tile spilled and ran slower). Two variants measured slower
//    on an H100: clusters of two blocks that multicast W (each stage waits
//    for both blocks' release), and a persistent grid (three stages beside
//    the epilogue's own buffers, and a static share of tiles).
//  * measured (chip_smoke.py --only kernels on an "NVIDIA H100 80GB HBM3,
//    700.00 W"): at x (2, 24, 1024, 320) 0.1486 ms a layer by CUDA events
//    around the wrapper, on the chain's route (torch.profiler: activation
//    pass 0.0248 + GEMM 0.1144 ms, 263.9 TFLOP/s, + statistics sum 0.0030
//    ms; the wrapper's host work about 60 us a call) against the bound
//    0.0305 ms and the matmul yardstick 0.0554; at the 250-frame 8x8 level
//    (2, 250, 64, 1280) 0.6538 ms, 49% of its bound.
#include "hopper.cuh"

using namespace t2v;

namespace {

constexpr int BK = 64;                     // channels per K step: one 128-byte row
constexpr int BOX_BYTES = 64 * BK * 2;     // one 64 x 64 bf16 TMA box
constexpr int MAX_SMEM = 232448;
constexpr int SMEM_SLACK = 3072;           // barriers, the tile's bias, the 1024-byte alignment

// shared-memory plan, mirrored by kernels/temporal_conv.py::layer_plan:
// the ring, which the epilogue reuses for the staged bf16 output tile and
// the per-warp column sums once the main loop is done
__host__ __device__ constexpr int stage_bytes(int bm, int bn) { return bm * BK * 2 + (bn / 64) * BOX_BYTES; }
__host__ __device__ constexpr int epilogue_bytes(int bm, int bn) { return bm * bn * 2 + (bm / 16) * bn * 8; }
__host__ __device__ constexpr int gemm_smem_bytes(int bm, int bn, int stages) {
  return (stages * stage_bytes(bm, bn) > epilogue_bytes(bm, bn) ? stages * stage_bytes(bm, bn)
                                                                 : epilogue_bytes(bm, bn)) +
         SMEM_SLACK;
}

// one K step of 16 over the block's `nch` 64-wide column boxes (nch <
// BN / 64 only in the ragged last column tile)
template <int BN>
__device__ __forceinline__ void mma_k16(float* acc, uint64_t da, uint64_t db, int nch) {
  if constexpr (BN == 64) {
    wgmma_ss_n64<1>(acc, da, db, 1);
  } else if constexpr (BN == 128) {
    if (nch == 2) wgmma_ss_n128<1>(acc, da, db, 1); else wgmma_ss_n64<1>(acc, da, db, 1);
  } else {
    static_assert(BN == 256, "BN is 64, 128 or 256");
    switch (nch) {
      case 4: wgmma_ss_n256<1>(acc, da, db, 1); break;
      case 3: wgmma_ss_n192<1>(acc, da, db, 1); break;
      case 2: wgmma_ss_n128<1>(acc, da, db, 1); break;
      default: wgmma_ss_n64<1>(acc, da, db, 1); break;
    }
  }
}

// a = bf16(silu(x * a_c + b_c)) over the sample blockIdx.y, eight
// channels a thread. The grid stride is a multiple of C / 8 (the launch
// sees to it), so a thread's channels stay the same at every step and it
// folds their GroupNorm once, into registers: a_c = inv_c * gscale_c,
// b_c = gbias_c - mu_c * a_c. `stats` (B, 2, C) f32 is either the
// finalised per-channel [mu; 1/sigma] (raw == 0) or the raw per-channel
// [sum; sum^2] (raw != 0), which the block first reduces to GroupNorm(32)'s
// group mean and 1/sigma over `count` values a group, as
// kernels/temporal_conv.py::finalize_stats does. gscale and gbias are
// bf16 when affine_bf16, else f32.
__global__ void __launch_bounds__(256) temporal_conv_act_kernel(
    const bf16* __restrict__ x, const float* __restrict__ stats, const void* __restrict__ gscale,
    const void* __restrict__ gbias, int affine_bf16, int raw, float count, float eps,
    bf16* __restrict__ a, int sample_vecs, int C) {
  __shared__ float group[2 * 32];  // GroupNorm(32) mean and 1/sigma
  const long long b = blockIdx.y;
  const float* st = stats + b * 2 * C;
  const int gs = C / 32;
  if (raw) {
    if (threadIdx.x < 32) {
      float s = 0.0f, s2 = 0.0f;
      for (int i = 0; i < gs; ++i) {
        s += st[threadIdx.x * gs + i];
        s2 += st[C + threadIdx.x * gs + i];
      }
      const float mu = s / count;
      group[threadIdx.x] = mu;
      group[32 + threadIdx.x] = rsqrtf(s2 / count - mu * mu + eps);
    }
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  const int v0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int c0 = (v0 % (C / 8)) * 8;
  float sc[8], sh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + i;
    const float mu = raw ? group[c / gs] : st[c];
    const float inv = raw ? group[32 + c / gs] : st[C + c];
    const float gsc = affine_bf16 ? __bfloat162float(static_cast<const bf16*>(gscale)[c])
                                  : static_cast<const float*>(gscale)[c];
    const float gsh = affine_bf16 ? __bfloat162float(static_cast<const bf16*>(gbias)[c])
                                  : static_cast<const float*>(gbias)[c];
    sc[i] = inv * gsc;
    sh[i] = gsh - mu * sc[i];
  }
  const bf16* xs = x + b * sample_vecs * 8;
  bf16* as = a + b * sample_vecs * 8;
  // a sample holds fewer than 2^31 elements (the C entry checks), so the
  // element index within it is 32-bit; each thread keeps UNROLL 16-byte
  // loads in flight before it computes
  constexpr int UNROLL = 4;
  for (int v = v0; v < sample_vecs; v += UNROLL * stride) {
    Pack8 in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v + u * stride < sample_vecs)
        in[u].u = *reinterpret_cast<const uint4*>(xs + (size_t)(v + u * stride) * 8);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v + u * stride >= sample_vecs) break;
      Pack8 out;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xn = fmaf(in[u].get(i), sc[i], sh[i]);
        out.set(i, __fdividef(xn, 1.0f + __expf(-xn)));  // 0 once exp(-xn) passes 2^126
      }
      *reinterpret_cast<uint4*>(as + (size_t)(v + u * stride) * 8) = out.u;
    }
  }
}

// The layer's emitted statistics: out[b, j] = the sum over row tiles r of
// partial[b, r, j], for the 2C entries j of [sum; sum^2], in a fixed order
// (no atomics). A block sums 32 entries: 16 row lanes walk the row tiles,
// then one lane adds the 16 lane sums.
__global__ void __launch_bounds__(512) temporal_conv_stats_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int rows, int width) {
  __shared__ float lane[16][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const long long b = blockIdx.y;
  float s = 0.0f;
  if (j < width) {
    const float* p = partial + b * rows * width + j;
#pragma unroll 4
    for (int r = threadIdx.y; r < rows; r += 16) s += p[(size_t)r * width];
  }
  lane[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) t += lane[i][threadIdx.x];
    out[b * width + j] = t;
  }
}

// Where one block's shared memory lies: barriers in the first 128 bytes
// (full[s] at 8s, empty[s] at 8(stages + s)), the tile's conv bias (BN f32),
// then the 1024-aligned ring, which the epilogue reuses for the staged
// output tile (BM x BN bf16 as 128-byte-swizzled 64 x 64 boxes) and the
// per-warp column sums.
struct GemmSmem {
  uint32_t base, tiles;
  int stages;
  float* bias;
  unsigned char* tiles_ptr;
  __device__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + 8 * (stages + s); }
};

// The consumer warpgroups: the main loop over the ring, then the epilogue
// of the block's BM x (64 * nch) tile (bias, residual, bf16 output by TMA,
// a partial-statistics row).
template <int BM, int BN>
__device__ __forceinline__ void gemm_consume(
    const GemmSmem& sm, const CUtensorMap* y_map, const bf16* __restrict__ cbias,
    const bf16* __restrict__ residual, float* __restrict__ partial, int M, int C, int n0, int nch,
    int m0, int b, int wg, int tid) {
  constexpr int NWG = BM / 64;
  constexpr int NCH = BN / 64;
  constexpr int NACC = BN / 2;      // f32 accumulators a thread
  constexpr int STAGE = stage_bytes(BM, BN);
  const int n_k = 3 * (C / BK);
  // the tile's conv bias, read once while the ring fills
  for (int col = threadIdx.x; col < BN; col += NWG * 128)
    sm.bias[col] = col < nch * 64 ? __bfloat162float(cbias[n0 + col]) : 0.0f;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    acc[i] = 0.0f;
    fence_acc(acc[i]);
  }
  for (int it = 0; it < n_k; ++it) {
    const int s = it % sm.stages;
    mbar_wait(sm.full(s), (it / sm.stages) & 1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t a_base = sm.tiles + s * STAGE + wg * 64 * BK * 2;
    const uint32_t b_base = sm.tiles + s * STAGE + BM * BK * 2;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_k16<BN>(acc, desc_k_major(a_base + kk * 32),
                  desc_mn_major(b_base + kk * 16 * 128, BOX_BYTES), nch);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // the warpgroup's MMAs of the previous stage are done: lane 0 of each
    // warp releases it
    if (it > 0 && (threadIdx.x & 31) == 0) mbar_arrive(sm.empty((it - 1) % sm.stages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < NACC; ++i) fence_acc(acc[i]);
  // every consumer's MMAs are done, so the ring is free for the epilogue
  named_barrier(1, NWG * 128);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q4 = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of its warpgroup's 64
  unsigned char* out_tile = sm.tiles_ptr + wg * NCH * BOX_BYTES;  // NCH swizzled 64 x 64 boxes
  float* red = reinterpret_cast<float*>(sm.tiles_ptr + BM * BN * 2);  // [NWG * 4][BN][2]
  const int ma = m0 + wg * 64 + r0;
  const int mb = ma + 8;
  const bool oka = ma < M;
  const bool okb = mb < M;
  const size_t sample = (size_t)b * M * C;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (j >= nch * 8) break;  // past a ragged tile's last box
    const int col = j * 8 + q4 * 2;
    const int n = n0 + col;
    const float bias0 = sm.bias[col];
    const float bias1 = sm.bias[col + 1];
    float o0 = round_bf16(round_bf16(acc[j * 4 + 0]) + bias0);
    float o1 = round_bf16(round_bf16(acc[j * 4 + 1]) + bias1);
    float o2 = round_bf16(round_bf16(acc[j * 4 + 2]) + bias0);
    float o3 = round_bf16(round_bf16(acc[j * 4 + 3]) + bias1);
    if (residual != nullptr) {
      if (oka) {
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
            residual + sample + (size_t)ma * C + n);
        o0 = round_bf16(o0 + __low2float(r));
        o1 = round_bf16(o1 + __high2float(r));
      }
      if (okb) {
        const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
            residual + sample + (size_t)mb * C + n);
        o2 = round_bf16(o2 + __low2float(r));
        o3 = round_bf16(o3 + __high2float(r));
      }
    }
    // 128-byte swizzle of the staged box: 16-byte group (j % 8) of row r
    // sits at group (j % 8) ^ (r % 8), and r % 8 == g for both rows
    unsigned char* box = out_tile + (j / 8) * BOX_BYTES + (((j % 8) ^ g) * 16) + q4 * 4;
    *reinterpret_cast<__nv_bfloat162*>(box + r0 * 128) = __floats2bfloat162_rn(o0, o1);
    *reinterpret_cast<__nv_bfloat162*>(box + (r0 + 8) * 128) = __floats2bfloat162_rn(o2, o3);
    if (partial != nullptr) {
      // rows past the sample's end contribute 0
      float s0 = (oka ? o0 : 0.0f) + (okb ? o2 : 0.0f);
      float s1 = (oka ? o1 : 0.0f) + (okb ? o3 : 0.0f);
      float t0 = (oka ? o0 * o0 : 0.0f) + (okb ? o2 * o2 : 0.0f);
      float t1 = (oka ? o1 * o1 : 0.0f) + (okb ? o3 * o3 : 0.0f);
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        t0 += __shfl_xor_sync(0xffffffffu, t0, off);
        t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      }
      if (g == 0) {
        float* dst = red + ((wg * 4 + warp) * BN + col) * 2;
        dst[0] = s0;
        dst[1] = t0;
        dst[2] = s1;
        dst[3] = t1;
      }
    }
  }

  // the staged tile leaves by TMA: generic-proxy writes made visible first
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(2 + wg, 128);
  if (tid == 0) {
    if (m0 + wg * 64 < M) {
      for (int ch = 0; ch < nch; ++ch)
        tma_store_3d(y_map, smem_u32(out_tile + ch * BOX_BYTES), n0 + ch * 64, m0 + wg * 64, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  if (partial == nullptr) return;
  named_barrier(1, NWG * 128);
  for (int col = threadIdx.x; col < nch * 64; col += NWG * 128) {
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int w = 0; w < NWG * 4; ++w) {
      s += red[(w * BN + col) * 2];
      s2 += red[(w * BN + col) * 2 + 1];
    }
    float* dst = partial + ((size_t)b * gridDim.y + blockIdx.y) * 2 * C + n0 + col;
    dst[0] = s;
    dst[C] = s2;
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__((BM / 64 + 1) * 128, 1) temporal_conv_gemm_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ CUtensorMap y_map, const bf16* __restrict__ cbias,
    const bf16* __restrict__ residual, float* __restrict__ partial, int M, int HW, int C,
    int stages) {
  constexpr int NWG = BM / 64;      // consumer warpgroups, 64 rows each
  constexpr int NCH = BN / 64;      // 64-wide column boxes of a full tile
  constexpr int STAGE = stage_bytes(BM, BN);
  extern __shared__ __align__(1024) unsigned char smem[];
  GemmSmem sm;
  sm.base = smem_u32(smem);
  sm.stages = stages;
  sm.bias = reinterpret_cast<float*>(smem + 128);
  sm.tiles = (sm.base + 128 + BN * 4 + 1023) & ~1023u;
  sm.tiles_ptr = smem + (sm.tiles - sm.base);

  const int n0 = blockIdx.x * BN;
  const int nch = min(NCH, (C - n0) / 64);  // column boxes of this tile: fewer in a ragged last one
  const int m0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int k_steps = C / BK;
  // the warpgroup index, broadcast from lane 0 so that the compiler sees the
  // role branch below as warp-uniform; with it and the producer's registers
  // handed to the consumers (setmaxnreg) the GEMM ran faster on an H100, at
  // every tile, than the same kernel without both
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), NWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // producer warpgroup: one thread issues every TMA load
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      for (int it = 0; it < 3 * k_steps; ++it) {
        const int s = it % stages;
        mbar_wait(sm.empty(s), ((it / stages) & 1) ^ 1);
        mbar_expect_tx(sm.full(s), BM * BK * 2 + nch * BOX_BYTES);
        const int tap = it / k_steps;
        const int k0 = (it % k_steps) * BK;
        const uint32_t st = sm.tiles + s * STAGE;
        tma_load_3d(st, &a_map, sm.full(s), k0, m0 + (tap - 1) * HW, b);
        for (int ch = 0; ch < nch; ++ch)
          tma_load_2d(st + BM * BK * 2 + ch * BOX_BYTES, &w_map, sm.full(s), n0 + ch * 64,
                      tap * C + k0);
      }
    }
  } else {
    if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    gemm_consume<BM, BN>(sm, &y_map, cbias, residual, partial, M, C, n0, nch, m0, b, wg, tid);
  }
}

template <int BM, int BN>
int launch_gemm(const CUtensorMap& a_map, const CUtensorMap& w_map, const CUtensorMap& y_map,
                const bf16* cbias, const bf16* residual, float* partial, int B, int M, int HW,
                int C, int stages, cudaStream_t stream) {
  const int smem = gemm_smem_bytes(BM, BN, stages);
  if (stages < 2 || smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;  // the largest dynamic shared memory set so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(temporal_conv_gemm_kernel<BM, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = MAX_SMEM;
  }
  const dim3 grid((C + BN - 1) / BN, (M + BM - 1) / BM, B);
  temporal_conv_gemm_kernel<BM, BN><<<grid, (BM / 64 + 1) * 128, smem, stream>>>(
      a_map, w_map, y_map, cbias, residual, partial, M, HW, C, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One layer. `stats` (B, 2, C) f32 holds the finalised [mu; 1/sigma], or,
// when raw != 0, the raw channel sums [sum; sum^2] of F*HW values a sample
// (GroupNorm(32) is then finalised in the activation pass, with `eps`).
// gscale and gbias are (C,) bf16 when affine_bf16, else f32. `act` is
// scratch of x's shape. When `stats_out` (B, 2, C) is given, `partial`
// (B, ceil(F*HW / bm), 2, C) f32 is scratch for the GEMM's per-row-tile
// statistics, which a third launch sums into `stats_out`; both may be null
// (no statistics), and so may `residual`. The tile (bm, bn) and the ring
// depth come from kernels/temporal_conv.py::layer_plan. Returns a CUDA
// error code (1 for a plan or shape the kernel does not take).
extern "C" int t2v_temporal_conv_layer(const void* x, const void* stats, const void* gscale,
                                       const void* gbias, const void* w, const void* cbias,
                                       const void* residual, void* act, void* y, void* partial,
                                       void* stats_out,
                                       int B, int F, int HW, int C, int affine_bf16, int raw,
                                       float eps, int bm, int bn, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long M = (long long)F * HW;
  if (C % 64 != 0 || M <= 0 || M * C > 0x7fffffffLL || (M + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sample_vecs = static_cast<int>(M * C / 8);
  // blocks a sample: about 8 an SM in all, a multiple of `unit` so that the
  // grid stride is a multiple of C / 8
  int unit = C / 8;
  for (int t = 256; t % 2 == 0 && unit % 2 == 0; t /= 2) unit /= 2;
  const long long want = (sample_vecs + 255) / 256;
  long long blocks = 8 * 132 / B;
  if (blocks > want) blocks = want;
  if (blocks < 1) blocks = 1;
  blocks = (blocks + unit - 1) / unit * unit;
  temporal_conv_act_kernel<<<dim3(static_cast<unsigned>(blocks), B), 256, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(stats), gscale, gbias, affine_bf16,
      raw, static_cast<float>(M * (C / 32)), eps, static_cast<bf16*>(act), sample_vecs, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap a_map, w_map, y_map;
  const cuuint64_t act_dims[3] = {(cuuint64_t)C, (cuuint64_t)M, (cuuint64_t)B};
  const cuuint64_t act_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)M * C * 2};
  const cuuint32_t a_box[3] = {BK, (cuuint32_t)bm, 1};
  const cuuint32_t y_box[3] = {64, 64, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)C, (cuuint64_t)3 * C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t w_box[2] = {64, BK};
  if (!make_map(&a_map, act, 3, act_dims, act_strides, a_box) ||
      !make_map(&w_map, w, 2, w_dims, w_strides, w_box) ||
      !make_map(&y_map, y, 3, act_dims, act_strides, y_box))
    return static_cast<int>(cudaErrorInvalidValue);

  const bf16* cb = static_cast<const bf16*>(cbias);
  const bf16* res = static_cast<const bf16*>(residual);
  float* part = stats_out == nullptr ? nullptr : static_cast<float*>(partial);
  const int m = static_cast<int>(M);
  err = cudaErrorInvalidValue;
#define T2V_GEMM(BM_, BN_) \
  if (bm == BM_ && bn == BN_) \
    err = static_cast<cudaError_t>( \
        launch_gemm<BM_, BN_>(a_map, w_map, y_map, cb, res, part, B, m, HW, C, stages, st));
  T2V_GEMM(128, 256)
  T2V_GEMM(128, 128)
  T2V_GEMM(128, 64)
  T2V_GEMM(64, 256)
  T2V_GEMM(64, 128)
  T2V_GEMM(64, 64)
#undef T2V_GEMM
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const int rows = static_cast<int>((M + bm - 1) / bm);
  temporal_conv_stats_kernel<<<dim3((2 * C + 31) / 32, B), dim3(32, 16), 0, st>>>(
      part, static_cast<float*>(stats_out), rows, 2 * C);
  return static_cast<int>(cudaGetLastError());
}
