// Flash attention forward over head-folded (B, N, D) queries and (B, S, D)
// keys/values: online softmax over key/value tiles with an f32 running
// max, sum and accumulator; key columns >= S are masked and a row whose sum
// stays 0 is guarded against 0/0. With a non-null ``lse`` it also writes the
// f32 log-sum-exp of each row's scaled scores (max + log sum), the residual
// the backward kernels (flash_attention_bwd.cu) recompute p from.
//
// Replaces: t2v/kernels/flash_attention.py::_flash_kernel (driven by
// flash_attention / _flash_call; the VAE mid-block attention reaches it
// through t2v/kernels/attention.py::attention).
//
// What bounds it on the H100: at the UNet's 32x32 level (N = S = 1024,
// D = 64) a 128-row query tile does 4 * 128 * S * D flops on S * D * 4 bytes
// of K/V, which come from L2 after a head's first tile; q, k, v and o are
// 4 * 31 MB for all 240 heads against 64.4 GFLOP (0.0651 ms at 989 TFLOP/s
// against 0.0375 ms for the bytes), so the tensor cores and the softmax's
// exponentials bound it, not device memory.
//
// Design (FlashAttention-3-shaped, sm_90a; the tiles come from
// kernels/flash_attention.py::flash_plan):
//  * one block of three warpgroups per (batch*head, query tile): one
//    producer thread and two consumer warpgroups; `setmaxnreg` hands the
//    producer's registers to the consumers. The producer brings the query
//    tile once by TMA and streams K and V tiles of BKV keys through a ring
//    of `stages` shared-memory stages, K and V on barriers of their own, so
//    a stage's K is refilled as soon as both consumers' Q.K^T products have
//    read it, while they still run P.V;
//  * every tile lands 128-byte swizzled in 64-column boxes. The tensor maps
//    are 3-D, (d, rows, B), with the real head dim d as the inner extent:
//    TMA zero-fills the columns d..63 of a box (d = 40 runs as one box,
//    d = 80 as two, d = 160 as three), the rows past N or S of a sample,
//    and the store clips both, so no load or store code sees a ragged
//    edge. The inner stride, 2d bytes, is a multiple of 16 for every d of
//    the wrapper's set;
//  * S = Q.K^T is a wgmma with both operands in shared memory, K read
//    K-major; a K step of 16 columns that lies wholly in zero fill is
//    never issued (ceil(d / 16) steps). The online softmax runs on the f32
//    accumulator in registers, in the log2 domain with the scale folded
//    into the exponent's FMA, masks keys >= S only in a ragged last tile,
//    and rounds P to bf16 in registers, where the accumulator layout of
//    two 8-column blocks is the A-fragment layout of a 16-deep K step: P
//    is the register A operand of the P.V wgmma, V its MN-major B operand
//    from shared memory. O stays in f32 registers; the epilogue divides by
//    the row sum, stages bf16 O in the warpgroup's (now free) part of the
//    query tile and writes it by TMA store, and writes the lse;
//  * d <= 160 splits the 128 query rows: each consumer warpgroup owns 64
//    rows and all of O's columns (at most 64 x 192 f32, 96 registers a
//    thread). d = 512 (the VAE's single head) cannot: a 64 x 512 f32 O is
//    256 registers a thread. It takes 64-row query tiles, and each
//    consumer warpgroup owns 256 of O's columns (128 registers) and
//    computes the whole 64 x BKV score tile itself. That repeats the
//    Q.K^T product (1.5x the flops of the call) but keeps P in registers:
//    the alternative, one warpgroup writing P to shared memory for the
//    others, costs a cross-warpgroup handoff every tile, for a kernel the
//    VAE launches once a video. Q (64 KB) and one K and V stage (128 KB)
//    fit the block's shared memory.
//
// Measured (chip_smoke.py on an "NVIDIA H100 80GB HBM3, 700.00 W"; PERF.md
// section 6): at (240, 1024, 1024, 64) about 0.19 ms a call against SDPA's
// 0.16 and the bound 0.0651; at d = 512 about 0.18 ms against SDPA's 0.46.
// Scratch A/B calls on that card (not kept, so no numbers here) chose the
// 128-key tile at d <= 64, ex2.approx.ftz and the ping-pong loop. What
// holds it back: one block an SM, so a block's query load and epilogue
// overlap nothing, and the exponentials (one a score, on the
// special-function unit) take as long as both products at d = 64. ptxas
// compiles every instantiation to 168 registers a thread, the launch
// bound's share: the d = 512 tile and a 128-key d = 80 tile spill and have
// their wgmmas serialized, so d = 80 takes 64-key tiles.
#include "hopper.cuh"

using namespace t2v;

namespace {

constexpr int MAX_SMEM = 232448;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_SLACK = 2048;  // the barriers and the 1024-byte alignment of the tiles
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

// The geometry of head dim D: 64-column boxes, query rows a block, output
// boxes a consumer warpgroup owns, and K steps of the score product.
template <int D>
struct FlashGeom {
  static constexpr int NB = (D + 63) / 64;
  static constexpr bool COLS = D > 160;  // the column split of d = 512
  static constexpr int BQ = COLS ? 64 : 128;
  static constexpr int NBO = COLS ? NB / 2 : NB;
  static constexpr int KSTEPS = (D + 15) / 16;
  static constexpr int Q_BOX = BQ * 128;  // bytes of one 64-column box of the query tile
};

// dynamic shared memory of a block, mirrored by
// kernels/flash_attention.py::flash_plan: the query tile and `stages` K and
// V tiles of bkv rows
__host__ __device__ constexpr int flash_smem_bytes(int d, int bkv, int stages) {
  return ((d + 63) / 64) * ((d > 160 ? 64 : 128) + stages * 2 * bkv) * 128 + SMEM_SLACK;
}

// barriers, 8 bytes each from the start of shared memory: the query tile's
// at 0, then per stage K full, V full, K empty, V empty
__device__ __forceinline__ uint32_t k_full(uint32_t base, int s) { return base + 8 * (1 + 4 * s); }
__device__ __forceinline__ uint32_t v_full(uint32_t base, int s) { return base + 8 * (2 + 4 * s); }
__device__ __forceinline__ uint32_t k_empty(uint32_t base, int s) { return base + 8 * (3 + 4 * s); }
__device__ __forceinline__ uint32_t v_empty(uint32_t base, int s) { return base + 8 * (4 + 4 * s); }

template <int BKV>
__device__ __forceinline__ void qk_k16(float* sc, uint64_t dq, uint64_t dk, int accumulate) {
  if constexpr (BKV == 128) wgmma_ss_n128<0>(sc, dq, dk, accumulate);
  else wgmma_ss_n64<0>(sc, dq, dk, accumulate);
}

template <int NBO>
__device__ __forceinline__ void pv_k16(float* o, const uint32_t* p, uint64_t dv) {
  if constexpr (NBO == 1) wgmma_rs_n64(o, p, dv);
  else if constexpr (NBO == 2) wgmma_rs_n128(o, p, dv);
  else if constexpr (NBO == 3) wgmma_rs_n192(o, p, dv);
  else wgmma_rs_n256(o, p, dv);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the special-function unit alone (ex2.approx.ftz): exp2f adds
// range handling for results below 2^-126, which a probability that small
// does not need (faster at d = 64 on an H100)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One consumer warpgroup: the loop over the key tiles, then the epilogue.
// Up to d = 64 (one output box) the loop is FlashAttention-3's: the Q.K^T
// of tile j is issued together with the P.V of tile j - 1 and the softmax
// of tile j runs while that P.V is on the tensor cores, and the two
// warpgroups take turns to issue their products (ping-pong), so one's
// softmax runs under the other's products (faster than the in-order loop
// at (240, 1024, 1024, 64) on an H100; the overlap without the turns, or
// turns around each product of the in-order loop, were slower than it).
// Wider heads run in order: the overlap keeps the next
// score tile live beside P and O, past their registers.
template <int D, int BKV>
__device__ __forceinline__ void flash_consume(unsigned char* smem, uint32_t base, uint32_t q_s,
                                              uint32_t ring, const CUtensorMap* o_map,
                                              float* __restrict__ lse, int N, int S,
                                              float scale_log2, int stages, int q0, int bh,
                                              int wg, int tid) {
  using G = FlashGeom<D>;
  constexpr int KV_BOX = BKV * 128;
  constexpr int TILE = G::NB * KV_BOX;
  constexpr int NS = BKV / 2;       // score registers: 64 x BKV f32 over 128 threads
  constexpr int NO = G::NBO * 32;   // output registers: 64 x 64 * NBO f32
  constexpr bool PINGPONG = G::NBO == 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  // the warpgroup's 64 query rows, as a byte offset inside each box of the
  // query tile, and its first output box
  const uint32_t q_rows = G::COLS ? 0u : static_cast<uint32_t>(wg) * 64 * 128;
  const int row0 = q0 + (G::COLS ? 0 : wg * 64);
  const int obox0 = G::COLS ? wg * G::NBO : 0;
  const int n_kv = (S + BKV - 1) / BKV;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.0f, 0.0f};
  float sc[NS];
  uint32_t pa[BKV / 16][4];

  // the turns, on named barriers 4 + wg: wait for this warpgroup's, then
  // pass the other's
  auto my_turn = [&]() { named_barrier(4 + wg, 256); };
  auto pass_turn = [&]() { named_arrive(5 - wg, 256); };
  // S = Q K^T of tile j, issued; the first K step overwrites the accumulator
  auto issue_qk = [&](int j) {
    const int s = j % stages;
    const uint32_t kt = ring + s * 2 * TILE;
    mbar_wait(k_full(base, s), (j / stages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      qk_k16<BKV>(sc, desc_k_major(q_s + (kk / 4) * G::Q_BOX + q_rows + (kk % 4) * 32),
                  desc_k_major(kt + (kk / 4) * KV_BOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
  };
  // after its wait: the scores fenced, K's stage released
  auto finish_qk = [&](int j) {
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_acc(sc[i]);
    if (lane == 0) mbar_arrive(k_empty(base, j % stages));
  };
  // O += P V of tile j over the warpgroup's output boxes, issued
  auto issue_pv = [&](int j) {
    const int s = j % stages;
    const uint32_t vt = ring + s * 2 * TILE + TILE;
    mbar_wait(v_full(base, s), (j / stages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      pv_k16<G::NBO>(o, pa[kk], desc_mn_major(vt + obox0 * KV_BOX + kk * 2048, KV_BOX));
    wgmma_commit();
  };
  // after its wait: O fenced, P's registers live until then, V's stage
  // released
  auto finish_pv = [&](int j) {
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_acc(o[i]);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(pa[kk][i]);
    if (lane == 0) mbar_arrive(v_empty(base, j % stages));
  };
  // online softmax of tile j in the log2 domain on this thread's rows g and
  // g + 8 of its warp's 16 (keys past S exist only in the last tile): P in
  // sc, the row sums updated, and alpha, the factor for O
  auto softmax = [&](int j, float* alpha) {
    if ((j + 1) * BKV > S) {
      const int lim = S - j * BKV;
#pragma unroll
      for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nb * 8 + t4 * 2 + (e & 1) >= lim) sc[nb * 4 + e] = -CUDART_INF_F;
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[nb * 4 + e]);
    float use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i] * scale_log2);  // scale > 0
      use[i] = m_new == -CUDART_INF_F ? 0.0f : m_new;             // a row with no key yet
      alpha[i] = exp2_ftz(m_run[i] - use[i]);
      m_run[i] = m_new;
    }
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nb * 4 + e] = exp2_ftz(fmaf(sc[nb * 4 + e], scale_log2, -use[e / 2]));
        ls[e / 2] += sc[nb * 4 + e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + ls[i];
  };
  auto rescale = [&](const float* alpha) {
#pragma unroll
    for (int jo = 0; jo < NO / 4; ++jo) {
      o[jo * 4 + 0] *= alpha[0];
      o[jo * 4 + 1] *= alpha[0];
      o[jo * 4 + 2] *= alpha[1];
      o[jo * 4 + 3] *= alpha[1];
    }
  };
  // P rounded to bf16 as the A fragments of 16-key steps
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  mbar_wait(base, 0);
  float alpha[2];
  if constexpr (PINGPONG) {
    // warpgroup 0 goes first: its own arrival opens its first turn
    if (wg == 0) named_arrive(4, 256);
    my_turn();
    issue_qk(0);
    pass_turn();
    wgmma_wait<0>();
    finish_qk(0);
    softmax(0, alpha);
    pack_p();
    for (int j = 1; j < n_kv; ++j) {
      my_turn();
      issue_qk(j);
      issue_pv(j - 1);
      pass_turn();
      wgmma_wait<1>();
      finish_qk(j);
      softmax(j, alpha);
      wgmma_wait<0>();
      finish_pv(j - 1);
      rescale(alpha);
      pack_p();
    }
    my_turn();
    issue_pv(n_kv - 1);
    pass_turn();
    wgmma_wait<0>();
    finish_pv(n_kv - 1);
    // warpgroup 0 takes the turn warpgroup 1 passed last, so both barriers
    // end empty
    if (wg == 0) my_turn();
  } else {
    for (int j = 0; j < n_kv; ++j) {
      issue_qk(j);
      wgmma_wait<0>();
      finish_qk(j);
      softmax(j, alpha);
      rescale(alpha);
      pack_p();
      issue_pv(j);
      wgmma_wait<0>();
      finish_pv(j);
    }
  }

  // the row sums over the quad's four lanes; a row whose sum stays 0 is
  // written as 0
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[i] = l;
    inv[i] = 1.0f / (l == 0.0f ? 1.0f : l);
  }
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the warpgroup's 64
  if (lse != nullptr && (!G::COLS || wg == 0) && t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + r0 + 8 * i;
      if (r < N) lse[(size_t)bh * N + r] = (m_run[i] + log2f(l_run[i])) * LN2;
    }
  }

  // both consumer warpgroups are past their last Q K^T (at d = 512 each
  // reads every box of the query tile), so the tile takes the staged output:
  // 64-column boxes, 128-byte swizzled (16-byte group c of row r at c ^ (r % 8))
  named_barrier(1, 256);
#pragma unroll
  for (int c = 0; c < G::NBO; ++c) {
    unsigned char* box = smem + (q_s - base) + (obox0 + c) * G::Q_BOX + q_rows;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int jn = c * 8 + jj;
      unsigned char* at = box + ((jj ^ g) * 16) + t4 * 4;
      *reinterpret_cast<uint32_t*>(at + r0 * 128) =
          pack_bf16(o[jn * 4 + 0] * inv[0], o[jn * 4 + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(at + (r0 + 8) * 128) =
          pack_bf16(o[jn * 4 + 2] * inv[1], o[jn * 4 + 3] * inv[1]);
    }
  }
  // generic-proxy writes made visible to the TMA store first
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(2 + wg, 128);
  if (tid == 0) {
    for (int c = 0; c < G::NBO; ++c)
      tma_store_3d(o_map, q_s + (obox0 + c) * G::Q_BOX + q_rows, (obox0 + c) * 64, row0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D, int BKV>
__global__ void __launch_bounds__(384, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap o_map,
    float* __restrict__ lse, int N, int S, float scale_log2, int stages) {
  using G = FlashGeom<D>;
  constexpr int KV_BOX = BKV * 128;
  constexpr int TILE = G::NB * KV_BOX;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t q_s = (base + 8 * (1 + 4 * MAX_STAGES) + 1023) & ~1023u;
  const uint32_t ring = q_s + G::NB * G::Q_BOX;  // stage s: K at + 2 s TILE, V at + TILE
  const int q0 = blockIdx.x * G::BQ;
  const int bh = blockIdx.y;
  // the warpgroup index, broadcast from lane 0 so that the role branch is
  // warp-uniform to the compiler (setmaxnreg needs it)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(base, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(k_full(base, s), 1);
      mbar_init(v_full(base, s), 1);
      mbar_init(k_empty(base, s), 8);  // one arrival per consumer warp
      mbar_init(v_empty(base, s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(base, G::NB * G::Q_BOX);
      for (int c = 0; c < G::NB; ++c)
        tma_load_3d(q_s + c * G::Q_BOX, &q_map, base, c * 64, q0, bh);
      const int n_kv = (S + BKV - 1) / BKV;
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % stages;
        const uint32_t ph = ((j / stages) & 1) ^ 1;
        const uint32_t kt = ring + s * 2 * TILE;
        mbar_wait(k_empty(base, s), ph);
        mbar_expect_tx(k_full(base, s), TILE);
        for (int c = 0; c < G::NB; ++c)
          tma_load_3d(kt + c * KV_BOX, &k_map, k_full(base, s), c * 64, j * BKV, bh);
        mbar_wait(v_empty(base, s), ph);
        mbar_expect_tx(v_full(base, s), TILE);
        for (int c = 0; c < G::NB; ++c)
          tma_load_3d(kt + TILE + c * KV_BOX, &v_map, v_full(base, s), c * 64, j * BKV, bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    flash_consume<D, BKV>(smem, base, q_s, ring, &o_map, lse, N, S, scale_log2, stages, q0, bh,
                          wg, tid);
  }
}

template <int D, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int N, int S,
           float scale, int stages, cudaStream_t stream) {
  using G = FlashGeom<D>;
  const int smem = flash_smem_bytes(D, BKV, stages);
  if (stages < 1 || stages > MAX_STAGES || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;  // the shared-memory attribute, once per instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  CUtensorMap q_map, k_map, v_map, o_map;
  const cuuint64_t q_dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t q_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kv_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t q_box[3] = {64, (cuuint32_t)G::BQ, 1};
  const cuuint32_t kv_box[3] = {64, (cuuint32_t)BKV, 1};
  const cuuint32_t o_box[3] = {64, 64, 1};
  if (!make_map(&q_map, q, 3, q_dims, q_strides, q_box) ||
      !make_map(&k_map, k, 3, kv_dims, kv_strides, kv_box) ||
      !make_map(&v_map, v, 3, kv_dims, kv_strides, kv_box) ||
      !make_map(&o_map, o, 3, q_dims, q_strides, o_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + G::BQ - 1) / G::BQ, B);
  flash_fwd_kernel<D, BKV><<<grid, 384, smem, stream>>>(q_map, k_map, v_map, o_map, lse, N, S,
                                                        scale * LOG2E, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a CUDA error code; 1 (cudaErrorInvalidValue) for a head dim
// outside {40, 64, 80, 160, 512} or a plan the kernel does not take. ``lse``
// is null or a (B, N) f32 buffer. ``bkv`` (keys a tile) and ``stages``
// come from kernels/flash_attention.py::flash_plan.
extern "C" int t2v_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int N, int S, int D, float scale,
                                       int bkv, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B < 1 || N < 1 || S < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
#define T2V_FLASH(D_, BKV_) \
  if (D == D_ && bkv == BKV_) return launch<D_, BKV_>(q, k, v, o, l, B, N, S, scale, stages, st);
  T2V_FLASH(40, 128)
  T2V_FLASH(40, 64)
  T2V_FLASH(64, 128)
  T2V_FLASH(64, 64)
  T2V_FLASH(80, 64)
  T2V_FLASH(160, 64)
  T2V_FLASH(512, 64)
#undef T2V_FLASH
  return static_cast<int>(cudaErrorInvalidValue);
}
