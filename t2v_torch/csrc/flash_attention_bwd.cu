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
// p and ds are rounded to bf16 before their products; every sum is f32.
//
// Replaces: t2v/kernels/flash_attention.py::_flash_bwd_dkv_kernel (dk, dv
// accumulated over query blocks) and ::_flash_bwd_dq_kernel (dq accumulated
// over key/value blocks), both driven by flash_attention_bwd.
//
// What bounds them on the H100: at the UNet's 32x32 level (N = S = 1024,
// D = 64) the dkv kernel does four and the dq kernel three 2 * N * S * D
// flop products a head on 6-7 tensors of N * D bf16 (q, k, v, dO in, dq /
// dk, dv out), whose tiles come from L2 after a head's first pass: at
// (80, 1024, 1024, 64) 42.9 and 32.2 GFLOP (0.0434 and 0.0326 ms at 989
// TFLOP/s) against 0.0065 ms for the bytes, so the tensor cores and the
// exponentials bound them, not device memory. Two kernels recompute the
// scores and dP twice (7 products against FlashAttention-2's 5 with an
// atomic dq): the price of a block owning its outputs, so there are no
// float atomics and the gradients are the same from run to run.
//
// Design (the flash forward's, flash_attention.cu, sm_90a; the tiles come
// from kernels/flash_attention.py::flash_bwd_plan):
//  * a block is two consumer warpgroups and one producer warp (288
//    threads); one producer thread issues every TMA load. ptxas compiles
//    it to at most 168 registers a thread, as a three-warpgroup block,
//    which bounds the tiles below; `setmaxnreg` is not used;
//  * dkv: one block per (batch*head, key tile). K and V are resident,
//    loaded once by TMA; the Q and dO tiles of 64 queries stream through
//    a ring of `stages` shared-memory stages, each with its 64 lse and
//    delta values, which the producer warp's 32 lanes load plainly (0 past
//    N) and release to the stage's barrier with one arrival each: a TMA
//    box of the flat (B*N) f32 arrays would start at b*N*4 bytes, which
//    the copy refuses where that is not a multiple of 16 (N = 333). A
//    consumer computes the TRANSPOSED score tile S^T = K . Q^T and
//    dP^T = V . dO^T as SS wgmmas (A = K or V, K-major; B = the Q or dO
//    tile, K-major), so the f32 accumulator holds P^T and then dS^T with
//    key rows as its M dimension and lse / delta indexed by its column.
//    P^T and dS^T are formed and rounded to bf16 in one pass, each pair
//    of 8-column accumulator blocks becoming the A fragment of a 16-deep
//    K step (the forward's P) as soon as it is done, so S^T and dP^T die
//    as the fragments grow; then dV += P^T . dO and dK += dS^T . Q are RS
//    wgmmas with the same swizzled dO and Q tiles read MN-major. dK and dV
//    stay in f32 registers;
//  * d <= 64: the key tile is 128 rows and each warpgroup owns 64 of them
//    and both of their gradients (S^T, dP^T, dK, dV: 4 x 32 f32 registers
//    a thread at the peak, within the 168). d = 80 and 160 (two and three
//    64-column boxes) take 64-key tiles: both warpgroups compute S^T for
//    the same 64 keys, warpgroup 0 owns dV and warpgroup 1 dP^T, dS^T and
//    dK (at d = 160 32 + 32 + 96 f32 registers, which spill a little).
//    That repeats S^T (5 products for 4) and leaves warpgroup 0 idle a
//    third of the time, at head dims the training path does not reach
//    through this kernel; it keeps every tile in registers with no
//    hand-off between the warpgroups;
//  * dq: one block per (batch*head, 128-row query tile), each warpgroup
//    owning 64 rows, as the forward: Q and dO resident, K and V streamed in
//    64-key tiles; S = Q . K^T and dP = dO . V^T are SS wgmmas, dS is
//    formed and rounded in registers, and dQ += dS . K is an RS wgmma with
//    the K tile read MN-major. lse and delta are each thread's two rows,
//    loaded once. dQ stays in f32 registers (at d = 160 96 of them beside
//    S and dP, which spill a little);
//  * edges as the forward: the 3-D tensor maps (d, rows, B) zero-fill
//    columns d..63 of a box and rows past N or S of a sample, and the TMA
//    stores clip both; a K step of 16 head columns wholly in zero fill is
//    never issued. A query past N has zero q and dO, and lse = delta = 0,
//    so its p is 1 and its ds 0 exactly: it adds nothing to dK or dV. A
//    key past S has zero k and v, and still p = exp(-lse) of a real row,
//    which overflows for a very negative lse, so the dq kernel's ragged
//    last key tile (and only it) sets ds of those columns to 0 before it
//    multiplies anything: no 0 * inf reaches dQ (dK and dV rows past S
//    are clipped by the store);
//  * each kernel's loop runs in order (products, elementwise, products);
//    the two warpgroups interleave on the tensor cores. The outputs are
//    staged in bf16 in the block's (now free) resident tiles and written
//    by TMA store.
#include "hopper.cuh"

using namespace t2v;

namespace {

constexpr int MAX_SMEM = 232448;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_SLACK = 2048;  // the barriers and the 1024-byte alignment of the tiles
constexpr int THREADS = 288;      // two consumer warpgroups and the producer warp
constexpr int DKV_BQ = 64;        // queries a streamed dkv tile
constexpr int DQ_BQ = 128;        // query rows a dq block
constexpr int DQ_BKV = 64;        // keys a streamed dq tile
constexpr float LOG2E = 1.4426950408889634f;

// The geometry of head dim D: 64-column boxes, K steps of the score
// products, and the dkv kernel's key tile and split.
template <int D>
struct BwdGeom {
  static constexpr int NB = (D + 63) / 64;
  static constexpr int KSTEPS = (D + 15) / 16;
  static constexpr bool SPLIT = NB > 1;  // dkv: warpgroup 0 owns dV, warpgroup 1 dK
  static constexpr int DKV_BKV = SPLIT ? 64 : 128;
  static constexpr int NO = NB * 32;  // f32 registers of a 64-row gradient tile a thread
};

// dynamic shared memory of a block, mirrored by
// kernels/flash_attention.py::flash_bwd_plan. dkv: K and V, then per stage
// a Q and a dO tile and 2 x 64 f32 (lse, delta)
__host__ __device__ constexpr int dkv_smem_bytes(int d, int stages) {
  return ((d + 63) / 64) * (2 * (d > 64 ? 64 : 128) + stages * 2 * DKV_BQ) * 128 +
         stages * 2 * DKV_BQ * 4 + SMEM_SLACK;
}
// dq: Q and dO, then per stage a K and a V tile
__host__ __device__ constexpr int dq_smem_bytes(int d, int stages) {
  return ((d + 63) / 64) * (2 * DQ_BQ + stages * 2 * DQ_BKV) * 128 + SMEM_SLACK;
}

// barriers, 8 bytes each from the start of shared memory: the resident
// tiles' at 0, then per stage full and empty
__device__ __forceinline__ uint32_t full_bar(uint32_t base, int s) { return base + 8 * (1 + 2 * s); }
__device__ __forceinline__ uint32_t empty_bar(uint32_t base, int s) { return base + 8 * (2 + 2 * s); }

// the first tile, 1024-byte aligned past the barriers
__device__ __forceinline__ uint32_t first_tile(uint32_t base) {
  return (base + 8 * (1 + 2 * MAX_STAGES) + 1023) & ~1023u;
}

// `full` arrivals complete a stage: the producer thread's expect_tx, and
// in dkv the 32 producer lanes' own after their lse / delta stores
__device__ __forceinline__ void init_barriers(uint32_t base, int stages, int full) {
  mbar_init(base, 1);
  for (int s = 0; s < stages; ++s) {
    mbar_init(full_bar(base, s), full);
    mbar_init(empty_bar(base, s), 8);  // one arrival per consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a 64 x 64 * NB product with A = a 64 x 16 bf16 register fragment per K
// step and B MN-major from shared memory
template <int NB>
__device__ __forceinline__ void rs_k16(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (NB == 1) wgmma_rs_n64(d, a, db);
  else if constexpr (NB == 2) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n192(d, a, db);
}

// a 64 x 64 score tile (32 f32 a thread) as the A fragments of four
// 16-deep K steps
__device__ __forceinline__ void pack_tile(const float* t, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(t[8 * kk + 0], t[8 * kk + 1]);
    a[kk][1] = pack_bf16(t[8 * kk + 2], t[8 * kk + 3]);
    a[kk][2] = pack_bf16(t[8 * kk + 4], t[8 * kk + 5]);
    a[kk][3] = pack_bf16(t[8 * kk + 6], t[8 * kk + 7]);
  }
}

// a 64 x 64 * NB f32 tile of the warpgroup, staged in bf16 as NB
// 64-column boxes of 64 rows, 128-byte swizzled (16-byte group c of row r
// at c ^ (r % 8)), `box_stride` bytes apart from `tile`
template <int NB>
__device__ __forceinline__ void stage_out(unsigned char* tile, int box_stride, const float* acc,
                                          int r0, int g, int t4) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    unsigned char* box = tile + c * box_stride;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int jn = c * 8 + jj;
      unsigned char* at = box + ((jj ^ g) * 16) + t4 * 4;
      *reinterpret_cast<uint32_t*>(at + r0 * 128) = pack_bf16(acc[jn * 4 + 0], acc[jn * 4 + 1]);
      *reinterpret_cast<uint32_t*>(at + (r0 + 8) * 128) =
          pack_bf16(acc[jn * 4 + 2], acc[jn * 4 + 3]);
    }
  }
}

enum : int { OWN_BOTH = 0, OWN_DV = 1, OWN_DK = 2 };

// One dkv consumer warpgroup: its 64 key rows against every query tile,
// then its gradients out. OWN says which of dK and dV it owns.
template <int D, int OWN>
__device__ __forceinline__ void dkv_consume(unsigned char* smem, uint32_t base, uint32_t k_s,
                                            uint32_t v_s, uint32_t ring, uint32_t rows,
                                            const CUtensorMap* dk_map, const CUtensorMap* dv_map,
                                            float scale, int n_q, int stages, int kv0, int bh,
                                            int wg, int tid) {
  using G = BwdGeom<D>;
  constexpr int BKV = G::DKV_BKV;
  constexpr int KV_BOX = BKV * 128;
  constexpr int Q_BOX = DKV_BQ * 128;
  constexpr int QT = G::NB * Q_BOX;
  constexpr int NS = DKV_BQ / 2;  // a 64 x 64 score tile over 128 threads
  constexpr bool DV = OWN != OWN_DK;
  constexpr bool DK = OWN != OWN_DV;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  // the warpgroup's 64 key rows as a byte offset inside each box of K and V
  const uint32_t kv_rows = G::SPLIT ? 0u : static_cast<uint32_t>(wg) * 64 * 128;
  const float scale_log2 = scale * LOG2E;

  float dv[DV ? G::NO : 1];
  float dk[DK ? G::NO : 1];
#pragma unroll
  for (int i = 0; i < G::NO; ++i) {
    if constexpr (DV) dv[i] = 0.0f;
    if constexpr (DK) dk[i] = 0.0f;
  }
  float st[NS];   // S^T
  float dpt[NS];  // dP^T
  uint32_t pa[DKV_BQ / 16][4];
  uint32_t da[DKV_BQ / 16][4];

  mbar_wait(base, 0);  // K and V
  for (int j = 0; j < n_q; ++j) {
    const int s = j % stages;
    const uint32_t qt = ring + s * 2 * QT;
    const uint32_t dot = qt + QT;
    const float* lse_s = reinterpret_cast<const float*>(smem + (rows - base) + s * 2 * DKV_BQ * 4);
    const float* delta_s = lse_s + DKV_BQ;
    mbar_wait(full_bar(base, s), (j / stages) & 1);

    // S^T = K Q^T and dP^T = V dO^T over the head dim's nonzero K steps
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      wgmma_ss_n64<0>(st, desc_k_major(k_s + (kk / 4) * KV_BOX + kv_rows + (kk % 4) * 32),
                      desc_k_major(qt + (kk / 4) * Q_BOX + (kk % 4) * 32), kk > 0);
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < G::KSTEPS; ++kk)
        wgmma_ss_n64<0>(dpt, desc_k_major(v_s + (kk / 4) * KV_BOX + kv_rows + (kk % 4) * 32),
                        desc_k_major(dot + (kk / 4) * Q_BOX + (kk % 4) * 32), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      fence_acc(st[i]);
      if constexpr (DK) fence_acc(dpt[i]);
    }

    // P^T and dS^T: column c is query j * 64 + c, with its lse and delta;
    // each K step's A fragments packed as soon as its 16 columns are done
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
      float p[8], ds[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nb = 2 * kk + h;
        const float2 l = *reinterpret_cast<const float2*>(lse_s + nb * 8 + 2 * t4);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + nb * 8 + 2 * t4);
        const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
        const float dd[2] = {dl.x, dl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[h * 4 + e] = exp2_ftz(fmaf(st[nb * 4 + e], scale_log2, -l2[e & 1]));
          if constexpr (DK) ds[h * 4 + e] = p[h * 4 + e] * (dpt[nb * 4 + e] - dd[e & 1]) * scale;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (DV) pa[kk][i] = pack_bf16(p[2 * i], p[2 * i + 1]);
        if constexpr (DK) da[kk][i] = pack_bf16(ds[2 * i], ds[2 * i + 1]);
      }
    }
    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
    wgmma_fence();
    if constexpr (DV) {
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        rs_k16<G::NB>(dv, pa[kk], desc_mn_major(dot + kk * 2048, Q_BOX));
    }
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        rs_k16<G::NB>(dk, da[kk], desc_mn_major(qt + kk * 2048, Q_BOX));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < G::NO; ++i) {
      if constexpr (DV) fence_acc(dv[i]);
      if constexpr (DK) fence_acc(dk[i]);
    }
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (DV) fence_reg(pa[kk][i]);
        if constexpr (DK) fence_reg(da[kk][i]);
      }
    if (lane == 0) mbar_arrive(empty_bar(base, s));
  }

  // both consumer warpgroups are past their last read of K and V (in the
  // split both read the same rows), so those tiles take the staged
  // gradients
  named_barrier(1, 256);
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the warpgroup's 64
  if constexpr (DV) stage_out<G::NB>(smem + (v_s - base) + kv_rows, KV_BOX, dv, r0, g, t4);
  if constexpr (DK) stage_out<G::NB>(smem + (k_s - base) + kv_rows, KV_BOX, dk, r0, g, t4);
  // generic-proxy writes made visible to the TMA store first
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(2 + wg, 128);
  if (tid == 0) {
    const int row = kv0 + (G::SPLIT ? 0 : wg * 64);
    for (int c = 0; c < G::NB; ++c) {
      if constexpr (DV) tma_store_3d(dv_map, v_s + c * KV_BOX + kv_rows, c * 64, row, bh);
      if constexpr (DK) tma_store_3d(dk_map, k_s + c * KV_BOX + kv_rows, c * 64, row, bh);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap dk_map, const __grid_constant__ CUtensorMap dv_map,
    const float* __restrict__ lse, const float* __restrict__ delta, int N, float scale,
    int stages) {
  using G = BwdGeom<D>;
  constexpr int BKV = G::DKV_BKV;
  constexpr int KV_BOX = BKV * 128;
  constexpr int Q_BOX = DKV_BQ * 128;
  constexpr int QT = G::NB * Q_BOX;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t k_s = first_tile(base);
  const uint32_t v_s = k_s + G::NB * KV_BOX;
  const uint32_t ring = v_s + G::NB * KV_BOX;  // stage s: Q at + 2 s QT, dO at + QT
  const uint32_t rows = ring + stages * 2 * QT;  // stage s: lse at + 512 s, delta at + 256
  const int kv0 = blockIdx.x * BKV;
  const int bh = blockIdx.y;
  const int n_q = (N + DKV_BQ - 1) / DKV_BQ;
  // the warp index, broadcast from lane 0 so that the role branch is
  // warp-uniform to the compiler
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (threadIdx.x == 0) init_barriers(base, stages, 33);
  __syncthreads();

  if (warp == 8) {
    // the producer warp: lane 0 issues every TMA load, all 32 lanes bring
    // each stage's lse and delta
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(base, 2 * G::NB * KV_BOX);
      for (int c = 0; c < G::NB; ++c) {
        tma_load_3d(k_s + c * KV_BOX, &k_map, base, c * 64, kv0, bh);
        tma_load_3d(v_s + c * KV_BOX, &v_map, base, c * 64, kv0, bh);
      }
    }
    for (int j = 0; j < n_q; ++j) {
      const int s = j % stages;
      const uint32_t qt = ring + s * 2 * QT;
      mbar_wait(empty_bar(base, s), ((j / stages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full_bar(base, s), 2 * QT);
        for (int c = 0; c < G::NB; ++c) {
          tma_load_3d(qt + c * Q_BOX, &q_map, full_bar(base, s), c * 64, j * DKV_BQ, bh);
          tma_load_3d(qt + QT + c * Q_BOX, &do_map, full_bar(base, s), c * 64, j * DKV_BQ, bh);
        }
      }
      float* rs = reinterpret_cast<float*>(smem + (rows - base) + s * 2 * DKV_BQ * 4);
      for (int i = lane; i < DKV_BQ; i += 32) {
        const int r = j * DKV_BQ + i;
        const bool in = r < N;
        rs[i] = in ? lse[(size_t)bh * N + r] : 0.0f;
        rs[DKV_BQ + i] = in ? delta[(size_t)bh * N + r] : 0.0f;
      }
      mbar_arrive(full_bar(base, s));  // releases this lane's stores to the consumers
    }
  } else {
    const int wg = warp / 4;
    const int tid = threadIdx.x % 128;
    if constexpr (G::SPLIT) {
      if (wg == 0)
        dkv_consume<D, OWN_DV>(smem, base, k_s, v_s, ring, rows, &dk_map, &dv_map, scale, n_q,
                               stages, kv0, bh, wg, tid);
      else
        dkv_consume<D, OWN_DK>(smem, base, k_s, v_s, ring, rows, &dk_map, &dv_map, scale, n_q,
                               stages, kv0, bh, wg, tid);
    } else {
      dkv_consume<D, OWN_BOTH>(smem, base, k_s, v_s, ring, rows, &dk_map, &dv_map, scale, n_q,
                               stages, kv0, bh, wg, tid);
    }
  }
}

// One dq consumer warpgroup: its 64 query rows against every key tile,
// then dQ out.
template <int D>
__device__ __forceinline__ void dq_consume(unsigned char* smem, uint32_t base, uint32_t q_s,
                                           uint32_t do_s, uint32_t ring, const CUtensorMap* dq_map,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, int N, int S,
                                           float scale, int stages, int q0, int bh, int wg,
                                           int tid) {
  using G = BwdGeom<D>;
  constexpr int KV_BOX = DQ_BKV * 128;
  constexpr int Q_BOX = DQ_BQ * 128;
  constexpr int TILE = G::NB * KV_BOX;
  constexpr int NS = DQ_BKV / 2;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const uint32_t q_rows = static_cast<uint32_t>(wg) * 64 * 128;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the warpgroup's 64
  const float scale_log2 = scale * LOG2E;
  const int n_kv = (S + DQ_BKV - 1) / DQ_BKV;

  // the rows' lse (log2 domain) and delta; a row past N has zero q and dO,
  // so 0 and 0 give it p = 1 and ds = 0
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + wg * 64 + r0 + 8 * i;
    const bool in = r < N;
    l2[i] = in ? lse[(size_t)bh * N + r] * LOG2E : 0.0f;
    dl[i] = in ? delta[(size_t)bh * N + r] : 0.0f;
  }

  float dq[G::NO];
#pragma unroll
  for (int i = 0; i < G::NO; ++i) dq[i] = 0.0f;
  float sc[NS];
  float dp[NS];
  uint32_t da[DQ_BKV / 16][4];

  mbar_wait(base, 0);  // Q and dO
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % stages;
    const uint32_t kt = ring + s * 2 * TILE;
    const uint32_t vt = kt + TILE;
    mbar_wait(full_bar(base, s), (j / stages) & 1);

    // S = Q K^T and dP = dO V^T over the head dim's nonzero K steps
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      wgmma_ss_n64<0>(sc, desc_k_major(q_s + (kk / 4) * Q_BOX + q_rows + (kk % 4) * 32),
                      desc_k_major(kt + (kk / 4) * KV_BOX + (kk % 4) * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk)
      wgmma_ss_n64<0>(dp, desc_k_major(do_s + (kk / 4) * Q_BOX + q_rows + (kk % 4) * 32),
                      desc_k_major(vt + (kk / 4) * KV_BOX + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      fence_acc(sc[i]);
      fence_acc(dp[i]);
    }

    // dS = P (dP - delta) scale; keys past S exist only in the last tile
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p = exp2_ftz(fmaf(sc[i], scale_log2, -l2[(i / 2) & 1]));
      dp[i] = p * (dp[i] - dl[(i / 2) & 1]) * scale;
    }
    const int lim = S - j * DQ_BKV;
    if (lim < DQ_BKV) {
#pragma unroll
      for (int nb = 0; nb < DQ_BKV / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nb * 8 + 2 * t4 + (e & 1) >= lim) dp[nb * 4 + e] = 0.0f;
    }
    pack_tile(dp, da);

    // dQ += dS K, K read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BKV / 16; ++kk)
      rs_k16<G::NB>(dq, da[kk], desc_mn_major(kt + kk * 2048, KV_BOX));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < G::NO; ++i) fence_acc(dq[i]);
#pragma unroll
    for (int kk = 0; kk < DQ_BKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(da[kk][i]);
    if (lane == 0) mbar_arrive(empty_bar(base, s));
  }

  // the warpgroup alone reads its 64 rows of Q, which take the staged dQ
  stage_out<G::NB>(smem + (q_s - base) + q_rows, Q_BOX, dq, r0, g, t4);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_barrier(2 + wg, 128);
  if (tid == 0) {
    for (int c = 0; c < G::NB; ++c)
      tma_store_3d(dq_map, q_s + c * Q_BOX + q_rows, c * 64, q0 + wg * 64, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap dq_map, const float* __restrict__ lse,
    const float* __restrict__ delta, int N, int S, float scale, int stages) {
  using G = BwdGeom<D>;
  constexpr int KV_BOX = DQ_BKV * 128;
  constexpr int Q_BOX = DQ_BQ * 128;
  constexpr int TILE = G::NB * KV_BOX;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t q_s = first_tile(base);
  const uint32_t do_s = q_s + G::NB * Q_BOX;
  const uint32_t ring = do_s + G::NB * Q_BOX;  // stage s: K at + 2 s TILE, V at + TILE
  const int q0 = blockIdx.x * DQ_BQ;
  const int bh = blockIdx.y;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (threadIdx.x == 0) init_barriers(base, stages, 1);
  __syncthreads();

  if (warp == 8) {
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(base, 2 * G::NB * Q_BOX);
      for (int c = 0; c < G::NB; ++c) {
        tma_load_3d(q_s + c * Q_BOX, &q_map, base, c * 64, q0, bh);
        tma_load_3d(do_s + c * Q_BOX, &do_map, base, c * 64, q0, bh);
      }
      const int n_kv = (S + DQ_BKV - 1) / DQ_BKV;
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % stages;
        const uint32_t kt = ring + s * 2 * TILE;
        mbar_wait(empty_bar(base, s), ((j / stages) & 1) ^ 1);
        mbar_expect_tx(full_bar(base, s), 2 * TILE);
        for (int c = 0; c < G::NB; ++c) {
          tma_load_3d(kt + c * KV_BOX, &k_map, full_bar(base, s), c * 64, j * DQ_BKV, bh);
          tma_load_3d(kt + TILE + c * KV_BOX, &v_map, full_bar(base, s), c * 64, j * DQ_BKV,
                      bh);
        }
      }
    }
  } else {
    dq_consume<D>(smem, base, q_s, do_s, ring, &dq_map, lse, delta, N, S, scale, stages, q0, bh,
                  warp / 4, threadIdx.x % 128);
  }
}

// the shared-memory attribute, once per kernel instantiation
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  done = err == cudaSuccess;
  return err;
}

// a (B, rows, D) bf16 tensor as a 3-D (D, rows, B) map with boxes of 64
// columns and `box_rows` rows
template <int D>
bool map_rows(CUtensorMap* map, const void* ptr, int B, int rows, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return make_map(map, ptr, 3, dims, strides, box);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int N, int S, float scale, int bkv,
               int bq, int stages, cudaStream_t stream) {
  using G = BwdGeom<D>;
  const int smem = dkv_smem_bytes(D, stages);
  if (bkv != G::DKV_BKV || bq != DKV_BQ || stages < 1 || stages > MAX_STAGES || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;
  const cudaError_t err = opt_in(flash_bwd_dkv_kernel<D>, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap q_map, do_map, k_map, v_map, dk_map, dv_map;
  if (!map_rows<D>(&q_map, q, B, N, DKV_BQ) || !map_rows<D>(&do_map, dout, B, N, DKV_BQ) ||
      !map_rows<D>(&k_map, k, B, S, G::DKV_BKV) || !map_rows<D>(&v_map, v, B, S, G::DKV_BKV) ||
      !map_rows<D>(&dk_map, dk, B, S, 64) || !map_rows<D>(&dv_map, dv, B, S, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + G::DKV_BKV - 1) / G::DKV_BKV, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      q_map, do_map, k_map, v_map, dk_map, dv_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), N, scale, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int N, int S, float scale, int bq, int bkv,
              int stages, cudaStream_t stream) {
  const int smem = dq_smem_bytes(D, stages);
  if (bq != DQ_BQ || bkv != DQ_BKV || stages < 1 || stages > MAX_STAGES || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;
  const cudaError_t err = opt_in(flash_bwd_dq_kernel<D>, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap q_map, do_map, k_map, v_map, dq_map;
  if (!map_rows<D>(&q_map, q, B, N, DQ_BQ) || !map_rows<D>(&do_map, dout, B, N, DQ_BQ) ||
      !map_rows<D>(&k_map, k, B, S, DQ_BKV) || !map_rows<D>(&v_map, v, B, S, DQ_BKV) ||
      !map_rows<D>(&dq_map, dq, B, N, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + DQ_BQ - 1) / DQ_BQ, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      q_map, do_map, k_map, v_map, dq_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), N, S, scale, stages);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int N, int S) { return B >= 1 && N >= 1 && S >= 1 && B <= 65535; }

}  // namespace

// Both return a CUDA error code; 1 (cudaErrorInvalidValue) for a head dim
// outside {40, 64, 80, 160} or a plan the kernel does not take. ``lse``
// and ``delta`` are (B, N) f32. The tiles and ``stages``
// come from kernels/flash_attention.py::flash_bwd_plan.
extern "C" int t2v_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int B, int N,
                                           int S, int D, float scale, int bkv, int bq,
                                           int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, N, S)) return static_cast<int>(cudaErrorInvalidValue);
#define T2V_DKV(D_) \
  if (D == D_)      \
    return launch_dkv<D_>(q, k, v, dout, lse, delta, dk, dv, B, N, S, scale, bkv, bq, stages, st);
  T2V_DKV(40)
  T2V_DKV(64)
  T2V_DKV(80)
  T2V_DKV(160)
#undef T2V_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int t2v_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int B, int N, int S, int D, float scale,
                                          int bq, int bkv, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, N, S)) return static_cast<int>(cudaErrorInvalidValue);
#define T2V_DQ(D_) \
  if (D == D_)     \
    return launch_dq<D_>(q, k, v, dout, lse, delta, dq, B, N, S, scale, bq, bkv, stages, st);
  T2V_DQ(40)
  T2V_DQ(64)
  T2V_DQ(80)
  T2V_DQ(160)
#undef T2V_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}
