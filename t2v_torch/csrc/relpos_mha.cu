// Temporal self-attention with learned relative-position score and value
// biases, in the resident layout:
//   sim[tq, tk] = (q[tq] . k[tk] + q[tq] . K2[tq, tk]) * scale
//   out[tq]     = sum_tk softmax(sim)[tq, tk] * (v[tk] + V2[tq, tk])
// for every (sample, spatial token, head). q/k/v/out are (B*T, N, H*D):
// sample-major frames, then spatial tokens, heads packed in the last axis,
// exactly as the per-token projections emit them; K2/V2 are (T, T, D).
//
// Replaces: t2v/kernels/relpos_mha.py::_kernel (driven by
// fused_relpos_temporal_mha; reached from t2v/models/videocrafter_unet.py::
// TemporalCrossAttention with frame_split). As there, the frame <-> token
// fold happens in index arithmetic and never in device memory: the T rows
// of one (token, head) are gathered with stride N*H*D and the output is
// scattered back the same way.
//
// What bounds it on the H100: per (token, head) the work is 8*T*T*D flops
// on 4*T*D*2 bytes, i.e. 2*T = 32 flops per byte at T = 16, far below the
// card's ~295 flop/byte ridge: device memory bounds it, and the per-(tq, tk)
// bias product is a batch of T-row matrix-vector products that no 16x16
// tensor-core tile fits without a relayout. So the kernel runs on the CUDA
// cores in f32 and spends its design on memory traffic:
//  * one warp owns one (sample, token, head) item at a time and walks a
//    grid-strided list of items, heads fastest, so the warps of a block
//    read neighbouring D-wide slices of the same H*D-wide rows;
//  * q, k, v of the item (T x D each) are fetched with 16-byte loads into
//    the warp's shared-memory slice; rows are padded to D + 2 so that the
//    32-bit column reads of the score and output loops hit distinct banks;
//  * K2 and V2 are copied to shared memory once per block (83 KB each at
//    T = 16, D = 160) and shared by its warps; where they do not fit beside
//    the warps' slices the kernel reads them through L2 instead;
//  * scores, softmax and both products in f32; the normalised
//    probabilities are rounded to bf16 before the output products, as the
//    TPU kernel feeds p.astype(v.dtype).
#include "common.cuh"

using namespace t2v;

namespace {

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// bytes of one (T, T, D) bias table and of one warp's slice in shared memory
__host__ __device__ inline int table_bytes(int T, int D) { return align16(T * T * (D + 2) * 2); }
__host__ __device__ inline int tile_bytes(int T, int D) { return align16(T * (D + 2) * 2); }
__host__ __device__ inline int warp_bytes(int T, int D) {
  return 3 * tile_bytes(T, D) + align16(T * (T + 1) * 4);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__global__ void __launch_bounds__(256) relpos_mha_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ k2, const bf16* __restrict__ v2, bf16* __restrict__ o, int B,
    int T, int N, int H, int D, int tables_in_smem, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int DW = D / 2;      // 32-bit words per global row
  const int DWP = DW + 1;    // ... per padded shared-memory row
  const int LDS = T + 1;
  const int hd = H * D;

  // the bias tables: shared-memory copies with padded rows, or global
  const uint32_t* K2 = reinterpret_cast<const uint32_t*>(k2);
  const uint32_t* V2 = reinterpret_cast<const uint32_t*>(v2);
  int table_ld = DW;
  unsigned char* ws = smem;
  if (tables_in_smem) {
    uint32_t* k2s = reinterpret_cast<uint32_t*>(smem);
    uint32_t* v2s = reinterpret_cast<uint32_t*>(smem + table_bytes(T, D));
    // 16-byte global loads (D is a multiple of 8), 32-bit shared stores:
    // the padded rows are only 4-byte aligned
    const uint4* k2g = reinterpret_cast<const uint4*>(k2);
    const uint4* v2g = reinterpret_cast<const uint4*>(v2);
    const int DQ = D / 8;
    for (int e = threadIdx.x; e < T * T * DQ; e += blockDim.x) {
      const int r = e / DQ;
      const int dst = r * DWP + (e - r * DQ) * 4;
      const uint4 a = k2g[e];
      const uint4 c = v2g[e];
      k2s[dst] = a.x; k2s[dst + 1] = a.y; k2s[dst + 2] = a.z; k2s[dst + 3] = a.w;
      v2s[dst] = c.x; v2s[dst + 1] = c.y; v2s[dst + 2] = c.z; v2s[dst + 3] = c.w;
    }
    K2 = k2s;
    V2 = v2s;
    table_ld = DWP;
    ws += 2 * table_bytes(T, D);
    __syncthreads();  // the only block barrier: warps run on their own below
  }
  ws += warp * warp_bytes(T, D);
  uint32_t* qs = reinterpret_cast<uint32_t*>(ws);
  uint32_t* ks = reinterpret_cast<uint32_t*>(ws + tile_bytes(T, D));
  uint32_t* vs = reinterpret_cast<uint32_t*>(ws + 2 * tile_bytes(T, D));
  float* Ss = reinterpret_cast<float*>(ws + 3 * tile_bytes(T, D));

  const long items = (long)B * N * H;
  for (long item = (long)blockIdx.x * warps + warp; item < items;
       item += (long)gridDim.x * warps) {
    const int h = item % H;
    const long bn = item / H;
    const int n = bn % N;
    const int b = bn / N;
    // element offset of frame 0's row; frame t is t * N * hd further on
    const size_t base = ((size_t)b * T * N + n) * hd + (size_t)h * D;
    const size_t frame = (size_t)N * hd;

    for (int e = lane; e < T * (D / 8); e += 32) {
      const int t = e / (D / 8);
      const int c = (e - t * (D / 8)) * 8;
      const size_t src = base + t * frame + c;
      const uint4 qv = *reinterpret_cast<const uint4*>(q + src);
      const uint4 kv = *reinterpret_cast<const uint4*>(k + src);
      const uint4 vv = *reinterpret_cast<const uint4*>(v + src);
      const int dst = t * DWP + c / 2;
      qs[dst] = qv.x; qs[dst + 1] = qv.y; qs[dst + 2] = qv.z; qs[dst + 3] = qv.w;
      ks[dst] = kv.x; ks[dst + 1] = kv.y; ks[dst + 2] = kv.z; ks[dst + 3] = kv.w;
      vs[dst] = vv.x; vs[dst + 1] = vv.y; vs[dst + 2] = vv.z; vs[dst + 3] = vv.w;
    }
    __syncwarp();

    // scores: one (tq, tk) pair per lane and pass
    for (int idx = lane; idx < T * T; idx += 32) {
      const int tq = idx / T;
      const int tk = idx - tq * T;
      const uint32_t* qw = qs + tq * DWP;
      const uint32_t* kw = ks + tk * DWP;
      const uint32_t* bw = K2 + (size_t)idx * table_ld;
      float acc = 0.0f;
      for (int w = 0; w < DW; ++w) {
        const float2 qf = unpack2(qw[w]);
        const float2 kf = unpack2(kw[w]);
        const float2 bf = unpack2(bw[w]);
        acc = fmaf(qf.x, kf.x + bf.x, acc);
        acc = fmaf(qf.y, kf.y + bf.y, acc);
      }
      Ss[tq * LDS + tk] = acc * scale;
    }
    __syncwarp();

    // softmax over tk, one row per lane; probabilities rounded to bf16
    for (int tq = lane; tq < T; tq += 32) {
      float* srow = Ss + tq * LDS;
      float m = -CUDART_INF_F;
      for (int tk = 0; tk < T; ++tk) m = fmaxf(m, srow[tk]);
      float sum = 0.0f;
      for (int tk = 0; tk < T; ++tk) {
        const float p = expf(srow[tk] - m);
        srow[tk] = p;
        sum += p;
      }
      const float inv = 1.0f / sum;
      for (int tk = 0; tk < T; ++tk) srow[tk] = round_bf16(srow[tk] * inv);
    }
    __syncwarp();

    // out[tq, 2w .. 2w + 1], one 32-bit word per lane and pass
    for (int idx = lane; idx < T * DW; idx += 32) {
      const int tq = idx / DW;
      const int w = idx - tq * DW;
      const float* prow = Ss + tq * LDS;
      const uint32_t* bw = V2 + (size_t)tq * T * table_ld + w;
      float2 acc = make_float2(0.0f, 0.0f);
      for (int tk = 0; tk < T; ++tk) {
        const float p = prow[tk];
        const float2 vf = unpack2(vs[tk * DWP + w]);
        const float2 bf = unpack2(bw[(size_t)tk * table_ld]);
        acc.x = fmaf(p, vf.x + bf.x, acc.x);
        acc.y = fmaf(p, vf.y + bf.y, acc.y);
      }
      const __nv_bfloat162 out = __floats2bfloat162_rn(acc.x, acc.y);
      *reinterpret_cast<__nv_bfloat162*>(o + base + tq * frame + 2 * w) = out;
    }
    __syncwarp();  // the warp's slice is reused by its next item
  }
}

}  // namespace

// q/k/v/o (B*T, N, H*D) bf16, k2/v2 (T, T, D) bf16. Returns a CUDA error
// code; 1 (cudaErrorInvalidValue) when D is not a multiple of 8 or one
// warp's slice does not fit shared memory.
extern "C" int t2v_relpos_mha(const void* q, const void* k, const void* v, const void* k2,
                              const void* v2, void* o, int B, int T, int N, int H, int D,
                              float scale, void* stream) {
  if (D % 8 != 0 || T < 1) return 1;
  int dev = 0, sms = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int per_warp = warp_bytes(T, D);
  const int tables = 2 * table_bytes(T, D);
  int in_smem = tables + 4 * per_warp <= limit;
  const int room = limit - (in_smem ? tables : 0);
  int warps = room / per_warp;
  if (warps < 1) return 1;
  if (warps > 8) warps = 8;
  const int bytes = (in_smem ? tables : 0) + warps * per_warp;

  err = cudaFuncSetAttribute(relpos_mha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long items = (long)B * N * H;
  long blocks = (items + warps - 1) / warps;
  // resident blocks only: each walks its share of the items, so the bias
  // tables are copied once per resident block and not once per item
  int per_sm = limit / bytes;
  if (per_sm > 4) per_sm = 4;
  if (per_sm < 1) per_sm = 1;
  if (blocks > (long)sms * per_sm) blocks = (long)sms * per_sm;
  relpos_mha_kernel<<<static_cast<unsigned>(blocks), warps * 32, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(k2), static_cast<const bf16*>(v2), static_cast<bf16*>(o), B, T, N,
      H, D, in_smem, scale);
  return static_cast<int>(cudaGetLastError());
}
