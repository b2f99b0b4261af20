// Staged GQA decode attention, one query token per slot, for sm_90a: over a
// contiguous per-slot cache (kernel #1) and over a shared page pool through a
// block table (kernel #5). Both share one kernel body; only the addressing
// of cache rows differs.
//
// Replaces the JAX package's Pallas kernels `_kernel` in
// pipelinerl_tpu/ops/decode_attention.py (reached through
// `decode_attention_staged_ragged`) and `_build_paged_call` in
// pipelinerl_tpu/ops/paged_attention.py (reached through
// `paged_decode_attention`, which reuses `_kernel` with another index map).
// Contract: for slot s and query head h, softmax attention over
// [cache rows < len | band rows < step | self], with the query pre-scaled
// and rounded to bf16, bf16 operands, fp32 scores, running max/sum and
// accumulators, and an fp32 output [S, H, Dh]. Slab: len = lens[s], row t at
// cache[s, t]. Paged: len = min(lens[s], MAXB * BT), row t in page
// clip(table[s, t / BT], 0, NB - 1) at offset t % BT.
//
// What bounds it on an H100: bytes. Each slot's K and V rows are read once
// (2 * len * K * Dh * 2 bytes per slot per layer; paged adds one int32 table
// entry per page) and every score costs Dh multiply-adds, about 1.75 flop
// per byte read at G = 7, far below the ~295 flop/byte at which the tensor
// cores would become the limit.
//
// Design:
// - one block per (slot, kv head): the G query heads that share a kv head
//   share every K/V tile loaded into shared memory, so K/V leave device
//   memory once per kv head and not once per query head;
// - the loop runs over 64-row cache tiles up to the slot's own length only.
//   This ragged bound is what the TPU kernels' clamped index maps emulated:
//   a short slot reads only its own rows, whatever the capacity;
// - the row addressing is a template parameter (SlabRows, PagedRows). The
//   paged form looks the page up per row, not per tile, since a 64-row tile
//   spans several pages when BT < 64; its length cap keeps a stale length
//   (an inactive slot whose released table row is all -1, or a table sliced
//   to the active working set) from reading table[s, MAXB] or page -1;
// - tiles load as 16-byte vectors into rows padded by 8 bf16 values, so a
//   warp reading one row per lane hits 32 distinct banks;
// - rows past the valid length are zero-filled, so V rows past `len` can
//   never bring NaN or Inf into the accumulator (p = 0 times garbage);
// - the band rows < step and the self row form one last tile;
// - it reads the engine's per-layer cache or pool slice and band
//   [W, S, K, Dh] in place through the strides it is given.
// A first, simple version: no cp.async or TMA pipelining yet, and one block
// per (slot, kv head) leaves the card part-empty when S * K is small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGPerWarp = 4;  // G <= kWarps * kMaxGPerWarp = 16
constexpr float kNegInf = -1e30f;

template <int DH>
struct Smem {
  __nv_bfloat16 k[kTile][DH + 8];
  __nv_bfloat16 v[kTile][DH + 8];
  float q[kWarps * kMaxGPerWarp][DH];
  float p[kWarps][kTile];
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Cache row t of a slot: the element offset of its (kv head 0) row, and the
// number of rows the slot holds.
struct SlabRows {
  int64_t c_slot, c_t;  // cache strides, in elements
  __device__ __forceinline__ int length(int slot, int len) const { return len; }
  __device__ __forceinline__ int64_t offset(int slot, int t) const {
    return slot * c_slot + t * c_t;
  }
};

struct PagedRows {
  const int* table;     // [S, maxb] physical page ids, -1 where unused
  int nb, bt, maxb;
  int64_t p_page, p_t;  // pool strides, in elements
  __device__ __forceinline__ int length(int slot, int len) const { return min(len, maxb * bt); }
  __device__ __forceinline__ int64_t offset(int slot, int t) const {
    const int page = min(max(table[(int64_t)slot * maxb + t / bt], 0), nb - 1);
    return page * p_page + (t % bt) * p_t;
  }
};

// Fill the K/V tile rows [0, kTile) from `row_k(r)` / `row_v(r)` for r < n,
// zeros for r >= n.
template <int DH, typename RowK, typename RowV>
__device__ __forceinline__ void load_tile(Smem<DH>& sm, int n, RowK row_k, RowV row_v) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < n) {
      kk = *reinterpret_cast<const uint4*>(row_k(r) + col);
      vv = *reinterpret_cast<const uint4*>(row_v(r) + col);
    }
    *reinterpret_cast<uint4*>(&sm.k[r][col]) = kk;
    *reinterpret_cast<uint4*>(&sm.v[r][col]) = vv;
  }
}

template <int DH>
struct State {
  float m[kMaxGPerWarp];
  float l[kMaxGPerWarp];
  float acc[kMaxGPerWarp][DH / 32];
};

// Online-softmax update of this warp's query rows with the n valid rows of
// the tile in shared memory.
template <int DH>
__device__ __forceinline__ void update(Smem<DH>& sm, State<DH>& st, int n, int G) {
  constexpr int E = DH / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kMaxGPerWarp; ++j) {
    const int g = warp + j * kWarps;
    if (g >= G) break;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(&sm.q[g][c * 8]);
      const float4 qb = *reinterpret_cast<const float4*>(&sm.q[g][c * 8 + 4]);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const uint4 k0 = *reinterpret_cast<const uint4*>(&sm.k[lane][c * 8]);
      const uint4 k1 = *reinterpret_cast<const uint4*>(&sm.k[lane + 32][c * 8]);
      const __nv_bfloat162* k0h = reinterpret_cast<const __nv_bfloat162*>(&k0);
      const __nv_bfloat162* k1h = reinterpret_cast<const __nv_bfloat162*>(&k1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(k0h[e]);
        const float2 b = __bfloat1622float2(k1h[e]);
        s0 = fmaf(qv[2 * e], a.x, fmaf(qv[2 * e + 1], a.y, s0));
        s1 = fmaf(qv[2 * e], b.x, fmaf(qv[2 * e + 1], b.y, s1));
      }
    }
    const bool v0 = lane < n, v1 = lane + 32 < n;
    s0 = v0 ? s0 : kNegInf;
    s1 = v1 ? s1 : kNegInf;
    const float m_new = fmaxf(st.m[j], warp_max(fmaxf(s0, s1)));
    const float alpha = expf(st.m[j] - m_new);
    const float p0 = v0 ? expf(s0 - m_new) : 0.f;
    const float p1 = v1 ? expf(s1 - m_new) : 0.f;
    st.l[j] = st.l[j] * alpha + warp_sum(p0 + p1);
    st.m[j] = m_new;
    // P·V takes bf16 probabilities with fp32 accumulation, as on the TPU
    sm.p[warp][lane] = __bfloat162float(__float2bfloat16_rn(p0));
    sm.p[warp][lane + 32] = __bfloat162float(__float2bfloat16_rn(p1));
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) st.acc[j][e] *= alpha;
    for (int t = 0; t < n; ++t) {
      const float pt = sm.p[warp][t];
      if constexpr (E == 1) {  // Dh 32: one value per lane
        st.acc[j][0] = fmaf(pt, __bfloat162float(sm.v[t][lane]), st.acc[j][0]);
      } else {
#pragma unroll
        for (int e = 0; e < E; e += 2) {
          const float2 vv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&sm.v[t][lane * E + e]));
          st.acc[j][e] = fmaf(pt, vv.x, st.acc[j][e]);
          st.acc[j][e + 1] = fmaf(pt, vv.y, st.acc[j][e + 1]);
        }
      }
    }
    __syncwarp();
  }
}

template <int DH, typename Rows>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q,      // [S, H, DH]
    const __nv_bfloat16* __restrict__ k_new,  // [S, K, DH]
    const __nv_bfloat16* __restrict__ v_new,
    const __nv_bfloat16* __restrict__ k_cache,  // rows addressed by `rows`
    const __nv_bfloat16* __restrict__ v_cache,
    Rows rows,
    const int* __restrict__ lens,               // [S]
    const __nv_bfloat16* __restrict__ k_band,   // w, slot strides given
    const __nv_bfloat16* __restrict__ v_band,
    float* __restrict__ out,                    // [S, H, DH]
    int H, int K, int step, int64_t b_w, int64_t b_slot, float scale) {
  __shared__ __align__(16) Smem<DH> sm;
  const int slot = blockIdx.x, kh = blockIdx.y;
  const int G = H / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int E = DH / 32;

  // query rows of this kv head, pre-scaled and rounded to bf16
  for (int i = threadIdx.x; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    const float x = __bfloat162float(q[((int64_t)slot * H + kh * G + g) * DH + d]) * scale;
    sm.q[g][d] = __bfloat162float(__float2bfloat16_rn(x));
  }
  State<DH> st;
#pragma unroll
  for (int j = 0; j < kMaxGPerWarp; ++j) {
    st.m[j] = kNegInf;
    st.l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) st.acc[j][e] = 0.f;
  }

  const int len = rows.length(slot, lens[slot]);
  const __nv_bfloat16* kc = k_cache + kh * DH;
  const __nv_bfloat16* vc = v_cache + kh * DH;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and q written)
    load_tile<DH>(sm, min(kTile, len - t0),
                  [&](int r) { return kc + rows.offset(slot, t0 + r); },
                  [&](int r) { return vc + rows.offset(slot, t0 + r); });
    __syncthreads();
    update<DH>(sm, st, min(kTile, len - t0), G);
  }

  // band rows < step, then the slot's own K/V at row `step`
  const __nv_bfloat16* kb = k_band + slot * b_slot + kh * DH;
  const __nv_bfloat16* vb = v_band + slot * b_slot + kh * DH;
  const __nv_bfloat16* kn = k_new + ((int64_t)slot * K + kh) * DH;
  const __nv_bfloat16* vn = v_new + ((int64_t)slot * K + kh) * DH;
  __syncthreads();
  load_tile<DH>(sm, step + 1,
                [&](int r) { return r < step ? kb + r * b_w : kn; },
                [&](int r) { return r < step ? vb + r * b_w : vn; });
  __syncthreads();
  update<DH>(sm, st, step + 1, G);

#pragma unroll
  for (int j = 0; j < kMaxGPerWarp; ++j) {
    const int g = warp + j * kWarps;
    if (g >= G) break;
    float* o = out + ((int64_t)slot * H + kh * G + g) * DH + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = st.acc[j][e] / st.l[j];
  }
}

template <typename Rows>
int launch(const void* q, const void* k_new, const void* v_new, const void* k_cache,
           const void* v_cache, Rows rows, const void* lens, const void* k_band,
           const void* v_band, void* out, int S, int H, int K, int Dh, int step,
           long long b_w, long long b_slot, float scale, void* stream) {
  if (S <= 0 || K <= 0 || H % K != 0 || H / K > kWarps * kMaxGPerWarp || step < 0 ||
      step >= kTile)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(S, K);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DH)                                                                      \
  decode_attention_kernel<DH, Rows><<<grid, kThreads, 0, st>>>(                        \
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, \
      (const __nv_bfloat16*)k_cache, (const __nv_bfloat16*)v_cache, rows,                \
      (const int*)lens, (const __nv_bfloat16*)k_band, (const __nv_bfloat16*)v_band,      \
      (float*)out, H, K, step, b_w, b_slot, scale)
  if (Dh == 32)
    LAUNCH(32);
  else if (Dh == 64)
    LAUNCH(64);
  else if (Dh == 128)
    LAUNCH(128);
  else
    return (int)cudaErrorInvalidValue;
#undef LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_staged_bf16(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* lens, const void* k_band, const void* v_band,
    void* out, int S, int H, int K, int Dh, int step, long long c_slot, long long c_t,
    long long b_w, long long b_slot, float scale, void* stream) {
  return launch(q, k_new, v_new, k_cache, v_cache, SlabRows{(int64_t)c_slot, (int64_t)c_t}, lens, k_band,
                v_band, out, S, H, K, Dh, step, b_w, b_slot, scale, stream);
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* table, const void* lens, const void* k_band,
    const void* v_band, void* out, int S, int H, int K, int Dh, int step, int NB, int BT,
    int MAXB, long long p_page, long long p_t, long long b_w, long long b_slot, float scale,
    void* stream) {
  if (NB <= 0 || BT <= 0 || MAXB <= 0) return (int)cudaErrorInvalidValue;
  return launch(q, k_new, v_new, k_pool, v_pool,
                PagedRows{(const int*)table, NB, BT, MAXB, (int64_t)p_page, (int64_t)p_t}, lens, k_band,
                v_band, out, S, H, K, Dh, step, b_w, b_slot, scale, stream);
}
