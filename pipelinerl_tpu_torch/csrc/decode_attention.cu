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
// accumulators, P rounded to bf16 before P·V, and an fp32 output
// [S, H, Dh]. Slab: len = min(lens[s], T), row t at cache[s, t]. Paged:
// len = min(lens[s], MAXB * BT), row t in page clip(table[s, t / BT], 0,
// NB - 1) at offset t % BT.
//
// What bounds it on an H100: bytes. Each slot's K and V rows are read once
// (2 * len * K * Dh * 2 bytes per slot per layer; paged adds one int32 table
// entry per page) and every score costs Dh multiply-adds, about 1.75 flop
// per byte read at G = 7, far below the ~295 flop/byte at which the tensor
// cores would become the limit. What cost time in the first version was
// latency: one block per (slot, kv head) walked a slot's tiles in series,
// with synchronous loads and serial CUDA-core loops, so the longest slot set
// the time at a few GB/s per block.
//
// Design:
// - split a slot's rows over blocks (flash-decoding): the grid is
//   (S, K, splits), split j owning cache rows [j * C, (j + 1) * C) with
//   C = kSplitRows. `splits` = ceil(T / C) (slab) or ceil(MAXB * BT / C)
//   (paged) comes from the static shape, never from `lens`, so nothing is
//   read back to the host. The band-plus-self tile belongs to split
//   min(len / C, splits - 1); a split past it holds no row of the slot and
//   exits at once. The partition depends only on row indices and the cap,
//   so #1 over gathered pages and #5 through the table compute the same
//   sums in the same order and agree bit for bit;
// - merge: a slot whose rows all fall in split 0 writes its output from
//   that block. Otherwise each live split writes its partial (m, l and the
//   unnormalised acc [G, Dh], fp32) to scratch the wrapper allocates, and a
//   second small kernel, one block per (slot, kv head), merges them in split
//   order. A second kernel and not a last-block counter: the scratch needs
//   no zeroed state carried between calls (torch.empty suffices, also under
//   CUDA-graph capture), and the order of the sums is fixed, with no atomics.
//   It costs one more launch, none when a shape has one split, and it is
//   launched as a programmatic dependent (PDL), so its launch overlaps the
//   main grid's tail;
// - the G <= 16 query heads of one kv head are the 16 rows of the A operand
//   of bf16 mma.sync m16n8k16 with fp32 accumulation: S = Q K^T with K
//   fragments from ldmatrix, then P V with the S accumulator rounded to
//   bf16 and reused as P's A fragment (as in FlashAttention-2), V fragments
//   from ldmatrix.trans. Each of the 4 warps owns 16 rows of every 64-row
//   tile with its own running max, sum and acc, merged in shared memory
//   once at the end, so no tile needs a reduction across warps. Not wgmma:
//   its 64-row M would use 7 of 64 rows at G = 7, and the kernel is bound
//   by bytes and latency, not by the tensor cores; mma.sync at 16 rows
//   takes the first version's serial CUDA-core loops off every tile;
// - a cp.async ring of kStages = 2 tiles (cp.async.cg, 16 bytes per copy,
//   commit_group / wait_group): the next tile loads while this one
//   computes. Two stages keep a block at 38 KB of shared memory, so 5 of
//   them share an SM; the time is set more by how many blocks' latency
//   chains overlap than by the ring's depth (ops/sweep_decode_attention.py
//   times other depths and split sizes; PERF.md has its numbers). Rows
//   past the valid count are zero-filled (source size 0), so V rows past
//   `len` can never bring NaN or Inf into the sums (p = 0 times garbage),
//   and their scores are masked;
// - paged addressing reads each table entry a split touches once, into
//   shared memory, before the split's first copy (one entry per page: per
//   tile at BT >= 64, per 16 rows at BT 16). The length cap and the clip
//   keep a stale length (an inactive slot whose released table row is all
//   -1, or a table sliced to the active working set) from reading
//   table[s, MAXB] or page -1;
// - tiles sit in rows padded by 8 bf16 values, so ldmatrix's 8 row
//   addresses hit 8 distinct 16-byte bank groups;
// - it reads the engine's per-layer cache or pool slice and band
//   [W, S, K, Dh] in place through the strides it is given.

#include "sm90_helpers.cuh"

namespace {

constexpr int kTile = 64;          // cache rows per tile, 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;         // tiles in flight
constexpr int kSplitRows = 256;    // C: cache rows per split, a multiple of kTile
constexpr int kMergeThreads = 128;
constexpr int kMaxG = 16;          // query heads per kv head: the mma's 16 rows
constexpr int kMaxPages = kSplitRows + 1;  // pages one split can touch
constexpr float kNegInf = -1e30f;

template <int DH>
struct Smem {
  __nv_bfloat16 k[kStages][kTile][DH + 8];  // the cp.async ring
  __nv_bfloat16 v[kStages][kTile][DH + 8];
  float wm[kWarps][kMaxG], wl[kWarps][kMaxG];  // each warp's running max and sum
  int page[kMaxPages];
};

// each warp's acc [16][DH + 8] for the merge across warps, over the ring
template <int DH>
__device__ __forceinline__ float* warp_acc(Smem<DH>& sm, int warp) {
  static_assert(kWarps * kMaxG * (DH + 8) * 4 <= sizeof(Smem<DH>::k), "merge area exceeds the ring");
  return reinterpret_cast<float*>(&sm.k[0][0][0]) + warp * kMaxG * (DH + 8);
}

// Cache row t of a slot: the element offset of its (kv head 0) row, and the
// number of rows the slot holds. `stage_pages` brings the table entries of
// rows [t_lo, t_hi) into shared memory; `offset` may read them there.
struct SlabRows {
  int64_t c_slot, c_t;  // cache strides, in elements
  int cap;              // T
  __device__ __forceinline__ int length(int len) const { return max(0, min(len, cap)); }
  __device__ __forceinline__ void stage_pages(int*, int, int, int) const {}
  __device__ __forceinline__ int64_t offset(const int*, int slot, int t, int) const {
    return slot * c_slot + t * c_t;
  }
};

struct PagedRows {
  const int* table;     // [S, maxb] physical page ids, -1 where unused
  int nb, bt, maxb;
  int64_t p_page, p_t;  // pool strides, in elements
  __device__ __forceinline__ int length(int len) const { return max(0, min(len, maxb * bt)); }
  __device__ __forceinline__ void stage_pages(int* page, int slot, int t_lo, int t_hi) const {
    if (t_hi <= t_lo) return;
    const int p0 = t_lo / bt, n = (t_hi - 1) / bt - p0 + 1;  // t_hi <= maxb * bt
    for (int i = threadIdx.x; i < n; i += kThreads)
      page[i] = min(max(table[(int64_t)slot * maxb + p0 + i], 0), nb - 1);
  }
  __device__ __forceinline__ int64_t offset(const int* page, int, int t, int t_lo) const {
    return page[t / bt - t_lo / bt] * p_page + (t % bt) * p_t;
  }
};

// A split's partial: the running max and sum of up to kMaxG heads, then the
// unnormalised acc [G, DH]; a multiple of 4 floats, so float4 loads align.
__device__ __forceinline__ int record(int G, int DH) { return 2 * kMaxG + G * DH; }

// Split j holds the band-plus-self tile iff j == band_split(len, splits);
// splits past it hold no row of the slot.
__device__ __forceinline__ int band_split(int len, int splits) {
  return min(len / kSplitRows, splits - 1);
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
    float* __restrict__ part,                   // [S, K, splits, record(G, DH)]
    int H, int K, int step, int64_t b_w, int64_t b_slot, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(smem_raw);
  const int slot = blockIdx.x, kh = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int G = H / K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  // the merge kernel may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  const int len = rows.length(lens[slot]);
  const int last = band_split(len, splits);
  if (split > last) return;  // no row of the slot here; the merge never reads it

  // this thread's query fragments (heads gid and gid + 8), raw; scaled once
  // the first tile is on its way
  const __nv_bfloat16* qh = q + ((int64_t)slot * H + kh * G) * DH;
  __nv_bfloat162 qraw[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int g = gid + 8 * (i % 2), d = kk * 16 + tig * 2 + 8 * (i / 2);
      qraw[kk][i] = g < G ? *reinterpret_cast<const __nv_bfloat162*>(qh + g * DH + d)
                          : __floats2bfloat162_rn(0.f, 0.f);
    }
  const int t_lo = split * kSplitRows;
  const int t_hi = min(len, t_lo + kSplitRows);
  const int n_cache = max(0, t_hi - t_lo);
  const int cache_tiles = (n_cache + kTile - 1) / kTile;
  const int n_tiles = cache_tiles + (split == last ? 1 : 0);
  rows.stage_pages(sm.page, slot, t_lo, t_hi);
  __syncthreads();

  const __nv_bfloat16* kc = k_cache + kh * DH;
  const __nv_bfloat16* vc = v_cache + kh * DH;
  const __nv_bfloat16* kb = k_band + slot * b_slot + kh * DH;
  const __nv_bfloat16* vb = v_band + slot * b_slot + kh * DH;
  const __nv_bfloat16* kn = k_new + ((int64_t)slot * K + kh) * DH;
  const __nv_bfloat16* vn = v_new + ((int64_t)slot * K + kh) * DH;
  // tile i of the block into ring stage i % kStages, by all threads: cache
  // rows, then the band rows < step and the slot's own K/V at row `step`;
  // zeros past the valid rows
  auto issue = [&](int i) {
    const int st = i % kStages;
    constexpr int kChunks = DH / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const __nv_bfloat16 *ks = kc, *vs = vc;
      bool ok;
      if (i < cache_tiles) {
        const int t = t_lo + i * kTile + r;
        ok = t < t_hi;
        if (ok) {
          const int64_t off = rows.offset(sm.page, slot, t, t_lo);
          ks = kc + off;
          vs = vc + off;
        }
      } else {
        ok = r <= step;
        if (r < step) {
          ks = kb + r * b_w;
          vs = vb + r * b_w;
        } else if (r == step) {
          ks = kn;
          vs = vn;
        }
      }
      cp_async16(&sm.k[st][r][col], ks + col, ok);
      cp_async16(&sm.v[st][r][col], vs + col, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(qraw[kk][i]);
      qa[kk][i] = pack_bf16(x.x * scale, x.y * scale);
    }

  float o[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16;  // this warp's 16 rows of every tile
  const int mi = lane / 8;   // the 8x8 matrix whose row address this lane gives ldmatrix

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile i has landed for every thread
    const int st = i % kStages;
    const int n = i < cache_tiles ? min(kTile, n_cache - i * kTile) : step + 1;

    // S = Q K^T over the warp's rows: two 8-row mma tiles, K by ldmatrix
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, &sm.k[st][r0 + (mi / 2) * 8 + lane % 8][kk * 16 + (mi % 2) * 8]);
      mma_bf16(s[0], qa[kk], b[0], b[1]);
      mma_bf16(s[1], qa[kk], b[2], b[3]);
    }

    // mask, online softmax over the warp's rows (heads gid and gid + 8)
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nt][2 * h + c];
          x = r0 + nt * 8 + tig * 2 + c < n ? x : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[h], quad_max(mx));
      corr[h] = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nt][2 * h + c];
          x = x > 0.5f * kNegInf ? expf(x - m_new) : 0.f;
          sum += x;
        }
      l[h] = l[h] * corr[h] + sum;  // per-thread partial, summed over the quad at the end
      m[h] = m_new;
    }

    // O = O * corr + P V, P rounded to bf16 as on the TPU; V by ldmatrix.trans
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int nd = 0; nd < DH / 8; nd += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, &sm.v[st][r0 + (mi % 2) * 8 + lane % 8][(nd + mi / 2) * 8]);
      mma_bf16(o[nd], pa, b[0], b[1]);
      mma_bf16(o[nd + 1], pa, b[2], b[3]);
    }
    __syncthreads();  // stage st consumed before it is refilled
  }
  cp_async_wait<0>();

  // merge the warps in a fixed order: each scales its acc to the block's
  // max, the sums run over warps 0..kWarps-1
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  if (tig == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sm.wm[warp][gid + 8 * h] = m[h];
      sm.wl[warp][gid + 8 * h] = l[h];
    }
  }
  __syncthreads();  // the ring is free: it becomes the merge area
  float* acc = warp_acc(sm, warp);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = gid + 8 * h;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm.wm[w][g]);
    const float e = expf(m[h] - mb);
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      *reinterpret_cast<float2*>(acc + g * (DH + 8) + nd * 8 + tig * 2) =
          make_float2(o[nd][2 * h] * e, o[nd][2 * h + 1] * e);
  }
  __syncthreads();

  const bool direct = last == 0;  // split 0 holds every row of the slot
  float* rec = part + (((int64_t)slot * K + kh) * splits + split) * record(G, DH);
  for (int i = threadIdx.x; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm.wm[w][g]);
    float a = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += warp_acc(sm, w)[g * (DH + 8) + d];
      lb += sm.wl[w][g] * expf(sm.wm[w][g] - mb);
    }
    if (direct) {
      out[((int64_t)slot * H + kh * G + g) * DH + d] = a / lb;
    } else {
      rec[2 * kMaxG + i] = a;
      if (d == 0) {
        rec[g] = mb;
        rec[kMaxG + g] = lb;
      }
    }
  }
}

// One block per (slot, kv head) of a slot with more than one live split:
// out = sum_j e_j acc_j / sum_j e_j l_j, e_j = exp(m_j - max m), j in order.
// Each thread owns 4 consecutive outputs of one head; the loads of the
// splits do not depend on each other, so unrolled loops keep several in
// flight. Launched as a programmatic dependent of the main kernel: its
// blocks start while the main grid drains and wait for it to finish.
template <int DH>
__global__ void __launch_bounds__(kMergeThreads) merge_splits_kernel(
    const float* __restrict__ part, const int* __restrict__ lens, float* __restrict__ out,
    int H, int K, int splits, int cap) {
  // every block waits for the main grid, even one with nothing to merge:
  // this grid's end then implies the main grid's, for the kernels after it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int slot = blockIdx.x, kh = blockIdx.y;
  const int G = H / K;
  const int last = band_split(max(0, min(lens[slot], cap)), splits);
  if (last == 0) return;  // split 0 wrote this slot's output
  const int rec = record(G, DH);
  const float* p = part + ((int64_t)slot * K + kh) * splits * rec;
  for (int i = threadIdx.x * 4; i < G * DH; i += kMergeThreads * 4) {
    const int g = i / DH;
    float mx = kNegInf;
#pragma unroll 8
    for (int j = 0; j <= last; ++j) mx = fmaxf(mx, p[j * rec + g]);
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j <= last; ++j) {
      const float e = expf(p[j * rec + g] - mx);
      const float4 x = *reinterpret_cast<const float4*>(p + j * rec + 2 * kMaxG + i);
      lsum += e * p[j * rec + kMaxG + g];
      a.x += e * x.x;
      a.y += e * x.y;
      a.z += e * x.z;
      a.w += e * x.w;
    }
    *reinterpret_cast<float4*>(out + ((int64_t)slot * H + kh * G) * DH + i) =
        make_float4(a.x / lsum, a.y / lsum, a.z / lsum, a.w / lsum);
  }
}

template <int DH, typename Rows>
int launch_dh(int S, int K, int splits, cudaStream_t st, const void* q, const void* k_new,
              const void* v_new, const void* k_cache, const void* v_cache, Rows rows, int cap,
              const void* lens, const void* k_band, const void* v_band, void* out, void* part,
              int H, int step, long long b_w, long long b_slot, float scale) {
  const int smem = (int)sizeof(Smem<DH>);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<DH, Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<DH, Rows><<<dim3(S, K, splits), kThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new,
      (const __nv_bfloat16*)k_cache, (const __nv_bfloat16*)v_cache, rows, (const int*)lens,
      (const __nv_bfloat16*)k_band, (const __nv_bfloat16*)v_band, (float*)out, (float*)part, H,
      K, step, b_w, b_slot, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, K);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, merge_splits_kernel<DH>, (const float*)part, (const int*)lens,
                                 (float*)out, H, K, splits, cap);
}

template <typename Rows>
int launch(const void* q, const void* k_new, const void* v_new, const void* k_cache,
           const void* v_cache, Rows rows, int cap, const void* lens, const void* k_band,
           const void* v_band, void* out, void* part, int splits, int split_rows, int S, int H,
           int K, int Dh, int step, long long b_w, long long b_slot, float scale, void* stream) {
  if (S <= 0 || K <= 0 || H % K != 0 || H / K > kMaxG || step < 0 || step >= kTile ||
      cap < 0 || split_rows != kSplitRows || splits != max(1, (cap + kSplitRows - 1) / kSplitRows) ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(DH)                                                                               \
  launch_dh<DH>(S, K, splits, st, q, k_new, v_new, k_cache, v_cache, rows, cap, lens, k_band,   \
                v_band, out, part, H, step, b_w, b_slot, scale)
  if (Dh == 32) return LAUNCH(32);
  if (Dh == 64) return LAUNCH(64);
  if (Dh == 128) return LAUNCH(128);
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention_staged_bf16(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* lens, const void* k_band, const void* v_band,
    void* out, void* part, int splits, int split_rows, int S, int H, int K, int Dh, int T,
    int step, long long c_slot, long long c_t, long long b_w, long long b_slot, float scale,
    void* stream) {
  return launch(q, k_new, v_new, k_cache, v_cache, SlabRows{(int64_t)c_slot, (int64_t)c_t, T}, T,
                lens, k_band, v_band, out, part, splits, split_rows, S, H, K, Dh, step, b_w,
                b_slot, scale, stream);
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_new, const void* v_new, const void* k_pool,
    const void* v_pool, const void* table, const void* lens, const void* k_band,
    const void* v_band, void* out, void* part, int splits, int split_rows, int S, int H, int K,
    int Dh, int step, int NB, int BT, int MAXB, long long p_page, long long p_t, long long b_w,
    long long b_slot, float scale, void* stream) {
  if (NB <= 0 || BT <= 0 || MAXB <= 0) return (int)cudaErrorInvalidValue;
  return launch(q, k_new, v_new, k_pool, v_pool,
                PagedRows{(const int*)table, NB, BT, MAXB, (int64_t)p_page, (int64_t)p_t},
                MAXB * BT, lens, k_band, v_band, out, part, splits, split_rows, S, H, K, Dh, step,
                b_w, b_slot, scale, stream);
}
