// Packed-row causal GQA flash attention, backward, for sm_90a: dq (kernel
// #3) and dk/dv (kernel #4).
//
// Replaces the JAX package's Pallas kernels `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` in pipelinerl_tpu/ops/gqa_attention.py (reached through
// `_bwd_call` from the custom VJP of `mha_packed_gqa`). Contract, the same
// as the forward's (csrc/gqa_attention_fwd.cu): q/dO [B, Lq, H, Dh], k/v
// [B, Lkv, K, Dh] in bf16; query i sees key j iff q_offset + i >= j and
// q_seg[i] == kv_seg[j] (any ids, sorted or not); lse [B, Lq, K, G] and
// delta = rowsum(dO * O) in the same layout, fp32. For every visible pair:
//   p = exp(scale * q.k - lse),  ds = p * (dO.v - delta),
//   dq = scale * sum_j ds(bf16) k_j,  dk = scale * sum_i ds(bf16) q_i,
//   dv = sum_i p(bf16) dO_i,
// with fp32 accumulation and bf16 outputs. p is computed only where the mask
// holds: a fully masked row has lse = -1e30, and exp(s + 1e30) would
// overflow before any later select could zero it.
//
// What bounds it on an H100: both, close to the ridge at training lengths.
// Per visible (query head, key) pair the flash backward needs five Dh-long
// products (s, dp, dq, dk, dv), 10 * Dh flops; this split, like the TPU's,
// recomputes s and dp in both kernels, seven products instead of five. At
// Dh = 64, H = 14, K = 2 and one row of L = 4096 in 8 segments that is 9.4
// Gflop (the split: 13.2) against about 31 MB in and out, near the ~295
// flop/byte at which the tensor cores become the limit: the dq kernel alone
// (three products) is bound by bytes, the dk/dv kernel (four) by operations.
//
// What held the first version back was not the tensor cores: dk/dv ran the
// TPU's sequential q axis as a serial loop in 128 blocks at one warp per SM
// sub-partition, both kernels walked every tile before the causal bound and
// tested each one's segment ids with global loads and shuffles, loads were
// synchronous, and transposed copies took 8-way bank conflicts.
//
// Design (PERF.md has the numbers, ops/sweep_gqa_attention_bwd.py the
// variants):
// - a tile schedule: a block first finds the span of tiles on the other
//   axis that can see its own tile. dq (64 folded q rows): the key tiles
//   holding the first and last key j <= q_offset + its last position whose
//   segment id lies in the block's [min, max]; dk/dv (64 keys): the q tiles
//   holding the first and last position i >= kv0 - q_offset whose id lies
//   in the keys' [min, max]. The whole block scans the int32 segment ids
//   (L2-resident, 8 independent loads a thread in flight) once; the loop
//   walks only the span and tests each tile's ids as it lands (a counting
//   barrier), so unsorted ids stay exact. `gqa_attention_bwd_schedule`
//   writes the same spans for the tests (ops/gqa_attention.py has the
//   plain version). The scan lives in gqa_tile_schedule.cuh, whose dq span
//   the forward (#2) walks too;
// - dk/dv splits each key tile's q span over the S blocks of a thread-block
//   cluster: grid (Lkv / 64, B * K, S), cluster (1, 1, S). Block (rank r)
//   sums its 1/S of the span for its 64 keys in registers, all G heads
//   folded into the q rows, then writes its fp32 partial into its own
//   shared memory; after a cluster barrier, rank r sums rows [r 64/S,
//   (r+1) 64/S) of every rank's partial through distributed shared memory,
//   in rank order, and stores them in bf16. No global partials, no second
//   kernel and no atomics: two calls give the same bits. S comes from the
//   static shape (ops/gqa_attention.dkv_splits: 4 at the training row,
//   where 2 and 8 were slower). fp32 partials in device memory summed by a
//   second kernel, the other design, timed slower at every S;
// - each kernel streams its tiles through a cp.async ring of kStages = 2
//   stages (dq: K, V and key ids; dk/dv: q, dO, lse, delta, ids and
//   positions), zero-filled past the valid rows, so the next tile's copy
//   runs under this tile's products (3 stages gained nothing);
// - bf16 mma.sync m16n8k16 with fp32 accumulation; each block keeps its own
//   operand (dq: Q and dO, dk/dv: K and V) as A fragments in registers, and
//   takes every B fragment from one row-major tile by ldmatrix (S, dP) or
//   ldmatrix.trans (dQ = dS K, dV = P^T dO, dK = dS^T Q). Rows are padded
//   by 8 bf16, so the 8 row addresses of an ldmatrix hit 8 distinct bank
//   groups; no transposed copy is kept;
// - the mask takes no branch: exp2 of every score, then a select (a
//   conditional exp per element compiles to a branch, and cost #4 about
//   half its time);
//   dq also runs the mask only on tiles that need it: a tile whose keys
//   all share the rows' one id and precede the first row runs the same
//   products unmasked (about three in four tiles of a packed training row),
//   as FlashAttention masks only diagonal tiles;
// - S and dP are computed per chunk of 32 keys (dq) or 32 q rows (dk/dv;
//   16 at Dh 128), so Dh 64 fits 3 dq blocks and 2 dk/dv blocks on an SM
//   without spills, and Dh 128 fits 2 of each; at Dh 128 dk/dv takes K's
//   and V's A fragments from a shared tile by ldmatrix, since its dk/dv sums
//   alone take 128 registers a thread;
// - ragged edges (Lq * G and Lkv not multiples of the tiles) are masked in
//   the kernels, so every length runs here.
// Not yet: wgmma and TMA (ROADMAP).

#include <cooperative_groups.h>

#include <type_traits>

#include "gqa_tile_schedule.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 2;     // tiles in flight in each kernel's ring
constexpr int kKeyChunk = 32;  // dq: keys per S/dP chunk

// dk/dv: folded q rows per streamed tile (Dh 128 takes 32 so its K/V
// fragments and sums fit the registers), and rows per S^T/dP^T chunk
__host__ __device__ constexpr int dkv_q_rows(int dh) { return dh == 64 ? 64 : 32; }
__host__ __device__ constexpr int dkv_row_chunk(int dh) { return dh == 64 ? 32 : 16; }

// dk/dv's span: the q tiles of QR folded rows [first, last] that can see
// keys [kv0, kv0 + n_kv) of one batch row, and the keys' id range
__device__ __forceinline__ int2 dkv_span(const int* qs, const int* ks, int kv0, int n_kv, int G,
                                         int QR, int Lq, int q_offset, int& k_mn, int& k_mx) {
  warp_range(ks, kv0, kv0 + n_kv - 1, k_mn, k_mx);
  const int2 m = block_match(qs, max(0, kv0 - q_offset), Lq - 1, k_mn, k_mx);
  return m.y < 0 ? make_int2(0, -1) : make_int2(m.x * G / QR, (m.y * G + G - 1) / QR);
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int DH>
struct DqStage {
  __nv_bfloat16 k[kTile][DH + 8];  // [key][d]
  __nv_bfloat16 v[kTile][DH + 8];
  int seg[kTile];
};

template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 64 ? 3 : 2) gqa_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q,     // [B, Lq, H, DH]
    const __nv_bfloat16* __restrict__ k,     // [B, Lkv, K, DH]
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout,  // [B, Lq, H, DH]
    const float* __restrict__ lse,           // [B, Lq, K, G]
    const float* __restrict__ delta,         // [B, Lq, K, G]
    const int* __restrict__ qseg,            // [B, Lq]
    const int* __restrict__ kseg,            // [B, Lkv]
    __nv_bfloat16* __restrict__ dq,          // [B, Lq, H, DH]
    int Lq, int Lkv, int H, int K, int q_offset, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqStage<DH>* ring = reinterpret_cast<DqStage<DH>*>(smem_raw);
  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int mi = lane / 8;  // the 8x8 matrix whose row address this lane gives ldmatrix
  const int n_rows = Lq * G;
  const int r0 = blockIdx.x * kTile;
  const int* qs = qseg + (int64_t)b * Lq;
  const int* ks = kseg + (int64_t)b * Lkv;

  // this thread's two rows r (fragment rows gid and gid + 8 of its warp):
  // each one's id, lse, delta, the last key it sees (causally and below
  // Lkv; -1 for a row past the end), and its Q and dO fragments for every
  // 16-wide slice of DH, straight from memory
  int row_seg[2], row_lim[2];
  float row_lse[2], row_delta[2];
  uint32_t qa[DH / 16][4], da[DH / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + gid + 8 * h;
    const bool ok = r < n_rows;
    const int i = ok ? r / G : 0, g = ok ? r % G : 0;
    row_lim[h] = ok ? min(Lkv - 1, q_offset + i) : -1;
    row_seg[h] = qs[i];
    const int64_t li = (((int64_t)b * Lq + i) * K + kh) * G + g;
    row_lse[h] = ok ? lse[li] : 0.f;
    row_delta[h] = ok ? delta[li] : 0.f;
    const int64_t off = (((int64_t)b * Lq + i) * H + kh * G + g) * DH + tig * 2;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      qa[kk][h] = ok ? ld32(q + off + kk * 16) : 0u;
      qa[kk][h + 2] = ok ? ld32(q + off + kk * 16 + 8) : 0u;
      da[kk][h] = ok ? ld32(dout + off + kk * 16) : 0u;
      da[kk][h + 2] = ok ? ld32(dout + off + kk * 16 + 8) : 0u;
    }
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  int q_mn, q_mx;
  const int2 span = dq_span(qs, ks, r0, min(r0 + kTile - 1, n_rows - 1), G, Lkv, q_offset, q_mn, q_mx);
  const int n_tiles = span.y - span.x + 1;

  // tile i of the span into ring stage i % kStages, by all threads
  auto issue = [&](int i) {
    DqStage<DH>& st = ring[i % kStages];
    const int kv0 = (span.x + i) * kTile;
    constexpr int kChunks = DH / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const bool ok = kv0 + r < Lkv;
      const int64_t off = ok ? (((int64_t)b * Lkv + kv0 + r) * K + kh) * DH + col : 0;
      cp_async16(&st.k[r][col], k + off, ok);
      cp_async16(&st.v[r][col], v + off, ok);
    }
    if (threadIdx.x < kTile) {
      const bool ok = kv0 + (int)threadIdx.x < Lkv;
      cp_async4(&st.seg[threadIdx.x], ks + (ok ? kv0 + threadIdx.x : 0), ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const DqStage<DH>& st = ring[i % kStages];
    const int kv0 = (span.x + i) * kTile;
    // each thread reads the id its own copy brought; the barrier then makes
    // the whole tile visible and counts the keys whose id lies in the rows'
    const int t = threadIdx.x;
    const bool hit = t < kTile && kv0 + t < Lkv && st.seg[t] >= q_mn && st.seg[t] <= q_mx;
    const int hits = __syncthreads_count(hit);
    if (hits == 0) continue;  // nobody reads this stage again
    // every row sees every key of the tile: one id throughout, and the last
    // key at or before the first row's position (every row valid or zero)
    const bool full = hits == kTile && q_mn == q_mx && kv0 + kTile - 1 <= q_offset + r0 / G;
    // the tile's products; `masked` (a std::bool_constant) applies the mask
    auto products = [&](auto masked) {
#pragma unroll
      for (int kc = 0; kc < kTile; kc += kKeyChunk) {
        // S = Q K^T and dP = dO V^T for this warp's 16 rows and the chunk's keys
        float s[kKeyChunk / 8][4], dp[kKeyChunk / 8][4];
#pragma unroll
        for (int nt = 0; nt < kKeyChunk / 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
          for (int np = 0; np < kKeyChunk / 16; ++np) {
            const int row = kc + np * 16 + (mi / 2) * 8 + lane % 8, col = kk * 16 + (mi % 2) * 8;
            uint32_t bk[4], bv[4];
            ldmatrix_x4(bk, &st.k[row][col]);
            ldmatrix_x4(bv, &st.v[row][col]);
            mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
            mma_bf16(dp[2 * np], da[kk], bv[0], bv[1]);
            mma_bf16(dp[2 * np + 1], da[kk], bv[2], bv[3]);
          }

        // dS = P (dP - delta), P recomputed from lse and kept where the mask
        // holds; exp of every score, then a select: no branch per element
#pragma unroll
        for (int nt = 0; nt < kKeyChunk / 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int h = c / 2;
            const float e = exp2f((s[nt][c] * scale - row_lse[h]) * kLog2e);
            if constexpr (decltype(masked)::value) {
              const int kj = kc + nt * 8 + tig * 2 + (c & 1);
              const bool ok = (kv0 + kj <= row_lim[h]) & (row_seg[h] == st.seg[kj]);
              s[nt][c] = ok ? e * (dp[nt][c] - row_delta[h]) : 0.f;
            } else {
              s[nt][c] = e * (dp[nt][c] - row_delta[h]);
            }
          }

        // dQ += dS K, dS rounded to bf16 as the TPU kernel does; K^T's
        // fragments by ldmatrix.trans from the row-major tile
#pragma unroll
        for (int kk = 0; kk < kKeyChunk / 16; ++kk) {
          uint32_t a[4];
          c_to_a(s, kk, a);
#pragma unroll
          for (int nd = 0; nd < DH / 8; nd += 2) {
            uint32_t bk[4];
            ldmatrix_x4_trans(bk, &st.k[kc + kk * 16 + (mi % 2) * 8 + lane % 8][(nd + mi / 2) * 8]);
            mma_bf16(acc[nd], a, bk[0], bk[1]);
            mma_bf16(acc[nd + 1], a, bk[2], bk[3]);
          }
        }
      }
    };
    if (full)
      products(std::false_type{});
    else
      products(std::true_type{});
    __syncthreads();  // stage consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + gid + 8 * h;
    if (r >= n_rows) continue;
    const int64_t off = (((int64_t)b * Lq + r / G) * H + kh * G + r % G) * DH + tig * 2;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dq + off + nd * 8) =
          __floats2bfloat162_rn(acc[nd][2 * h] * scale, acc[nd][2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <int DH, int QR>
struct DkvStage {
  __nv_bfloat16 q[QR][DH + 8];  // [row][d]
  __nv_bfloat16 dout[QR][DH + 8];
  float lse[QR];
  float delta[QR];
  int seg[QR];
  int pos[QR];  // global index q_offset + i of the row's position; -1 past the end
};

// one block's fp32 sums for its 64 keys, rows padded by 8 floats
template <int DH>
struct DkvPartial {
  float dk[kTile][DH + 8];
  float dv[kTile][DH + 8];
};

// At Dh 128 the K and V fragments and the dk/dv sums would take 192
// registers a thread: K's and V's fragments come from a shared tile instead.
template <int DH>
__host__ __device__ constexpr bool dkv_kv_in_smem() { return DH > 64; }

// the ring (and the K/V tile after it), and after the loop the partial in
// the same bytes
template <int DH, int QR>
constexpr size_t dkv_smem() {
  constexpr size_t ring = kStages * sizeof(DkvStage<DH, QR>) +
                          (dkv_kv_in_smem<DH>() ? sizeof(__nv_bfloat16) * 2 * kTile * (DH + 8) : 0);
  return ring > sizeof(DkvPartial<DH>) ? ring : sizeof(DkvPartial<DH>);
}

// Sum rows [r 64/S, (r+1) 64/S) of every rank's partial in rank order, and
// store them: dk scaled, both in bf16. Runs between two cluster barriers;
// each thread maps every rank's partial once.
template <int DH>
__device__ __forceinline__ void store_dkv(const cg::cluster_group& cluster, DkvPartial<DH>& part,
                                          __nv_bfloat16* dk, __nv_bfloat16* dv, int64_t key0,
                                          int64_t key_stride, int n_kv, float scale) {
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int R = (kTile + S - 1) / S, row0 = rank * R;
  const int rows = max(0, min(kTile, row0 + R) - row0);
  constexpr int kVec = DH / 4;  // float4s per row
  const float* parts[kMaxSplits];
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r)
    parts[r] = reinterpret_cast<const float*>(cluster.map_shared_rank(&part, r < S ? r : 0));
#pragma unroll 4
  for (int e = threadIdx.x; e < 2 * rows * kVec; e += kThreads) {
    const int which = e / (rows * kVec);  // 0: dk, 1: dv
    const int rem = e - which * rows * kVec;
    const int key = row0 + rem / kVec, c4 = (rem % kVec) * 4;
    const int o = (which * kTile + key) * (DH + 8) + c4;
    float4 x[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < S) x[r] = *reinterpret_cast<const float4*>(parts[r] + o);
    float4 a = x[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r)
      if (r < S) {
        a.x += x[r].x;
        a.y += x[r].y;
        a.z += x[r].z;
        a.w += x[r].w;
      }
    if (key < n_kv) {
      const float sc = which ? 1.f : scale;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * sc, a.y * sc);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * sc, a.w * sc);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>((which ? dv : dk) + key0 + key * key_stride + c4) = packed;
    }
  }
}

template <int DH, int QR>
__global__ void __launch_bounds__(kThreads, 2) gqa_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q,     // [B, Lq, H, DH]
    const __nv_bfloat16* __restrict__ k,     // [B, Lkv, K, DH]
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout,  // [B, Lq, H, DH]
    const float* __restrict__ lse,           // [B, Lq, K, G]
    const float* __restrict__ delta,         // [B, Lq, K, G]
    const int* __restrict__ qseg,            // [B, Lq]
    const int* __restrict__ kseg,            // [B, Lkv]
    __nv_bfloat16* __restrict__ dk,          // [B, Lkv, K, DH]
    __nv_bfloat16* __restrict__ dv,
    int Lq, int Lkv, int H, int K, int q_offset, float scale) {
  constexpr int RC = dkv_row_chunk(DH);
  static_assert(QR % RC == 0 && QR <= kThreads, "q tile rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvStage<DH, QR>* ring = reinterpret_cast<DkvStage<DH, QR>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int mi = lane / 8;  // the 8x8 matrix whose row address this lane gives ldmatrix
  const int kv0 = blockIdx.x * kTile;
  const int n_kv = min(kTile, Lkv - kv0);
  const int n_rows = Lq * G;
  const int* qs = qseg + (int64_t)b * Lq;
  const int* ks = kseg + (int64_t)b * Lkv;

  // this thread's two keys (fragment rows gid and gid + 8 of its warp), and
  // the first position that sees each (INT32_MAX for a key past the end)
  int key_pos[2], key_seg[2], key_lim[2];
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = warp * 16 + gid + 8 * h;
    key_ok[h] = j < n_kv;
    key_pos[h] = kv0 + (key_ok[h] ? j : 0);
    key_lim[h] = key_ok[h] ? key_pos[h] : INT32_MAX;
    key_seg[h] = ks[key_pos[h]];
  }

  // K and V fragments as A operands, straight from memory; at Dh 128 the
  // keys' K and V rows go to shared memory instead (their own commit group,
  // before the ring's)
  constexpr bool kKVInSmem = dkv_kv_in_smem<DH>();
  uint32_t ka[kKVInSmem ? 1 : DH / 16][4], va[kKVInSmem ? 1 : DH / 16][4];
  auto* kvt = reinterpret_cast<__nv_bfloat16(*)[kTile][DH + 8]>(ring + kStages);  // [K or V][key][d]
  if constexpr (kKVInSmem) {
    constexpr int kChunks = DH / 8;
    for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const bool ok = r < n_kv;
      const int64_t off = ok ? (((int64_t)b * Lkv + kv0 + r) * K + kh) * DH + col : 0;
      cp_async16(&kvt[0][r][col], k + off, ok);
      cp_async16(&kvt[1][r][col], v + off, ok);
    }
    cp_async_commit();
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t o = (((int64_t)b * Lkv + key_pos[h]) * K + kh) * DH + kk * 16 + tig * 2;
        ka[kk][h] = key_ok[h] ? ld32(k + o) : 0u;
        ka[kk][h + 2] = key_ok[h] ? ld32(k + o + 8) : 0u;
        va[kk][h] = key_ok[h] ? ld32(v + o) : 0u;
        va[kk][h + 2] = key_ok[h] ? ld32(v + o + 8) : 0u;
      }
    }
  }

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[nd][c] = dv_acc[nd][c] = 0.f;

  // this rank's share of the key tile's q span
  int k_mn, k_mx;
  const int2 span = dkv_span(qs, ks, kv0, n_kv, G, QR, Lq, q_offset, k_mn, k_mx);
  const int2 share = rank_share(span, rank, S);
  const int t_begin = share.x, n_tiles = share.y - share.x;

  // tile i of this rank into ring stage i % kStages, by all threads
  auto issue = [&](int i) {
    DkvStage<DH, QR>& st = ring[i % kStages];
    const int r0 = (t_begin + i) * QR;
    constexpr int kChunks = DH / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < QR * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int rr = r0 + r;
      const bool ok = rr < n_rows;
      const int64_t off = ok ? (((int64_t)b * Lq + rr / G) * H + kh * G + rr % G) * DH + col : 0;
      cp_async16(&st.q[r][col], q + off, ok);
      cp_async16(&st.dout[r][col], dout + off, ok);
    }
    if (threadIdx.x < QR) {
      const int r = threadIdx.x, rr = r0 + r;
      const bool ok = rr < n_rows;
      const int i_pos = ok ? rr / G : 0;
      const int64_t li = ok ? (((int64_t)b * Lq + i_pos) * K + kh) * G + rr % G : 0;
      cp_async4(&st.lse[r], lse + li, ok);
      cp_async4(&st.delta[r], delta + li, ok);
      cp_async4(&st.seg[r], qs + i_pos, ok);
      st.pos[r] = ok ? q_offset + i_pos : -1;
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const DkvStage<DH, QR>& st = ring[i % kStages];
    // each thread reads the row its own copy brought; the barrier then makes
    // the whole tile visible and tells whether any row shares the keys' ids
    const int t = threadIdx.x;
    const bool hit = t < QR && st.pos[t] >= 0 && st.seg[t] >= k_mn && st.seg[t] <= k_mx;
    if (!__syncthreads_or(hit)) continue;  // nobody reads this stage again

#pragma unroll
    for (int rc = 0; rc < QR; rc += RC) {
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and the chunk's rows
      float st_[RC / 8][4], dpt[RC / 8][4];
#pragma unroll
      for (int nt = 0; nt < RC / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) st_[nt][c] = dpt[nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
        for (int np = 0; np < RC / 16; ++np) {
          const int row = rc + np * 16 + (mi / 2) * 8 + lane % 8, col = kk * 16 + (mi % 2) * 8;
          uint32_t bq[4], bd[4];
          ldmatrix_x4(bq, &st.q[row][col]);
          ldmatrix_x4(bd, &st.dout[row][col]);
          if constexpr (kKVInSmem) {
            // A fragments of keys [16 warp, +16) x d [16 kk, +16)
            const int arow = warp * 16 + (mi % 2) * 8 + lane % 8, acol = kk * 16 + (mi / 2) * 8;
            uint32_t a[4];
            ldmatrix_x4(a, &kvt[0][arow][acol]);
            mma_bf16(st_[2 * np], a, bq[0], bq[1]);
            mma_bf16(st_[2 * np + 1], a, bq[2], bq[3]);
            ldmatrix_x4(a, &kvt[1][arow][acol]);
            mma_bf16(dpt[2 * np], a, bd[0], bd[1]);
            mma_bf16(dpt[2 * np + 1], a, bd[2], bd[3]);
          } else {
            mma_bf16(st_[2 * np], ka[kk], bq[0], bq[1]);
            mma_bf16(st_[2 * np + 1], ka[kk], bq[2], bq[3]);
            mma_bf16(dpt[2 * np], va[kk], bd[0], bd[1]);
            mma_bf16(dpt[2 * np + 1], va[kk], bd[2], bd[3]);
          }
        }

      // P^T where the mask holds, dS^T = P^T (dP^T - delta); exp of every
      // score, then a select: no branch per element
#pragma unroll
      for (int nt = 0; nt < RC / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c / 2;
          const int r = rc + nt * 8 + tig * 2 + (c & 1);
          const bool ok = (st.pos[r] >= key_lim[h]) & (st.seg[r] == key_seg[h]);
          const float e = exp2f((st_[nt][c] * scale - st.lse[r]) * kLog2e);
          const float p = ok ? e : 0.f;
          st_[nt][c] = p;
          dpt[nt][c] = p * (dpt[nt][c] - st.delta[r]);
        }

      // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16; dO's and
      // Q's fragments by ldmatrix.trans from the row-major tiles
#pragma unroll
      for (int kk = 0; kk < RC / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(st_, kk, pa);
        c_to_a(dpt, kk, sa);
#pragma unroll
        for (int nd = 0; nd < DH / 8; nd += 2) {
          const int row = rc + kk * 16 + (mi % 2) * 8 + lane % 8, col = (nd + mi / 2) * 8;
          uint32_t bd[4], bq[4];
          ldmatrix_x4_trans(bd, &st.dout[row][col]);
          ldmatrix_x4_trans(bq, &st.q[row][col]);
          mma_bf16(dv_acc[nd], pa, bd[0], bd[1]);
          mma_bf16(dv_acc[nd + 1], pa, bd[2], bd[3]);
          mma_bf16(dk_acc[nd], sa, bq[0], bq[1]);
          mma_bf16(dk_acc[nd + 1], sa, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // stage consumed before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy landed and every read done: the ring becomes the partial

  DkvPartial<DH>& part = *reinterpret_cast<DkvPartial<DH>*>(smem_raw);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = warp * 16 + gid + 8 * h;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<float2*>(&part.dk[key][nd * 8 + tig * 2]) = make_float2(dk_acc[nd][2 * h], dk_acc[nd][2 * h + 1]);
      *reinterpret_cast<float2*>(&part.dv[key][nd * 8 + tig * 2]) = make_float2(dv_acc[nd][2 * h], dv_acc[nd][2 * h + 1]);
    }
  }
  cluster.sync();  // every rank's partial is written and visible to the cluster
  store_dkv<DH>(cluster, part, dk, dv, (((int64_t)b * Lkv + kv0) * K + kh) * DH, (int64_t)K * DH,
                n_kv, scale);
  cluster.sync();  // this block's shared memory stays until every rank has read it
}

// ---------------------------------------------------------------------------
// the schedule, written out
// ---------------------------------------------------------------------------

// Block x < n_qt of batch row y writes dq's span of q tile x, block n_qt + j
// dk/dv's span of key tile j, through the functions the kernels call.
__global__ void __launch_bounds__(kThreads) bwd_schedule_kernel(
    const int* __restrict__ qseg, const int* __restrict__ kseg, int2* __restrict__ dq_spans,
    int2* __restrict__ dkv_spans, int Lq, int Lkv, int G, int QR, int q_offset) {
  const int b = blockIdx.y;
  const int n_rows = Lq * G;
  const int n_qt = (n_rows + kTile - 1) / kTile, n_kt = (Lkv + kTile - 1) / kTile;
  const int* qs = qseg + (int64_t)b * Lq;
  const int* ks = kseg + (int64_t)b * Lkv;
  int mn, mx;
  if ((int)blockIdx.x < n_qt) {
    const int r0 = blockIdx.x * kTile;
    const int2 s = dq_span(qs, ks, r0, min(r0 + kTile - 1, n_rows - 1), G, Lkv, q_offset, mn, mx);
    if (threadIdx.x == 0) dq_spans[(int64_t)b * n_qt + blockIdx.x] = s;
  } else {
    const int j = blockIdx.x - n_qt, kv0 = j * kTile;
    const int2 s = dkv_span(qs, ks, kv0, min(kTile, Lkv - kv0), G, QR, Lq, q_offset, mn, mx);
    if (threadIdx.x == 0) dkv_spans[(int64_t)b * n_kt + j] = s;
  }
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* q_seg, const void* kv_seg, void* dq, int B, int Lq,
              int Lkv, int H, int K, int q_offset, float scale, cudaStream_t st) {
  constexpr size_t smem = kStages * sizeof(DqStage<DH>);
  static const cudaError_t attr = allow_smem(gqa_bwd_dq_kernel<DH>, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Lq * (H / K) + kTile - 1) / kTile, B * K);
  gqa_bwd_dq_kernel<DH><<<grid, kThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta, (const int*)q_seg,
      (const int*)kv_seg, (__nv_bfloat16*)dq, Lq, Lkv, H, K, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int DH, int QR>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* q_seg, const void* kv_seg, void* dk, void* dv,
               int B, int Lq, int Lkv, int H, int K, int q_offset, float scale, int splits,
               cudaStream_t st) {
  constexpr size_t smem = dkv_smem<DH, QR>();
  static const cudaError_t attr = allow_smem(gqa_bwd_dkv_kernel<DH, QR>, smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Lkv + kTile - 1) / kTile, B * K, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gqa_bwd_dkv_kernel<DH, QR>, (const __nv_bfloat16*)q,
                                 (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                                 (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta,
                                 (const int*)q_seg, (const int*)kv_seg, (__nv_bfloat16*)dk,
                                 (__nv_bfloat16*)dv, Lq, Lkv, H, K, q_offset, scale);
}

}  // namespace

extern "C" int gqa_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* q_seg, const void* kv_seg, void* dq, int B,
                                         int Lq, int Lkv, int H, int K, int Dh, int q_offset,
                                         float scale, void* stream) {
  if (bad_shape(B, Lq, Lkv, H, K, q_offset)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, Lq, Lkv, H, K,
                         q_offset, scale, st);
  if (Dh == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, Lq, Lkv, H, K,
                          q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gqa_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* q_seg, const void* kv_seg, void* dk,
                                          void* dv, int B, int Lq, int Lkv, int H, int K, int Dh,
                                          int q_offset, float scale, int splits, void* stream) {
  if (bad_shape(B, Lq, Lkv, H, K, q_offset) || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_dkv<64, dkv_q_rows(64)>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B, Lq,
                                          Lkv, H, K, q_offset, scale, splits, st);
  if (Dh == 128)
    return launch_dkv<128, dkv_q_rows(128)>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B,
                                            Lq, Lkv, H, K, q_offset, scale, splits, st);
  return (int)cudaErrorInvalidValue;
}

// The spans both kernels compute for these segment ids: dq_spans [B, ceil(Lq
// G / 64), 2] and dkv_spans [B, ceil(Lkv / 64), 2], int32, {0, -1} when empty.
extern "C" int gqa_attention_bwd_schedule(const void* q_seg, const void* kv_seg, void* dq_spans,
                                          void* dkv_spans, int B, int Lq, int Lkv, int G, int Dh,
                                          int q_offset, void* stream) {
  if (bad_shape(B, Lq, Lkv, G, 1, q_offset) || G <= 0 || (Dh != 64 && Dh != 128))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Lq * G + kTile - 1) / kTile + (Lkv + kTile - 1) / kTile, B);
  bwd_schedule_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const int*)q_seg, (const int*)kv_seg, (int2*)dq_spans, (int2*)dkv_spans, Lq, Lkv, G,
      dkv_q_rows(Dh), q_offset);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes per thread, dynamic shared memory bytes and
// resident blocks per SM of kernel `which` (0: dq, 1: dk/dv) at Dh, in out[4].
extern "C" int gqa_attention_bwd_kernel_info(int which, int Dh, int* out) {
  if (which == 0 && Dh == 64) return kernel_info(gqa_bwd_dq_kernel<64>, kStages * sizeof(DqStage<64>), out);
  if (which == 0 && Dh == 128) return kernel_info(gqa_bwd_dq_kernel<128>, kStages * sizeof(DqStage<128>), out);
  if (which == 1 && Dh == 64)
    return kernel_info(gqa_bwd_dkv_kernel<64, dkv_q_rows(64)>, dkv_smem<64, dkv_q_rows(64)>(), out);
  if (which == 1 && Dh == 128)
    return kernel_info(gqa_bwd_dkv_kernel<128, dkv_q_rows(128)>, dkv_smem<128, dkv_q_rows(128)>(), out);
  return (int)cudaErrorInvalidValue;
}
