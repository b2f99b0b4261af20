// Packed-row causal GQA flash attention, forward (kernel #2), for sm_90a.
//
// Replaces the forward of the JAX package's Pallas kernel `_fwd_kernel` in
// pipelinerl_tpu/ops/gqa_attention.py (reached through `_fwd_call` and
// `mha_packed_gqa`). Contract: q [B, Lq, H, Dh], k/v [B, Lkv, K, Dh] in
// bf16, Dh 64 or 128; query i sees key j iff q_offset + i >= j and q_seg[i]
// == kv_seg[j] (any ids, sorted or not); online softmax in fp32, P rounded
// to bf16 before P V; out [B, Lq, H, Dh] bf16 and lse [B, Lq, K, G] fp32
// (natural log of the sum of exp of the scaled scores). A row that sees no
// key gets out = 0 and lse = -1e30.
//
// What bounds it on an H100: bytes, at every shape the port runs. Per
// visible (query head, key) pair it does two Dh-long products (4 Dh flops)
// against q, k, v, out and lse moved once: at the training row (one packed
// row of L 4096 in 8 segments, H 14, K 2, Dh 64) 3.8 us of operations
// against 5.1 us of bytes.
//
// What held the first version back was not the tensor cores: each block
// walked every key tile from key 0 to its causal bound and tested each
// one's ids with global loads and shuffles, loads were synchronous, V was
// transposed by 2-byte stores, the mask took a branch per element, and
// grids of 100-250 blocks (prefill buckets, tails at q_offset > 0) left
// SMs idle while each block walked its tiles in series.
//
// Design (PERF.md has the numbers, ops/sweep_gqa_attention_fwd.py the
// variants):
// - the G = H/K query heads of a kv head are folded into the rows: a block
//   owns 64 consecutive (position, head) rows of one (batch, kv head), 16
//   per warp, so every K/V tile serves G heads;
// - dq's tile schedule (gqa_tile_schedule.cuh): the block first finds the
//   key tiles holding the first and last key its rows can see, walks only
//   those, and tests each tile's ids with a counting barrier as it lands;
// - short grids split a q tile's key span over the S blocks of a
//   thread-block cluster: grid (ceil(Lq G / 64), B K, S), cluster (1, 1,
//   S). Rank r walks its 1/S of the span, writes its (m, l, O) partial into
//   its own shared memory, and after a cluster barrier merges rows [r 64/S,
//   (r+1) 64/S) of every rank's partial through distributed shared memory,
//   in rank order. No atomics, no global partials and no second kernel: two
//   calls give the same bits. S comes from the static shape
//   (ops/gqa_attention.fwd_splits; 1 at the training row);
// - K, V and the key ids stream through a cp.async ring of kStages stages,
//   zero-filled past Lkv, so the next tile's copy runs under this tile's
//   products; Q comes in once by 16-byte copies into the ring's last stage,
//   and its A fragments by ldmatrix;
// - bf16 mma.sync m16n8k16 with fp32 accumulation: S = Q K^T takes K's B
//   fragments by ldmatrix and O += P V takes V's by ldmatrix.trans, both
//   from row-major tiles whose rows are padded by 8 bf16 (the 8 row
//   addresses of an ldmatrix hit 8 distinct bank groups); no transposed
//   copy;
// - the mask takes no branch: scores scaled by scale log2 e, masked ones
//   set to -1e30 by a select, then exp2 of every score (0 for the masked);
//   a tile whose keys all share the rows' one id and precede the first row
//   runs unmasked, as dq's does;
// - ragged edges (Lq * G and Lkv not multiples of 64) are masked in the
//   kernel, so every length runs here.
// Not yet: wgmma and TMA (ROADMAP).

#include <cooperative_groups.h>

#include <type_traits>

#include "gqa_tile_schedule.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 2;  // tiles in flight in the ring
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct FwdStage {
  __nv_bfloat16 k[kTile][DH + 8];  // [key][d]; Q's rows before the loop, in the last stage
  __nv_bfloat16 v[kTile][DH + 8];
  int seg[kTile];
};

// one rank's partial for the block's 64 rows: the unnormalised O, the
// running max (log2 units) and the sum, rows padded by 8 floats
template <int DH>
struct FwdPartial {
  float o[kTile][DH + 8];
  float m[kTile];
  float l[kTile];
};

// the ring, and after the loop the partial in the same bytes
template <int DH>
constexpr size_t fwd_smem() {
  return kStages * sizeof(FwdStage<DH>) > sizeof(FwdPartial<DH>) ? kStages * sizeof(FwdStage<DH>)
                                                                 : sizeof(FwdPartial<DH>);
}

__device__ __forceinline__ float lse_of(float m2, float l) {
  return m2 > 0.5f * kNegInf ? (m2 + log2f(l)) * kLn2 : kNegInf;
}

// Merge rows [r 64/S, (r+1) 64/S) of every rank's partial in rank order and
// store them (out in bf16, lse). Runs between two cluster barriers.
template <int DH>
__device__ __forceinline__ void store_merged(const cg::cluster_group& cluster, FwdPartial<DH>& part,
                                             __nv_bfloat16* out, float* lse, int64_t base, int r0,
                                             int n_rows, int G, int H) {
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int R = (kTile + S - 1) / S, row0 = rank * R;
  const int rows = max(0, min(kTile, row0 + R) - row0);
  constexpr int kVec = DH / 4;  // float4s per row
  const FwdPartial<DH>* parts[kMaxSplits];
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r) parts[r] = cluster.map_shared_rank(&part, r < S ? r : 0);
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * kVec; e += kThreads) {
    const int row = row0 + e / kVec, c4 = (e % kVec) * 4;
    float mr[kMaxSplits];
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < S) {
        mr[r] = parts[r]->m[row];
        mx = fmaxf(mx, mr[r]);
      }
    const float m_safe = fmaxf(mx, -1e29f);
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < S) {
        const float w = exp2f(mr[r] - m_safe);  // 0 for a rank that saw nothing
        const float4 x = *reinterpret_cast<const float4*>(&parts[r]->o[row][c4]);
        l += w * parts[r]->l[row];
        a.x += w * x.x;
        a.y += w * x.y;
        a.z += w * x.z;
        a.w += w * x.w;
      }
    const int rr = r0 + row;  // the folded row
    if (rr >= n_rows) continue;
    l = fmaxf(l, 1e-30f);
    const int64_t orow = base + (int64_t)(rr / G) * H + rr % G;  // [B, Lq, H] index of the row
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x / l, a.y / l);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z / l, a.w / l);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + orow * DH + c4) = packed;
    if (c4 == 0) lse[orow] = lse_of(mx, l);
  }
}

// the minimum blocks per SM is ops/gqa_attention.FWD_BLOCKS_PER_SM, which
// fwd_splits counts on
template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 64 ? 3 : 2) gqa_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Lq, H, DH]
    const __nv_bfloat16* __restrict__ k,  // [B, Lkv, K, DH]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ qseg,     // [B, Lq]
    const int* __restrict__ kseg,     // [B, Lkv]
    __nv_bfloat16* __restrict__ out,  // [B, Lq, H, DH]
    float* __restrict__ lse,          // [B, Lq, K, G], the same index as out's [B, Lq, H]
    int Lq, int Lkv, int H, int K, int q_offset, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdStage<DH>* ring = reinterpret_cast<FwdStage<DH>*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int mi = lane / 8;  // the 8x8 matrix whose row address this lane gives ldmatrix
  const int n_rows = Lq * G;
  const int r0 = blockIdx.x * kTile;
  const int* qs = qseg + (int64_t)b * Lq;
  const int* ks = kseg + (int64_t)b * Lkv;
  const float scale2 = scale * kLog2e;  // scores in log2 units
  const int64_t base = (int64_t)b * Lq * H + kh * G;  // [B, Lq, H] index of folded row r: base + (r / G) H + r % G

  // Q's 64 rows into the ring's last stage by 16-byte copies, zero past the
  // last row; its own commit group, the first
  {
    constexpr int kChunks = DH / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int rr = r0 + r;
      const bool ok = rr < n_rows;
      const int64_t off = ok ? (((int64_t)b * Lq + rr / G) * H + kh * G + rr % G) * DH + col : 0;
      cp_async16(&ring[kStages - 1].k[r][col], q + off, ok);
    }
    cp_async_commit();
  }

  // this thread's two rows (fragment rows gid and gid + 8 of its warp): the
  // id and the last key each sees (causally and below Lkv; -1 past the end)
  int row_seg[2], row_lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + gid + 8 * h;
    const bool ok = r < n_rows;
    const int i = ok ? r / G : 0;
    row_lim[h] = ok ? min(Lkv - 1, q_offset + i) : -1;
    row_seg[h] = qs[i];
  }

  // this rank's share of the q tile's key span
  int q_mn, q_mx;
  const int2 span = dq_span(qs, ks, r0, min(r0 + kTile - 1, n_rows - 1), G, Lkv, q_offset, q_mn, q_mx);
  const int2 share = rank_share(span, rank, S);
  const int n_tiles = share.y - share.x;

  // tile i of this rank into ring stage i % kStages, by all threads
  auto issue = [&](int i) {
    FwdStage<DH>& st = ring[i % kStages];
    const int kv0 = (share.x + i) * kTile;
    constexpr int kChunks = DH / 8;
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

  // Q's A fragments for every 16-wide slice of DH; then the stage is free
  cp_async_wait<kStages - 1>();
  __syncthreads();
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldmatrix_x4(qa[kk], &ring[kStages - 1].k[warp * 16 + (mi % 2) * 8 + lane % 8][kk * 16 + (mi / 2) * 8]);
  __syncthreads();

  float o[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nd][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units; l per thread

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const FwdStage<DH>& st = ring[i % kStages];
    const int kv0 = (share.x + i) * kTile;
    // each thread reads the id its own copy brought; the barrier then makes
    // the whole tile visible and counts the keys whose id lies in the rows'
    const int t = threadIdx.x;
    const bool hit = t < kTile && kv0 + t < Lkv && st.seg[t] >= q_mn && st.seg[t] <= q_mx;
    const int hits = __syncthreads_count(hit);
    if (hits == 0) continue;  // nobody reads this stage again
    // every row sees every key of the tile: one id throughout, and the last
    // key at or before the first row's position
    const bool full = hits == kTile && q_mn == q_mx && kv0 + kTile - 1 <= q_offset + r0 / G;
    // the tile's products and softmax update; `masked` (a std::bool_constant)
    // applies the mask
    auto tile = [&](auto masked) {
      // S = Q K^T for this warp's 16 rows and the tile's 64 keys
      float s[kTile / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, &st.k[np * 16 + (mi / 2) * 8 + lane % 8][kk * 16 + (mi % 2) * 8]);
          mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
        }

      // scores in log2 units, masked ones -1e30 by a select; row maxima
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c / 2;
          float x = s[nt][c] * scale2;
          if constexpr (decltype(masked)::value) {
            const int kj = nt * 8 + tig * 2 + (c & 1);
            const bool ok = (kv0 + kj <= row_lim[h]) & (row_seg[h] == st.seg[kj]);
            x = ok ? x : kNegInf;
          }
          s[nt][c] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      // online softmax: exp2 of every score, no branch (a masked score lies
      // 9e29 or more below the clamped max and gives 0)
      float corr[2], m_safe[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        m_safe[h] = fmaxf(m_new, -1e29f);  // a row with nothing visible yet still gives 0
        corr[h] = exp2f(m[h] - m_safe[h]);
        m[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nt][c] = exp2f(s[nt][c] - m_safe[c / 2]);
          sum[c / 2] += s[nt][c];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];

      // O = O corr + P V, P rounded to bf16 as the TPU kernel does; V's B
      // fragments by ldmatrix.trans from the row-major tile
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        o[nd][0] *= corr[0];
        o[nd][1] *= corr[0];
        o[nd][2] *= corr[1];
        o[nd][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t pa[4];
        c_to_a(s, kk, pa);
#pragma unroll
        for (int nd = 0; nd < DH / 8; nd += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, &st.v[kk * 16 + (mi % 2) * 8 + lane % 8][(nd + mi / 2) * 8]);
          mma_bf16(o[nd], pa, bv[0], bv[1]);
          mma_bf16(o[nd + 1], pa, bv[2], bv[3]);
        }
      }
    };
    if (full)
      tile(std::false_type{});
    else
      tile(std::true_type{});
    __syncthreads();  // stage consumed before it is refilled
  }
  cp_async_wait<0>();

  // the whole span in this block: store straight from the fragments (at S 1
  // through store_merged the training row read 66 against 42 us on an H100,
  // ops/sweep_gqa_attention_fwd.py)
  if (S == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lsum = fmaxf(quad_sum(l[h]), 1e-30f);
      const int r = r0 + warp * 16 + gid + 8 * h;
      if (r >= n_rows) continue;
      const int64_t orow = base + (int64_t)(r / G) * H + r % G;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        *reinterpret_cast<__nv_bfloat162*>(out + orow * DH + nd * 8 + tig * 2) =
            __floats2bfloat162_rn(o[nd][2 * h] / lsum, o[nd][2 * h + 1] / lsum);
      }
      if (tig == 0) lse[orow] = lse_of(m[h], lsum);
    }
    return;
  }

  __syncthreads();  // every copy landed and every read done: the ring becomes the partial
  FwdPartial<DH>& part = *reinterpret_cast<FwdPartial<DH>*>(smem_raw);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + gid + 8 * h;
    const float lsum = quad_sum(l[h]);
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      *reinterpret_cast<float2*>(&part.o[row][nd * 8 + tig * 2]) = make_float2(o[nd][2 * h], o[nd][2 * h + 1]);
    if (tig == 0) {
      part.m[row] = m[h];
      part.l[row] = lsum;
    }
  }
  cluster.sync();  // every rank's partial is written and visible to the cluster
  store_merged<DH>(cluster, part, out, lse, base, r0, n_rows, G, H);
  cluster.sync();  // this block's shared memory stays until every rank has read it
}

template <int DH>
int launch_fwd(const void* q, const void* k, const void* v, const void* q_seg, const void* kv_seg,
               void* out, void* lse, int B, int Lq, int Lkv, int H, int K, int q_offset, float scale,
               int splits, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<DH>();
  static const cudaError_t attr = allow_smem(gqa_fwd_kernel<DH>, smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Lq * (H / K) + kTile - 1) / kTile, B * K, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gqa_fwd_kernel<DH>, (const __nv_bfloat16*)q,
                                 (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
                                 (const int*)q_seg, (const int*)kv_seg, (__nv_bfloat16*)out,
                                 (float*)lse, Lq, Lkv, H, K, q_offset, scale);
}

}  // namespace

extern "C" int gqa_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                      const void* q_seg, const void* kv_seg, void* out,
                                      void* lse, int B, int Lq, int Lkv, int H, int K,
                                      int Dh, int q_offset, float scale, int splits, void* stream) {
  if (bad_shape(B, Lq, Lkv, H, K, q_offset) || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_fwd<64>(q, k, v, q_seg, kv_seg, out, lse, B, Lq, Lkv, H, K, q_offset, scale, splits, st);
  if (Dh == 128)
    return launch_fwd<128>(q, k, v, q_seg, kv_seg, out, lse, B, Lq, Lkv, H, K, q_offset, scale, splits, st);
  return (int)cudaErrorInvalidValue;
}

// Registers, local (spill) bytes per thread, dynamic shared memory bytes and
// resident blocks per SM of the kernel at Dh, in out[4].
extern "C" int gqa_attention_fwd_kernel_info(int Dh, int* out) {
  if (Dh == 64) return kernel_info(gqa_fwd_kernel<64>, fwd_smem<64>(), out);
  if (Dh == 128) return kernel_info(gqa_fwd_kernel<128>, fwd_smem<128>(), out);
  return (int)cudaErrorInvalidValue;
}
