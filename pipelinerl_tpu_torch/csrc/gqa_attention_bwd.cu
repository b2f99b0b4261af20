// Packed-row causal GQA flash attention, backward, for sm_90a: dq and dk/dv.
//
// Replaces the JAX package's Pallas kernels `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` in pipelinerl_tpu/ops/gqa_attention.py (reached through
// `_bwd_call` from the custom VJP of `mha_packed_gqa`). Contract, the same
// as the forward's (csrc/gqa_attention_fwd.cu): q/dO [B, Lq, H, Dh], k/v
// [B, Lkv, K, Dh] in bf16; query i sees key j iff q_offset + i >= j and
// q_seg[i] == kv_seg[j]; lse [B, Lq, K, G] and delta = rowsum(dO * O) in the
// same layout, fp32. For every visible pair:
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
// Design:
// - dq: one block per 64 folded (position, head) rows of one (batch, kv
//   head), as the forward folds the G = H/K query heads into the rows; each
//   of the 4 warps owns 16 rows and keeps its Q and dO fragments in
//   registers; the loop over 64-key tiles stops at the causal bound and
//   skips tiles whose segment-id range does not overlap the block's;
// - dk/dv: one block per 64 keys of one (batch, kv head); each warp owns 16
//   keys and keeps its K and V fragments in registers, computing S^T = K Q^T
//   and dP^T = V dO^T directly, so P^T and dS^T are A operands in registers;
//   the loop over folded q tiles starts at the first tile that can see the
//   block's keys and skips segment-disjoint tiles. All G heads of a key are
//   summed inside the block: no atomics, deterministic results;
// - bf16 mma.sync m16n8k16 with fp32 accumulation throughout; operands that
//   must be read along the other axis are stored transposed in shared
//   memory, rows padded by 8 bf16, so every fragment is one conflict-free
//   32-bit load;
// - ragged edges (Lq * G and Lkv not multiples of the tiles) are masked in
//   the kernels, so every length runs here.
// A first, simple version: no cp.async/TMA pipelining, no wgmma. The dk/dv
// grid has only Lkv / 64 * B * K blocks (128 at the training row, on 132
// SMs), each walking every q tile serially at one block per SM (243
// registers); splitting the q loop over blocks is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // dq: folded rows per block and keys per tile; dk/dv: keys per block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row major) of columns [16 kk, 16 kk + 16) from the C
// fragments of two adjacent 8-column mma tiles, rounded to bf16
__device__ __forceinline__ void c_to_a(float (*c)[4], int kk, uint32_t* a) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// min and max of ids[lo..hi] (inclusive), the same on every lane of the warp
__device__ __forceinline__ void warp_range(const int* ids, int lo, int hi, int& mn, int& mx) {
  mn = INT32_MAX;
  mx = INT32_MIN;
  for (int i = lo + threadIdx.x % 32; i <= hi; i += 32) {
    mn = min(mn, ids[i]);
    mx = max(mx, ids[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <int DH>
struct DqSmem {
  __nv_bfloat16 k[kTile][DH + 8];   // [key][d]: B of S = Q K^T
  __nv_bfloat16 v[kTile][DH + 8];   // [key][d]: B of dP = dO V^T
  __nv_bfloat16 kt[DH][kTile + 8];  // [d][key]: B of dQ = dS K
  int kseg[kTile];
};

template <int DH>
__global__ void __launch_bounds__(kThreads) gqa_bwd_dq_kernel(
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
  DqSmem<DH>& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);
  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n_rows = Lq * G;
  const int r0 = blockIdx.x * kTile;
  const int i_lo = r0 / G, i_hi = min(r0 + kTile - 1, n_rows - 1) / G;
  const int* qs = qseg + (int64_t)b * Lq;
  const int* ks = kseg + (int64_t)b * Lkv;

  // this thread's two rows (fragment rows gid and gid + 8 of its warp)
  int row_i[2], row_seg[2];
  bool row_ok[2];
  float row_lse[2], row_delta[2];
  int64_t row_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + gid + 8 * h;
    row_ok[h] = r < n_rows;
    row_i[h] = row_ok[h] ? r / G : 0;
    const int g = row_ok[h] ? r % G : 0;
    row_seg[h] = qs[row_i[h]];
    const int64_t li = (((int64_t)b * Lq + row_i[h]) * K + kh) * G + g;
    row_lse[h] = row_ok[h] ? lse[li] : 0.f;
    row_delta[h] = row_ok[h] ? delta[li] : 0.f;
    row_off[h] = (((int64_t)b * Lq + row_i[h]) * H + kh * G + g) * DH;
  }

  // Q and dO fragments for every 16-wide slice of DH, straight from memory
  uint32_t qa[DH / 16][4], da[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t o = row_off[h] + kk * 16 + tig * 2;
      qa[kk][h] = row_ok[h] ? ld32(q + o) : 0u;
      qa[kk][h + 2] = row_ok[h] ? ld32(q + o + 8) : 0u;
      da[kk][h] = row_ok[h] ? ld32(dout + o) : 0u;
      da[kk][h + 2] = row_ok[h] ? ld32(dout + o + 8) : 0u;
    }
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.f;

  int q_mn, q_mx;
  warp_range(qs, i_lo, i_hi, q_mn, q_mx);
  const int kv_end = min(Lkv, q_offset + i_hi + 1);  // causal bound of the last row

  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    const int n_kv = min(kTile, Lkv - kv0);
    int k_mn, k_mx;
    warp_range(ks, kv0, kv0 + n_kv - 1, k_mn, k_mx);
    if (q_mx < k_mn || q_mn > k_mx) continue;  // uniform over the block

    __syncthreads();  // the previous tile is fully consumed
    constexpr int kChunks = DH / 8;
    for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 kk4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (r < n_kv) {
        const int64_t off = (((int64_t)b * Lkv + kv0 + r) * K + kh) * DH + col;
        kk4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&sm.k[r][col]) = kk4;
      *reinterpret_cast<uint4*>(&sm.v[r][col]) = vv4;
      const __nv_bfloat16* kh8 = reinterpret_cast<const __nv_bfloat16*>(&kk4);
#pragma unroll
      for (int e = 0; e < 8; ++e) sm.kt[col + e][r] = kh8[e];
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads) sm.kseg[r] = r < n_kv ? ks[kv0 + r] : 0;
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and the tile's keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kr = &sm.k[nt * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
        const __nv_bfloat16* vr = &sm.v[nt * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(dp[nt], da[kk], ld32(vr), ld32(vr + 8));
      }
    }

    // dS = P (dP - delta), P recomputed from lse where the mask holds
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c / 2;
        const int kj = nt * 8 + tig * 2 + (c & 1);
        const bool ok = row_ok[h] && kj < n_kv && q_offset + row_i[h] >= kv0 + kj &&
                        row_seg[h] == sm.kseg[kj];
        const float p = ok ? expf(s[nt][c] * scale - row_lse[h]) : 0.f;
        s[nt][c] = p * (dp[nt][c] - row_delta[h]);
      }

    // dQ += dS K, with dS rounded to bf16 as the TPU kernel does
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      c_to_a(s, kk, a);
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const __nv_bfloat16* kr = &sm.kt[nd * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(acc[nd], a, ld32(kr), ld32(kr + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dq + row_off[h] + nd * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[nd][2 * h] * scale, acc[nd][2 * h + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dk / dv
// ---------------------------------------------------------------------------

template <int DH, int QR>
struct DkvSmem {
  __nv_bfloat16 q[QR][DH + 8];     // [row][d]: B of S^T = K Q^T
  __nv_bfloat16 dout[QR][DH + 8];  // [row][d]: B of dP^T = V dO^T
  __nv_bfloat16 qt[DH][QR + 8];    // [d][row]: B of dK = dS^T Q
  __nv_bfloat16 dot[DH][QR + 8];   // [d][row]: B of dV = P^T dO
  float lse[QR];
  float delta[QR];
  int pos[QR];  // global index q_offset + i of the row's position; -1 past the end
  int seg[QR];
};

template <int DH, int QR>
__global__ void __launch_bounds__(kThreads) gqa_bwd_dkv_kernel(
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<DH, QR>& sm = *reinterpret_cast<DkvSmem<DH, QR>*>(smem_raw);
  const int G = H / K;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kv0 = blockIdx.x * kTile;
  const int n_kv = min(kTile, Lkv - kv0);
  const int n_rows = Lq * G;
  const int* qs = qseg + (int64_t)b * Lq;
  const int* ks = kseg + (int64_t)b * Lkv;

  // this thread's two keys (fragment rows gid and gid + 8 of its warp)
  int key_pos[2], key_seg[2];
  bool key_ok[2];
  int64_t key_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = warp * 16 + gid + 8 * h;
    key_ok[h] = j < n_kv;
    key_pos[h] = kv0 + (key_ok[h] ? j : 0);
    key_seg[h] = ks[key_pos[h]];
    key_off[h] = (((int64_t)b * Lkv + key_pos[h]) * K + kh) * DH;
  }

  // K and V fragments as A operands, straight from memory
  uint32_t ka[DH / 16][4], va[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t o = key_off[h] + kk * 16 + tig * 2;
      ka[kk][h] = key_ok[h] ? ld32(k + o) : 0u;
      ka[kk][h + 2] = key_ok[h] ? ld32(k + o + 8) : 0u;
      va[kk][h] = key_ok[h] ? ld32(v + o) : 0u;
      va[kk][h + 2] = key_ok[h] ? ld32(v + o + 8) : 0u;
    }
  }

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[nd][c] = dv_acc[nd][c] = 0.f;

  int k_mn, k_mx;
  warp_range(ks, kv0, kv0 + n_kv - 1, k_mn, k_mx);
  const int n_qt = (n_rows + QR - 1) / QR;
  // tiles before t0 hold only positions before kv0: causally blind to it
  const int t0 = kv0 > q_offset ? (int)(((int64_t)(kv0 - q_offset) * G) / QR) : 0;

  for (int t = t0; t < n_qt; ++t) {
    const int r0 = t * QR;
    const int i_lo = r0 / G, i_hi = min(r0 + QR - 1, n_rows - 1) / G;
    int q_mn, q_mx;
    warp_range(qs, i_lo, i_hi, q_mn, q_mx);
    if (q_mx < k_mn || q_mn > k_mx) continue;  // uniform over the block

    __syncthreads();  // the previous tile is fully consumed
    constexpr int kChunks = DH / 8;
    for (int c = threadIdx.x; c < QR * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const int rr = r0 + r;
      uint4 q4 = make_uint4(0, 0, 0, 0), d4 = make_uint4(0, 0, 0, 0);
      if (rr < n_rows) {
        const int64_t off = (((int64_t)b * Lq + rr / G) * H + kh * G + rr % G) * DH + col;
        q4 = *reinterpret_cast<const uint4*>(q + off);
        d4 = *reinterpret_cast<const uint4*>(dout + off);
      }
      *reinterpret_cast<uint4*>(&sm.q[r][col]) = q4;
      *reinterpret_cast<uint4*>(&sm.dout[r][col]) = d4;
      const __nv_bfloat16* q8 = reinterpret_cast<const __nv_bfloat16*>(&q4);
      const __nv_bfloat16* d8 = reinterpret_cast<const __nv_bfloat16*>(&d4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sm.qt[col + e][r] = q8[e];
        sm.dot[col + e][r] = d8[e];
      }
    }
    for (int r = threadIdx.x; r < QR; r += kThreads) {
      const int rr = r0 + r;
      if (rr < n_rows) {
        const int i = rr / G;
        const int64_t li = (((int64_t)b * Lq + i) * K + kh) * G + rr % G;
        sm.lse[r] = lse[li];
        sm.delta[r] = delta[li];
        sm.pos[r] = q_offset + i;
        sm.seg[r] = qs[i];
      } else {
        sm.lse[r] = 0.f;
        sm.delta[r] = 0.f;
        sm.pos[r] = -1;
        sm.seg[r] = 0;
      }
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and the tile's rows
    float st[QR / 8][4], dpt[QR / 8][4];
#pragma unroll
    for (int nt = 0; nt < QR / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) st[nt][c] = dpt[nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* qr = &sm.q[nt * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(st[nt], ka[kk], ld32(qr), ld32(qr + 8));
        const __nv_bfloat16* dr = &sm.dout[nt * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(dpt[nt], va[kk], ld32(dr), ld32(dr + 8));
      }
    }

    // P^T where the mask holds, dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int nt = 0; nt < QR / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c / 2;
        const int r = nt * 8 + tig * 2 + (c & 1);
        const bool ok = key_ok[h] && sm.pos[r] >= key_pos[h] && sm.seg[r] == key_seg[h];
        const float p = ok ? expf(st[nt][c] * scale - sm.lse[r]) : 0.f;
        st[nt][c] = p;
        dpt[nt][c] = p * (dpt[nt][c] - sm.delta[r]);
      }

    // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16
#pragma unroll
    for (int kk = 0; kk < QR / 16; ++kk) {
      uint32_t pa[4], sa[4];
      c_to_a(st, kk, pa);
      c_to_a(dpt, kk, sa);
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const __nv_bfloat16* dr = &sm.dot[nd * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(dv_acc[nd], pa, ld32(dr), ld32(dr + 8));
        const __nv_bfloat16* qr = &sm.qt[nd * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(dk_acc[nd], sa, ld32(qr), ld32(qr + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!key_ok[h]) continue;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int64_t o = key_off[h] + nd * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + o) =
          __floats2bfloat162_rn(dk_acc[nd][2 * h] * scale, dk_acc[nd][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o) =
          __floats2bfloat162_rn(dv_acc[nd][2 * h], dv_acc[nd][2 * h + 1]);
    }
  }
}

// Dynamic shared memory above 48 KB needs the attribute set once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* q_seg, const void* kv_seg, void* dq, int B, int Lq,
              int Lkv, int H, int K, int q_offset, float scale, cudaStream_t st) {
  static const cudaError_t attr = allow_smem(gqa_bwd_dq_kernel<DH>, sizeof(DqSmem<DH>));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Lq * (H / K) + kTile - 1) / kTile, B * K);
  gqa_bwd_dq_kernel<DH><<<grid, kThreads, sizeof(DqSmem<DH>), st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta, (const int*)q_seg,
      (const int*)kv_seg, (__nv_bfloat16*)dq, Lq, Lkv, H, K, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int DH, int QR>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* q_seg, const void* kv_seg, void* dk, void* dv,
               int B, int Lq, int Lkv, int H, int K, int q_offset, float scale, cudaStream_t st) {
  static const cudaError_t attr =
      allow_smem(gqa_bwd_dkv_kernel<DH, QR>, sizeof(DkvSmem<DH, QR>));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((Lkv + kTile - 1) / kTile, B * K);
  gqa_bwd_dkv_kernel<DH, QR><<<grid, kThreads, sizeof(DkvSmem<DH, QR>), st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta, (const int*)q_seg,
      (const int*)kv_seg, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Lq, Lkv, H, K, q_offset,
      scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Lq, int Lkv, int H, int K) {
  return B <= 0 || Lq <= 0 || Lkv <= 0 || K <= 0 || H % K != 0;
}

}  // namespace

extern "C" int gqa_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* q_seg, const void* kv_seg, void* dq, int B,
                                         int Lq, int Lkv, int H, int K, int Dh, int q_offset,
                                         float scale, void* stream) {
  if (bad_shape(B, Lq, Lkv, H, K)) return (int)cudaErrorInvalidValue;
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
                                          int q_offset, float scale, void* stream) {
  if (bad_shape(B, Lq, Lkv, H, K)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Dh 128 takes 32-row q tiles, so its fragments and sums fit the registers
  if (Dh == 64)
    return launch_dkv<64, 64>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B, Lq, Lkv, H,
                              K, q_offset, scale, st);
  if (Dh == 128)
    return launch_dkv<128, 32>(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, B, Lq, Lkv, H,
                               K, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
