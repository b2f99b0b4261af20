// The tile schedule and shared pieces of the packed GQA attention kernels
// for sm_90a: the forward (#2, gqa_attention_fwd.cu) and the backward's dq
// (#3) and dk/dv (#4, gqa_attention_bwd.cu).
//
// A block owns one tile of 64 on its own axis: 64 folded (position, head)
// q rows (#2, #3) or 64 keys (#4). Before it walks the other axis it finds
// the span of tiles there that can see its own: one block-wide scan of the
// int32 segment ids (L2-resident, 8 independent loads a thread in flight).
// The kernels then walk only that span and test each tile's ids as it
// lands, so unsorted ids stay exact. #2 and #3 share one q tile and so one
// span (`dq_span`); ops/gqa_attention.bwd_tile_spans_plain is the plain
// version of both spans, and `gqa_attention_bwd_schedule` writes them.

#pragma once

#include "sm90_helpers.cuh"

namespace {

constexpr int kTile = 64;  // folded q rows of a #2/#3 block and keys per tile; keys of a #4 block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 8;  // blocks per cluster at most, the portable cluster size
constexpr float kLog2e = 1.4426950408889634f;

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

// The first and last position p in [lo, hi] with ids[p] in [mn, mx], the
// same on every thread of the block; last = -1 when there is none. Every
// thread of the block must call it.
__device__ __forceinline__ int2 block_match(const int* ids, int lo, int hi, int mn, int mx) {
  constexpr int kBatch = 8;  // loads each thread keeps in flight
  __shared__ int red[2][kWarps];
  int first = INT32_MAX, last = -1;
  for (int base = lo + (int)threadIdx.x; base <= hi; base += kBatch * kThreads) {
    int s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = base + u * kThreads;
      s[u] = p <= hi ? __ldg(ids + p) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = base + u * kThreads;
      if ((p <= hi) & (s[u] >= mn) & (s[u] <= mx)) {
        first = min(first, p);
        last = max(last, p);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  }
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = first;
    red[1][threadIdx.x / 32] = last;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first = min(first, red[0][w]);
    last = max(last, red[1][w]);
  }
  __syncthreads();  // red is free for the next call
  return make_int2(first, last);
}

// The span of a q tile (#2 and #3): the key tiles [first, last] that folded
// q rows [r0, r_end] of one batch row can see (those holding the first and
// last key j <= q_offset + the last position whose id lies in the rows'
// [min, max]), and the rows' id range; {0, -1} when none
__device__ __forceinline__ int2 dq_span(const int* qs, const int* ks, int r0, int r_end, int G,
                                        int Lkv, int q_offset, int& q_mn, int& q_mx) {
  const int i_hi = r_end / G;
  warp_range(qs, r0 / G, i_hi, q_mn, q_mx);
  const int2 m = block_match(ks, 0, min(Lkv - 1, q_offset + i_hi), q_mn, q_mx);
  return m.y < 0 ? make_int2(0, -1) : make_int2(m.x / kTile, m.y / kTile);
}

// The tiles [begin, end) of inclusive span [first, last] that block `rank`
// of a cluster of S walks (#2: a q tile's key span, #4: a key tile's q
// span); ops/gqa_attention.rank_share is the same partition
__device__ __forceinline__ int2 rank_share(int2 span, int rank, int S) {
  const int n = span.y - span.x + 1;
  return make_int2(span.x + rank * n / S, span.x + (rank + 1) * n / S);
}

// Dynamic shared memory above 48 KB needs the attribute set once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Registers, local (spill) bytes per thread, dynamic shared memory bytes and
// resident blocks per SM of `kernel` at kThreads, in out[4]
template <typename Kernel>
int kernel_info(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  return 0;
}

bool bad_shape(int B, int Lq, int Lkv, int H, int K, int q_offset) {
  return B <= 0 || Lq <= 0 || Lkv <= 0 || K <= 0 || H % K != 0 || q_offset < 0;
}

}  // namespace
