// Moment pass of the fused segment-sum + top-k compaction (kernel K2).
//
// Replaces: randt_slam_tpu/ops/segment_moments.py `_topi_moments_pallas`
// (Pallas kernel `_topi_kernel`), reached through `segment_topk_moments`.
//
//   out[s, c] = sum_p [ids[p] == topi[s]] * values[p, c],   s < k
//
// values are the per-point moment channels [w | w p | w p p^T (+ pNDT)]
// (13 channels); topi lists the k most-populated segments; points outside
// every segment carry id -1.
//
// What bounds it on an H100: reading the ids once and the value rows of the
// points in the kept segments once is about 0.2 MB at the Oxford geometry
// (26,000 ids, a few thousand kept rows of 13 channels), ~0.07 us at
// 3.35 TB/s; the arithmetic is negligible.  The TPU kernel contracted a
// one-hot (k x P) tile against the values on the matrix unit; that is
// k*P*13 multiply-adds (~0.35 GFLOP) for the same result.  This kernel
// still compares every id with every kept segment (k*P compares, 13.3 M at
// k = 512, P = 26,000), but in registers, and reads a value row only where
// it matches.  What is left above the launch is the L2 traffic of every
// block reading all the ids (128 x 104 KB at the Oxford shape), a fixed
// cost of the block's first loads and its fold, and the round trips of the
// matched rows (PERF.md).
//
// A batch of B scans is a second grid axis: block (x, b) takes ranks
// x * kGroup ... of scan b and reads only that scan's ids and rows, so the
// work grows as B, not as B^2 (which one flat set of B * P ids and B * k
// segments would cost: every block would scan every scan's ids).
//
// Design: each block owns kGroup consecutive kept ranks, whose segment ids
// it keeps in registers (128 blocks at k = 512: one wave on 132 SMs).  Its
// 512 threads read the ids once, kBatch loads in flight per thread, and
// compare each id with the kGroup targets; the matches of a batch then have
// their value rows added into the thread's kGroup x 16 register sums, in
// point order, through one code site (the loop over the ids stays rolled).
// The sums are then folded over each warp by the transposing shuffle fold
// of warp_fold.cuh and over the block's warps in order through shared
// memory.  No atomics, so two launches give bitwise-identical output.

#include <cuda_runtime.h>

#include "warp_fold.cuh"

namespace {

constexpr int kMaxChannels = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // kept ranks per block
constexpr int kBatch = 32;  // id loads in flight per thread
constexpr int kTerms = kGroup * kMaxChannels;

__global__ void __launch_bounds__(kThreads)
topi_moments_kernel(const float* __restrict__ values,
                    const int* __restrict__ ids,
                    const int* __restrict__ topi,
                    float* __restrict__ out, int P, int CH, int k) {
  __shared__ float warp_part[kWarps][kTerms];
  // this block's scan of the batch
  values += static_cast<size_t>(blockIdx.y) * P * CH;
  ids += static_cast<size_t>(blockIdx.y) * P;
  topi += static_cast<size_t>(blockIdx.y) * k;
  out += static_cast<size_t>(blockIdx.y) * k * CH;
  const int s0 = blockIdx.x * kGroup;
  const int t = threadIdx.x;
  const int lane = t % 32;

  // the block's targets; a rank past k repeats the last and is not written
  int seg[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) seg[g] = topi[min(s0 + g, k - 1)];

  float acc[kTerms];
#pragma unroll
  for (int j = 0; j < kTerms; ++j) acc[j] = 0.0f;

  auto hit = [&](int id) {
    bool h = false;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) h |= id == seg[g];
    return h;
  };
  // add row p to the sums of every target its id equals
  auto add = [&](int p, int id) {
    const float* row = values + static_cast<size_t>(p) * CH;
    float r[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) r[c] = c < CH ? row[c] : 0.0f;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (id == seg[g]) {
#pragma unroll
        for (int c = 0; c < kMaxChannels; ++c) acc[g * kMaxChannels + c] += r[c];
      }
    }
  };

  // thread t takes the points p = t, t + kThreads, ..., kBatch loads at a
  // time (a run of consecutive points in one segment spreads over the
  // lanes, so its rows are read side by side); the matches of a batch are
  // then added in point order, through one code site
  for (int p0 = t; p0 < P; p0 += kThreads * kBatch) {
    int x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * kThreads;
      x[u] = p < P ? ids[p] : 0;
    }
    unsigned hits = 0;  // bit u: point p0 + u kThreads matched
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (p0 + u * kThreads < P && hit(x[u])) hits |= 1u << u;
    }
    while (hits != 0) {
      const int u = __ffs(hits) - 1;
      hits &= hits - 1;
      const int p = p0 + u * kThreads;
      add(p, ids[p]);
    }
  }

  // warp: the transposing fold; then the block's warps in order
  float sum[fold_width(kTerms, 16)];
  int base, held;
  warp_fold<kTerms, 16>(acc, lane, 0, kTerms, sum, base, held);
#pragma unroll
  for (int j = 0; j < fold_width(kTerms, 16); ++j) {
    if (j < held) warp_part[t / 32][base + j] = sum[j];
  }
  __syncthreads();
  if (t < kTerms) {
    const int g = t / kMaxChannels, c = t % kMaxChannels;
    if (s0 + g < k && c < CH) {
      float tot = warp_part[0][t];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tot += warp_part[w][t];
      out[static_cast<size_t>(s0 + g) * CH + c] = tot;
    }
  }
}

static_assert(kBatch <= 32, "one bit per id of a batch");
static_assert(kTerms <= kThreads, "one thread per output of the block");

}  // namespace

// values (B, P, CH) float32 with CH <= 16, ids (B, P) int32, topi (B, k)
// int32 -> out (B, k, CH) float32; all contiguous on the device.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int topi_moments_f32(const float* values, const int* ids,
                                const int* topi, float* out, int B, int P,
                                int CH, int k, void* stream) {
  if (CH < 1 || CH > kMaxChannels || B < 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k > 0 && B > 0) {
    const dim3 grid((k + kGroup - 1) / kGroup, B);
    topi_moments_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        values, ids, topi, out, P, CH, k);
  }
  return static_cast<int>(cudaGetLastError());
}
