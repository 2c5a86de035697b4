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
// What bounds it on an H100: reading the values once is 1.35 MB at the
// Oxford geometry (26,000 points x 13 channels), ~0.4 us at 3.35 TB/s; the
// arithmetic is negligible.  The TPU kernel contracted a one-hot
// (k x P) tile against the values on the matrix unit; that is k*P*13
// multiply-adds (~0.35 GFLOP) for the same result.  This kernel does the same
// work, k*P compares of ids (104 KB, resident in L2 after the first blocks),
// but only reads the value rows that match, so it is far from the byte bound
// and set by the k*P compares; a sort-based segmented reduction that touches
// each point once is later work.
//
// Design: one block per kept segment rank s.  Its threads stride over the P
// points in a fixed order and accumulate the channels of the points whose id
// is topi[s]; a shared-memory tree then reduces the per-thread partial sums
// in a fixed order.  No atomics, so two launches give bitwise-identical
// output.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
topi_moments_kernel(const float* __restrict__ values,
                    const int* __restrict__ ids,
                    const int* __restrict__ topi,
                    float* __restrict__ out, int P, int CH) {
  __shared__ float red[kMaxChannels][kThreads];
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int seg = topi[s];

  float acc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;

  for (int p = t; p < P; p += kThreads) {
    if (ids[p] == seg) {
      const float* row = values + static_cast<size_t>(p) * CH;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < CH) acc[c] += row[c];
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) red[c][t] = acc[c];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) red[c][t] += red[c][t + stride];
    }
    __syncthreads();
  }
  if (t < CH) out[static_cast<size_t>(s) * CH + t] = red[t][0];
}

}  // namespace

// values (P, CH) float32 with CH <= 16, ids (P,) int32, topi (k,) int32
// -> out (k, CH) float32; all contiguous on the device.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int topi_moments_f32(const float* values, const int* ids,
                                const int* topi, float* out, int P, int CH,
                                int k, void* stream) {
  if (CH < 1 || CH > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  if (k > 0) {
    topi_moments_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        values, ids, topi, out, P, CH);
  }
  return static_cast<int>(cudaGetLastError());
}
