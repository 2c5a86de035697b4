// Full segment sum (kernel K5).
//
// Replaces: randt_slam_tpu/ops/segment_moments.py `_segment_moments_pallas`
// (Pallas kernel `_kernel`), reached through `segment_moments`, the moment
// reduction behind `ndt/cells.from_points`.
//
//   out[s, c] = sum_p [ids[p] == s] * values[p, c],   s < S
//
// values are the per-point moment channels [w | w p | w p p^T (+ pNDT)]
// (13 channels); ids outside [0, S) are dropped.
//
// What bounds it on an H100: the function reads every value row and id once
// and writes the (S, CH) table once: (P (CH + 1) + S CH) * 4 bytes, 1.7 MB at
// an Oxford frame's 26,000 points and 3,249 cluster cells, ~0.5 us at
// 3.35 TB/s; the P * CH adds are negligible.  The TPU kernel contracted an
// on-the-fly (segment tile x point tile) one-hot against the values on the
// matrix unit: S * P * CH multiply-adds for an O(P CH) sum.
//
// Design: the wrapper orders the points by segment with a stable sort of the
// ids and finds each segment's run with a binary search (plain PyTorch,
// exact integer work), so this kernel touches each point once.  One warp per
// segment: its lanes stride over the segment's contiguous run of sorted
// positions in a fixed order, read the value rows through the permutation,
// and a fixed __shfl_down_sync tree reduces the 32 partial sums.  Empty
// segments write zeros.  No atomics, so two launches are bitwise equal.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 16;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_kernel(const float* __restrict__ values,
                   const int* __restrict__ perm,
                   const int* __restrict__ offsets,
                   float* __restrict__ out, int S, int CH) {
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= S) return;  // whole warps leave together
  const int begin = offsets[seg];
  const int end = offsets[seg + 1];

  float acc[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;

  for (int i = begin + lane; i < end; i += 32) {
    const float* row = values + static_cast<size_t>(perm[i]) * CH;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < CH) acc[c] += row[c];
    }
  }

#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
    }
  }
  if (lane == 0) {
    float* dst = out + static_cast<size_t>(seg) * CH;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c < CH) dst[c] = acc[c];
    }
  }
}

}  // namespace

// values (P, CH) float32 with CH <= 16; perm (P,) int32, the point order
// sorted by segment; offsets (S + 1,) int32, segment s owning sorted
// positions [offsets[s], offsets[s + 1]) -> out (S, CH) float32; all
// contiguous on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int segment_sum_f32(const float* values, const int* perm,
                               const int* offsets, float* out, int S, int CH,
                               void* stream) {
  if (CH < 1 || CH > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
    segment_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        values, perm, offsets, out, S, CH);
  }
  return static_cast<int>(cudaGetLastError());
}
