// Per-row contiguous window extraction (kernel K1).
//
// Replaces: randt_slam_tpu/ops/window_slice.py `_row_windows_pallas`
// (Pallas kernel `_kernel`), reached through `row_windows`.
//
//   out_img[a, w] = img[a, j],  out_rng[a, w] = rng_row[j],
//   j = clamp(starts[a] + w, 0, R - 1)
//
// Over a batch of B scans the rows of all of them are one grid: row a of
// the B * A reads the range row of its own scan, a / A (the Pallas kernel
// gains a grid axis over the batch under vmap).
//
// The clamp is per element, as the JAX package's plain path does; inside the
// caller's contract (0 <= start, start + win <= R) it is the identity.
//
// What bounds it on an H100: nothing but launch latency.  One radar frame at
// the Oxford geometry moves ~0.2 MB in and ~0.2 MB out (400 rows x 65
// columns, two outputs), a fraction of a microsecond at 3.35 TB/s.  The TPU
// kernel had to load aligned 256-lane slabs and rotate them into place; on
// the GPU each lane simply reads its elements.
//
// Design: one warp per row, kRows rows per block.  The row start is read
// once per warp, as the int64 that torch.argmax returns (so the caller
// launches no cast), and broadcast by a shuffle; lane l then takes columns
// l, l + 32, l + 64, ..., kPerLane of them at a time, issuing all their
// loads before any store.  Neighbouring lanes read neighbouring addresses
// of one row, so each row's window is a few coalesced transactions.  What
// is left is two dependent loads (the start, then the pixels) behind the
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;     // rows (warps) per block
constexpr int kPerLane = 4;  // columns a lane loads before it stores

__global__ void __launch_bounds__(kRows * 32)
row_windows_kernel(const float* __restrict__ img,
                   const float* __restrict__ rng_row,
                   const long long* __restrict__ starts,
                   float* __restrict__ out_img, float* __restrict__ out_rng,
                   int rows, int A, int R, int win) {
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (a >= rows) return;  // whole warps leave together
  long long start = lane == 0 ? starts[a] : 0;
  start = __shfl_sync(0xffffffffu, start, 0);
  const float* row = img + static_cast<size_t>(a) * R;
  rng_row += static_cast<size_t>(a / A) * R;  // this row's scan
  float* oi = out_img + static_cast<size_t>(a) * win;
  float* orng = out_rng + static_cast<size_t>(a) * win;
  for (int w0 = lane; w0 < win; w0 += 32 * kPerLane) {
    float vi[kPerLane], vr[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int w = w0 + 32 * u;
      if (w < win) {
        long long j = start + w;
        j = j < 0 ? 0 : (j > R - 1 ? R - 1 : j);
        vi[u] = row[j];
        vr[u] = rng_row[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int w = w0 + 32 * u;
      if (w < win) {
        oi[w] = vi[u];
        orng[w] = vr[u];
      }
    }
  }
}

}  // namespace

// img (B, A, R), rng_row (B, R) float32, starts (B, A) int64 -> out_img,
// out_rng (B, A, win) float32; all contiguous on the device.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int row_windows_f32(const float* img, const float* rng_row,
                               const long long* starts, float* out_img,
                               float* out_rng, int B, int A, int R, int win,
                               void* stream) {
  if (B < 0 || A < 0 || R < 1 || win < 0 ||
      static_cast<long long>(B) * A > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = B * A;
  if (rows > 0 && win > 0) {
    row_windows_kernel<<<(rows + kRows - 1) / kRows, kRows * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        img, rng_row, starts, out_img, out_rng, rows, A, R, win);
  }
  return static_cast<int>(cudaGetLastError());
}
