// Per-row contiguous window extraction (kernel K1).
//
// Replaces: randt_slam_tpu/ops/window_slice.py `_row_windows_pallas`
// (Pallas kernel `_kernel`), reached through `row_windows`.
//
//   out_img[a, w] = img[a, j],  out_rng[a, w] = rng_row[j],
//   j = clamp(starts[a] + w, 0, R - 1)
//
// The clamp is per element, as the JAX package's plain path does; inside the
// caller's contract (0 <= start, start + win <= R) it is the identity.
//
// What bounds it on an H100: nothing but launch latency.  One radar frame at
// the Oxford geometry moves ~0.2 MB in and ~0.2 MB out (400 rows x 65
// columns, two outputs), a fraction of a microsecond at 3.35 TB/s.  The TPU
// kernel had to load aligned 256-lane slabs and rotate them into place; on
// the GPU each thread simply reads its element.
//
// Design: one block per azimuth row, one thread per window column
// (win <= 1024, 65 on the main path).  Neighbouring threads read neighbouring
// addresses of one row, so each row's window is one or two coalesced
// transactions.  Fusing the window into the rest of the scan filter is later
// work; this kernel is right and simple first.

#include <cuda_runtime.h>

namespace {

__global__ void row_windows_kernel(const float* __restrict__ img,
                                   const float* __restrict__ rng_row,
                                   const int* __restrict__ starts,
                                   float* __restrict__ out_img,
                                   float* __restrict__ out_rng,
                                   int R, int win) {
  const int a = blockIdx.x;
  const int w = threadIdx.x;
  if (w >= win) return;
  int j = starts[a] + w;
  j = j < 0 ? 0 : (j > R - 1 ? R - 1 : j);
  const size_t o = static_cast<size_t>(a) * win + w;
  out_img[o] = img[static_cast<size_t>(a) * R + j];
  out_rng[o] = rng_row[j];
}

}  // namespace

// img (A, R), rng_row (R,), starts (A,) int32 -> out_img, out_rng (A, win);
// all contiguous float32 on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int row_windows_f32(const float* img, const float* rng_row,
                               const int* starts, float* out_img,
                               float* out_rng, int A, int R, int win,
                               void* stream) {
  if (A > 0 && win > 0) {
    row_windows_kernel<<<A, win, 0, static_cast<cudaStream_t>(stream)>>>(
        img, rng_row, starts, out_img, out_rng, R, win);
  }
  return static_cast<int>(cudaGetLastError());
}
