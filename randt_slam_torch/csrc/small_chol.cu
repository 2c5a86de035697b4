// Damped SPD solve of the window smoother's normal equations (kernel K4).
//
// Replaces: randt_slam_tpu/ops/small_chol.py `chol_solve` (Pallas kernel
// `_chol_solve_kernel`).
//
//   A x = b,  A (P, P) symmetric positive definite, P = (W + 1) * 9 = 36
//
// The LM loop hands it the Jacobi-scaled, damped system (active diagonals
// 1 + lambda, frozen parameters exact identity rows), so the unpivoted
// Cholesky is stable.  Unblocked right-looking Cholesky, L[:, j] =
// A[:, j] * rsqrt(max(A[j, j], 1e-30)) on rows >= j, then the trailing
// update A[j+1:, j+1:] -= L[j+1:, j] L[j+1:, j]^T, as the TPU kernel does;
// then forward (L y = b) and back (L^T x = y) substitution.
//
// What bounds it on an H100: nothing but latency.  One system moves its
// lower triangle, b and x, (P (P + 1) / 2 + 2P) * 4 B = 2,952 B (0.9 ns at
// 3.35 TB/s; the upper triangle is never read), and needs ~P^3/3
// multiply-adds (~0.5 ns at 67 TFLOP/s); P sequential column steps, each a
// shared-memory round and a barrier, set its time.  The TPU kernel masked
// whole (P, P) tiles per step because its vector unit has no scalar
// indexing; here the matrix sits in shared memory (5 KB at P = 36) and the
// block's threads update the trailing submatrix element by element.
//
// Design: one block per system, with a leading batch dimension B >= 1 (the
// counterpart of a vmap over the TPU kernel; B = 1 on the odometry path).
// The factor overwrites the lower triangle in place.  The substitutions are
// sequential in j; warp 0 forms each dot product with a fixed xor-shuffle
// tree, so every lane holds the same bits and the result is reproducible.
// Built without fast math: rsqrtf and the divisions are not approximated.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 64;
constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, int P) {
  __shared__ float sA[kMaxP * kMaxP];
  __shared__ float lcol[kMaxP];
  __shared__ float sy[kMaxP];
  __shared__ float sx[kMaxP];
  const int t = threadIdx.x;
  const float* Ab = A + static_cast<size_t>(blockIdx.x) * P * P;
  const float* bb = b + static_cast<size_t>(blockIdx.x) * P;
  float* xb = x + static_cast<size_t>(blockIdx.x) * P;

  for (int i = t; i < P * P; i += kThreads) sA[i] = Ab[i];
  __syncthreads();

  // ---- Cholesky, column j per step; L overwrites the lower triangle -------
  for (int j = 0; j < P; ++j) {
    const float ajj = sA[j * P + j];
    const float d = rsqrtf(ajj < 1e-30f ? 1e-30f : ajj);
    for (int i = t; i < P; i += kThreads) lcol[i] = i >= j ? sA[i * P + j] * d : 0.0f;
    __syncthreads();
    // column j of L into the lower triangle, and the trailing update
    for (int idx = t; idx < P * P; idx += kThreads) {
      const int r = idx / P;
      const int c = idx - r * P;
      if (c == j && r >= j) {
        sA[idx] = lcol[r];
      } else if (r > j && c > j) {
        sA[idx] -= lcol[r] * lcol[c];
      }
    }
    __syncthreads();
  }

  // ---- substitutions, warp 0 -----------------------------------------------
  if (t < 32) {
    for (int j = 0; j < P; ++j) {  // L y = b
      float acc = 0.0f;
      for (int k = t; k < j; k += 32) acc += sA[j * P + k] * sy[k];
      acc = warp_sum(acc);
      if (t == 0) sy[j] = (bb[j] - acc) / sA[j * P + j];
      __syncwarp();
    }
    for (int j = P - 1; j >= 0; --j) {  // L^T x = y
      float acc = 0.0f;
      for (int k = j + 1 + t; k < P; k += 32) acc += sA[k * P + j] * sx[k];
      acc = warp_sum(acc);
      if (t == 0) sx[j] = (sy[j] - acc) / sA[j * P + j];
      __syncwarp();
    }
    for (int i = t; i < P; i += 32) xb[i] = sx[i];
  }
}

}  // namespace

// A (B, P, P), b (B, P) float32 contiguous on the device, 1 <= P <= 64 ->
// x (B, P).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int chol_solve_f32(const float* A, const float* b, float* x, int B,
                              int P, void* stream) {
  if (B < 0 || P < 1 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    chol_solve_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        A, b, x, P);
  }
  return static_cast<int>(cudaGetLastError());
}
