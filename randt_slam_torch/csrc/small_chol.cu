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
// then forward (L y = b) and back (L^T x = y) substitution.  Only the lower
// triangle of A is read.
//
// What bounds it on an H100: the dependent chain.  One system moves its
// lower triangle, b and x, (P (P + 1) / 2 + 2P) * 4 B = 2,952 B (0.9 ns at
// 3.35 TB/s), and needs ~P^3/3 multiply-adds (~0.5 ns at 67 TFLOP/s); but
// the factorization is P columns in a row, each a chain of multiply-adds, a
// pivot broadcast and an rsqrt before the next column can start, and the
// back substitution is P steps in a row, each a multiply and a broadcast.
// The TPU kernel masked whole (P, P) tiles per step because its vector unit
// has no scalar indexing.
//
// Design: one warp per system, no block-wide barrier (a block is the one
// warp; __syncwarp orders its shared-memory steps).  The lower triangle of
// A, with b as one more row P, is copied into the warp's shared memory by
// asynchronous copies that are all in flight at once.  Lane i owns rows i,
// i + 32 and i + 64 (as far as P + 1 rows need) and writes nothing else.
// Column j (left-looking): each lane forms its own row's
// a_ij - sum_k<j L_ik L_jk, k ascending, which are exactly the products, in
// the order, that the right-looking update applies to a_ij; row j and the
// lane's own row are read four entries at a time (a 68-float row pitch
// keeps them 16-byte aligned and the quarter-warp's reads in distinct
// banks), and no store falls inside the sum, so its loads run ahead of the
// multiply-adds.  The sum for column j + 1 over k < j runs while column j's
// pivot comes from lane j by a shuffle and goes through rsqrt; its last
// term, L_i,j L_j+1,j, then comes from registers and one more shuffle.  Row
// P, b, becomes y = L^-1 b as one more row of the factor (forward
// substitution in a column-oriented order, for free), and the back
// substitution L^T x = y is column-oriented: x_j is formed on its own lane
// and broadcast by a shuffle, and every lane with i < j subtracts
// L_ji x_j (row j of L read across the lanes) from its own entry, by a
// select, not a branch.  1 / L_jj is the pivot's rsqrt d_j in both
// substitutions, as in the factor's own rows: no division is left.  No
// integer division in a loop, no reduction tree.  Other designs measured on
// the card (PERF.md section 6): the rows in registers with every loop
// unrolled to compile-time indices ran at instruction-fetch speed, and the
// right-looking update in shared memory serialised on its stores.
//
// Determinism: a fixed order of operations per system, no atomics; a system
// gives the same bits alone or in a batch.  Built without fast math: rsqrtf
// is not approximated.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 64;
// row pitch: 16-byte aligned rows, and the 8 lanes of a quarter-warp's
// float4 reads of their own rows fall in distinct banks
constexpr int kLd = kMaxP + 4;
constexpr unsigned kFull = 0xffffffffu;

// R row slots per lane hold the P rows of A and the row of b: R = 1 for
// P < 32, 2 for P < 64, 3 for P = 64.
template <int R>
__global__ void __launch_bounds__(32)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, int P) {
  __shared__ __align__(16) float sL[32 * R * kLd];
  __shared__ float sD[kMaxP];  // the pivots' rsqrt, 1 / L_jj
  const int lane = threadIdx.x;
  const float* As = A + static_cast<size_t>(blockIdx.x) * P * P;
  const float* bs = b + static_cast<size_t>(blockIdx.x) * P;
  float* xs = x + static_cast<size_t>(blockIdx.x) * P;

  // the lower triangle of A as rows 0..P-1 and b as row P, all copies in
  // flight at once (asynchronous copies to shared memory, one wait)
#pragma unroll 4
  for (int r = 0; r < P; ++r) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = lane + 32 * q;
      if (c <= r) __pipeline_memcpy_async(&sL[r * kLd + c], &As[static_cast<size_t>(r) * P + c], 4);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = lane + 32 * q;
    if (c < P) __pipeline_memcpy_async(&sL[P * kLd + c], &bs[c], 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();

  // ---- Cholesky, column j per step (left-looking), with b as row P ------
  // s: the lanes' rows of column j, complete; t: of column j + 1
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    s[r] = i <= P ? sL[i * kLd] : 0.0f;
  }
  for (int j = 0; j < P; ++j) {
    float own = s[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      if (j >= 32 * r) own = s[r];
    }
    const float sjj = __shfl_sync(kFull, own, j & 31);
    // column j + 1 over k < j, while the pivot is on its way
    const int n = j + 1;
    float t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[r] = sL[(lane + 32 * r) * kLd + n];
    // (rows outside n..P compute values that are never stored or read)
    int k = 0;
#pragma unroll 2
    for (; k + 4 <= j; k += 4) {
      const float4 ln = *reinterpret_cast<const float4*>(&sL[n * kLd + k]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 li = *reinterpret_cast<const float4*>(&sL[(lane + 32 * r) * kLd + k]);
        t[r] -= li.x * ln.x;
        t[r] -= li.y * ln.y;
        t[r] -= li.z * ln.z;
        t[r] -= li.w * ln.w;
      }
    }
    for (; k < j; ++k) {
      const float lnk = sL[n * kLd + k];
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] -= sL[(lane + 32 * r) * kLd + k] * lnk;
    }
    const float d = rsqrtf(sjj < 1e-30f ? 1e-30f : sjj);
    float l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      l[r] = s[r] * d;
      if (i >= j && i <= P) sL[i * kLd + j] = l[r];
    }
    // the last term of column j + 1: L_nj from lane n
    float ln_own = l[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      if (n >= 32 * r) ln_own = l[r];
    }
    const float lnj = __shfl_sync(kFull, ln_own, n & 31);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      t[r] -= l[r] * lnj;
      s[r] = t[r];
    }
    if (lane == 0) sD[j] = d;
    __syncwarp();
  }

  // ---- L^T x = y: x_j on lane j, then every row above subtracts L[j][i] x_j
  float y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    y[r] = i < P ? sL[P * kLd + i] : 0.0f;
  }
#pragma unroll 4
  for (int j = P - 1; j >= 0; --j) {
    float own = y[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      if (j >= 32 * r) own = y[r];
    }
    const float xj = __shfl_sync(kFull, own * sD[j], j & 31);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + 32 * r;
      // select, not branch: the entries of row j right of the diagonal are
      // read but not used
      const float upd = y[r] - sL[j * kLd + i] * xj;
      y[r] = i < j ? upd : (i == j ? xj : y[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + 32 * r;
    if (i < P) xs[i] = y[r];
  }
}

}  // namespace

// A (B, P, P), b (B, P) float32 contiguous on the device, 1 <= P <= 64 ->
// x (B, P).  One warp per system.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int chol_solve_f32(const float* A, const float* b, float* x, int B,
                              int P, void* stream) {
  if (B < 0 || P < 1 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (P < 32) {
      chol_solve_kernel<1><<<B, 32, 0, s>>>(A, b, x, P);
    } else if (P < 64) {
      chol_solve_kernel<2><<<B, 32, 0, s>>>(A, b, x, P);
    } else {
      chol_solve_kernel<3><<<B, 32, 0, s>>>(A, b, x, P);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
