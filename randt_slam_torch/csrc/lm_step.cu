// One LM iteration of the window smoother's solve, beside K3a, K3b and K4:
// the damped system's assembly (lm_assemble), the trial step (lm_trial) and
// the acceptance (lm_accept).
//
// Replaces: the tensor ops of registration/solver.py `lm_solve`'s iteration
// and registration/matcher.py's aux (motion and IMU) linearization, which
// the JAX package runs as XLA ops inside its `lax.while_loop` (no Pallas
// kernel).  Per LM iteration the card path is six launches:
//
//   K3a (NDT blocks at p) -> lm_assemble -> K4 (A x = rhs) -> lm_trial
//   -> K3b (NDT cost at the trial) -> lm_accept
//
// A window of W transitions has P = (W + 1) * 9 parameters (9 per state:
// x y theta vx vy omega ax ay bias); transition j reads states j and j + 1
// and gives 8 motion rows (sqrt_info times the error of the
// constant-velocity prediction) and 2 IMU rows (gyro yaw, bias walk), in
// the row layout of ops/lm_step.py `aux_residuals`: motion rows j * 8 + m,
// then IMU rows 8 W + 2 j + m.
//
// lm_assemble: the motion and IMU residuals and their Jacobians in closed
//   form (the derivatives of residuals.predict_state, motion_residual and
//   imu_residual written out; normalize_angle has derivative 1), masked by
//   the active columns and weighted by the valid rows; H = J^T W J and
//   g = J^T W r over the P parameters plus K3a's per-slot 3x3 NDT blocks at
//   the slot poses; then the Jacobi scaling dscale = rsqrt(max(diag H,
//   1e-10)) * active, A = dscale H dscale + diag(lam * active + 1 - active),
//   rhs = g * dscale.  Writes A (P, P), rhs and dscale, the layout K4 reads.
// lm_trial: delta = -x * dscale, trial = p + delta with the angles wrapped,
//   |delta| and |p * active| (the parameter tolerance), and the trial's slot
//   poses [tx, ty, cos, sin] that K3b reads.
// lm_accept: the cost at the trial, 0.5 (ndt_scale sum rho + sum r_aux^2),
//   from K3b's per-slot rho; the acceptance, the damping update and clamp,
//   the `small | flat` and `lam >= 1e7` exits, the freeze of p, c, lam and
//   done, the live-iteration counter (less the done flag from before the
//   iteration), and the next iterate's slot poses for K3a.
//
// What bounds them on an H100: latency.  At the fleet's B = 512, P = 36 a
// launch moves at most A's 2.65 MB (lm_assemble: ~0.8 us at 3.35 TB/s) and
// a few thousand flops per member; the launch itself costs more.  They
// exist to replace ~460 small tensor-op launches an iteration.
//
// Design: every member is its own block (lm_assemble) or warp (lm_trial,
// lm_accept); no cross-member sum, so a member's answer does not depend on
// B.  lm_assemble: a thread per residual row builds its row and its 18
// Jacobian entries (two states) in shared memory; a thread per entry of the
// P x P system sums the rows of the transitions that touch both its
// columns (at most 2 x 10), the diagonal first, so that the scaling is
// known when A is written.  lm_trial and lm_accept: a lane per parameter
// (two at P > 32) and per residual row, fixed shuffle trees for the norms
// and the aux cost.
//
// Determinism: fixed orders, no atomics; built without fast math (sinf,
// cosf, sqrtf and rsqrtf as the tensor ops take them).  The angle wrap, the
// trial step and the damping update are rounded op by op as the card's
// tensor ops round them (no contracted multiply-add; a division by a host
// constant is a product with its reciprocal), so the trial and the damping
// are bitwise the tensor ops' on the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxW = 6;                 // P = (W + 1) * 9 <= 63: K4's P <= 64
constexpr int kDim = 9;                  // floats per state
constexpr int kMaxP = (kMaxW + 1) * kDim;
constexpr int kRows = 10;                // aux rows per transition
constexpr int kCols = 2 * kDim;          // a transition reads two states
constexpr int kMaxRows = kMaxW * kRows;
constexpr int kAssembleThreads = 128;
constexpr int kWarpsPerBlock = 4;        // lm_trial, lm_accept: a warp a member
constexpr unsigned kFull = 0xffffffffu;
// math.pi and 2 math.pi as the tensor ops round them
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kMinDt = 0.2f;           // residuals.MIN_DT

// geometry.normalize_angle, rounded op by op as the tensor ops round it on
// the card, where a tensor over a host scalar is multiplied by the scalar's
// float32 reciprocal
__device__ __forceinline__ float wrap(float t) {
  return __fsub_rn(t, __fmul_rn(kTwoPi, floorf(__fmul_rn(__fadd_rn(t, kPi), 1.0f / kTwoPi))));
}

// torch.clamp(x, lo, hi): a NaN stays NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// residuals.predict_state of s0 over raw_dt, and the motion error e of s1
// against it (before sqrt_info); the terms the Jacobian reads
struct Motion {
  float dt, sy, cy, dx, dy;
  float e[8];
};

__device__ __forceinline__ Motion motion(const float* s0, const float* s1,
                                         float raw_dt) {
  Motion q;
  const float dt = raw_dt < kMinDt ? kMinDt : raw_dt;  // clamp(min=): NaN stays
  const float th = s0[2], vx = s0[3], vy = s0[4], om = s0[5];
  const float ax = s0[6], ay = s0[7];
  const float rot_mid = wrap(th + 0.5f * dt * om);
  q.dt = dt;
  q.sy = sinf(rot_mid);
  q.cy = cosf(rot_mid);
  q.dx = vx * dt + 0.5f * ax * dt * dt;
  q.dy = vy * dt + 0.5f * ay * dt * dt;
  q.e[0] = s1[0] - (s0[0] + (q.cy * q.dx - q.sy * q.dy));
  q.e[1] = s1[1] - (s0[1] + (q.sy * q.dx + q.cy * q.dy));
  q.e[2] = wrap(s1[2] - wrap(th + dt * om));
  q.e[3] = s1[3] - (vx + dt * ax);
  q.e[4] = s1[4] - (vy + dt * ay);
  q.e[5] = s1[5] - om;
  q.e[6] = s1[6] - ax;
  q.e[7] = s1[7] - ay;
  return q;
}

// Row m of a transition's 10 aux residuals: sqrt_info row m times e
// (m < 8), the gyro yaw (8), the bias walk (9)
__device__ __forceinline__ float aux_row(int m, const Motion& q, const float* S,
                                         const float* s0, const float* s1,
                                         float raw_dt, float meas, float w_imu,
                                         float w_bias) {
  if (m < 8) {
    float r = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) r += S[8 * m + k] * q.e[k];
    return r;
  }
  if (m == 8) return w_imu * (meas - wrap(s1[2] - s0[2] + s1[8] * raw_dt));
  return w_bias * (s1[8] - s0[8]);
}

// Row m's derivatives against s0 (J[0..8]) and s1 (J[9..17])
__device__ __forceinline__ void aux_jacobian_row(int m, const Motion& q,
                                                 const float* S, float raw_dt,
                                                 float w_imu, float w_bias,
                                                 float* J) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) J[c] = 0.0f;
  if (m < 8) {
    const float* Sm = S + 8 * m;
    // d e0 / d theta0 and d e1 / d theta0, through the midpoint heading
    const float a0 = q.sy * q.dx + q.cy * q.dy;
    const float a1 = -(q.cy * q.dx - q.sy * q.dy);
    const float h = 0.5f * q.dt * q.dt;
    J[0] = -Sm[0];
    J[1] = -Sm[1];
    J[2] = Sm[0] * a0 + Sm[1] * a1 - Sm[2];
    J[3] = -(Sm[0] * q.cy + Sm[1] * q.sy) * q.dt - Sm[3];
    J[4] = (Sm[0] * q.sy - Sm[1] * q.cy) * q.dt - Sm[4];
    J[5] = 0.5f * q.dt * (Sm[0] * a0 + Sm[1] * a1) - Sm[2] * q.dt - Sm[5];
    J[6] = -(Sm[0] * q.cy + Sm[1] * q.sy) * h - Sm[3] * q.dt - Sm[6];
    J[7] = (Sm[0] * q.sy - Sm[1] * q.cy) * h - Sm[4] * q.dt - Sm[7];
#pragma unroll
    for (int k = 0; k < 8; ++k) J[kDim + k] = Sm[k];
  } else if (m == 8) {
    J[2] = w_imu;
    J[kDim + 2] = -w_imu;
    J[kDim + 8] = -w_imu * raw_dt;
  } else {
    J[8] = -w_bias;
    J[kDim + 8] = w_bias;
  }
}

// the row of transition j, component m, in aux_valid's layout
__device__ __forceinline__ int valid_row(int j, int m, int W) {
  return m < 8 ? j * 8 + m : W * 8 + 2 * j + (m - 8);
}

// the slot poses [tx, ty, cos, sin] of states 1..W of the parameters x
__device__ __forceinline__ void slot_pose(const float* x, int j, float* out) {
  const float* s = x + kDim * (j + 1);
  out[0] = s[0];
  out[1] = s[1];
  out[2] = cosf(s[2]);
  out[3] = sinf(s[2]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---- lm_assemble: one block per member ---------------------------------------

struct Rows {
  float J[kMaxRows][kCols];  // masked by the active columns
  float w[kMaxRows];         // the rows' valid weights
  float r[kMaxRows];
};

// H[a][c] of the aux rows plus the NDT block, from the shared rows
__device__ __forceinline__ float normal_entry(const Rows& R, const float* Hj,
                                              const float* af, int a, int c,
                                              int W) {
  const int sa = a / kDim, sb = c / kDim;
  float h = 0.0f;
  if (sa - sb > 1 || sb - sa > 1) return h;
  const int lo = (sa > sb ? sa : sb) - 1;
  const int hi = sa < sb ? sa : sb;
  for (int j = lo < 0 ? 0 : lo; j <= hi && j < W; ++j) {
    const int ca = a - kDim * j, cb = c - kDim * j;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int r = j * kRows + m;
      h += R.J[r][ca] * (R.J[r][cb] * R.w[r]);
    }
  }
  const int ia = a - kDim * sa, ib = c - kDim * sb;
  if (sa == sb && sa >= 1 && ia < 3 && ib < 3) {
    h += Hj[((sa - 1) * 3 + ia) * 3 + ib] * af[a] * af[c];
  }
  return h;
}

__global__ void __launch_bounds__(kAssembleThreads)
lm_assemble_kernel(const float* __restrict__ Hj, const float* __restrict__ gj,
                   const float* __restrict__ p, const float* __restrict__ dts,
                   const float* __restrict__ imu, const float* __restrict__ lam,
                   const float* __restrict__ S, const float* __restrict__ row_valid,
                   const float* __restrict__ active, float w_imu, float w_bias,
                   int W, float* __restrict__ A, float* __restrict__ rhs,
                   float* __restrict__ dscale) {
  __shared__ Rows R;
  __shared__ float st[kMaxP];
  __shared__ float af[kMaxP];
  __shared__ float hd[kMaxP];
  __shared__ float ds[kMaxP];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int P = (W + 1) * kDim;
  const float* Hb = Hj + static_cast<size_t>(b) * W * 9;
  const float* gb = gj + static_cast<size_t>(b) * W * 3;
  for (int i = t; i < P; i += kAssembleThreads) {
    st[i] = p[static_cast<size_t>(b) * P + i];
    af[i] = active[i];
  }
  __syncthreads();

  // a thread per aux row: its residual and its masked Jacobian row
  for (int r = t; r < W * kRows; r += kAssembleThreads) {
    const int j = r / kRows, m = r % kRows;
    const float* s0 = st + kDim * j;
    const float* s1 = s0 + kDim;
    const float raw_dt = dts[b * W + j];
    const Motion q = motion(s0, s1, raw_dt);
    R.r[r] = aux_row(m, q, S, s0, s1, raw_dt, imu[b * W + j], w_imu, w_bias);
    R.w[r] = row_valid[valid_row(j, m, W)];
    float J[kCols];
    aux_jacobian_row(m, q, S, raw_dt, w_imu, w_bias, J);
#pragma unroll
    for (int c = 0; c < kCols; ++c) R.J[r][c] = J[c] * af[kDim * j + c];
  }
  __syncthreads();

  // the diagonal first: the Jacobi scaling
  for (int a = t; a < P; a += kAssembleThreads) {
    const float h = normal_entry(R, Hb, af, a, a, W);
    hd[a] = h;
    ds[a] = rsqrtf(h < 1e-10f ? 1e-10f : h) * af[a];
  }
  __syncthreads();

  const float lb = lam[b];
  float* Ab = A + static_cast<size_t>(b) * P * P;
  for (int idx = t; idx < P * P; idx += kAssembleThreads) {
    const int a = idx / P, c = idx - (idx / P) * P;
    const float h = a == c ? hd[a] : normal_entry(R, Hb, af, a, c, W);
    float v = h * ds[a] * ds[c];
    if (a == c) v += lb * af[a] + (1.0f - af[a]);
    Ab[idx] = v;
  }
  for (int a = t; a < P; a += kAssembleThreads) {
    const int sa = a / kDim;
    float g = 0.0f;
    for (int j = sa - 1 < 0 ? 0 : sa - 1; j <= sa && j < W; ++j) {
      const int ca = a - kDim * j;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int r = j * kRows + m;
        g += R.r[r] * (R.J[r][ca] * R.w[r]);
      }
    }
    const int ia = a - kDim * sa;
    if (sa >= 1 && ia < 3) g += gb[(sa - 1) * 3 + ia] * af[a];
    rhs[static_cast<size_t>(b) * P + a] = g * ds[a];
    dscale[static_cast<size_t>(b) * P + a] = ds[a];
  }
}

// ---- lm_trial: one warp per member --------------------------------------------

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lm_trial_kernel(const float* __restrict__ p, const float* __restrict__ x,
                const float* __restrict__ dscale, const float* __restrict__ active,
                const float* __restrict__ angle, int B, int W,
                float* __restrict__ trial, float* __restrict__ pose4,
                float* __restrict__ dnorm, float* __restrict__ pnorm) {
  __shared__ float tr[kWarpsPerBlock][kMaxP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only
  const int P = (W + 1) * kDim;
  const size_t o = static_cast<size_t>(b) * P;
  float dsq = 0.0f, psq = 0.0f;
  for (int i = lane; i < P; i += 32) {
    const float pi = p[o + i];
    // rounded op by op: the trial is the tensor ops' to the bit
    const float delta = __fmul_rn(-x[o + i], dscale[o + i]);
    float v = __fadd_rn(pi, delta);
    if (angle[i] != 0.0f) v = wrap(v);
    tr[warp][i] = v;
    trial[o + i] = v;
    dsq += delta * delta;
    const float pa = pi * active[i];
    psq += pa * pa;
  }
  dsq = warp_sum(dsq);
  psq = warp_sum(psq);
  __syncwarp();
  if (lane < W) slot_pose(tr[warp], lane, pose4 + (static_cast<size_t>(b) * W + lane) * 4);
  if (lane == 0) {
    dnorm[b] = sqrtf(dsq);
    pnorm[b] = sqrtf(psq);
  }
}

// ---- lm_accept: one warp per member -------------------------------------------

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lm_accept_kernel(const float* __restrict__ rho, const float* __restrict__ trial,
                 const float* __restrict__ dnorm, const float* __restrict__ pnorm,
                 const float* __restrict__ ndt_scale, const float* __restrict__ dts,
                 const float* __restrict__ imu, const float* __restrict__ S,
                 const float* __restrict__ row_valid, float w_imu, float w_bias,
                 float tol, float ftol, int B, int W, float* __restrict__ p,
                 float* __restrict__ cost, float* __restrict__ lam,
                 uint8_t* __restrict__ done, int32_t* __restrict__ live,
                 float* __restrict__ pose4) {
  __shared__ float np[kWarpsPerBlock][kMaxP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps only
  const int P = (W + 1) * kDim;
  const size_t o = static_cast<size_t>(b) * P;
  const float* tb = trial + o;

  // the aux cost at the trial: a lane per row
  float aux = 0.0f;
  for (int r = lane; r < W * kRows; r += 32) {
    const int j = r / kRows, m = r % kRows;
    const float* s0 = tb + kDim * j;
    const float* s1 = s0 + kDim;
    const float raw_dt = dts[b * W + j];
    const Motion q = motion(s0, s1, raw_dt);
    const float v = aux_row(m, q, S, s0, s1, raw_dt, imu[b * W + j], w_imu, w_bias);
    aux += row_valid[valid_row(j, m, W)] != 0.0f ? v * v : 0.0f;
  }
  aux = warp_sum(aux);
  float rho_sum = 0.0f;
  for (int j = 0; j < W; ++j) rho_sum += rho[b * W + j];
  const float c_new = 0.5f * (ndt_scale[b] * rho_sum + aux);

  const float c = cost[b], l = lam[b];
  const bool was_done = done[b] != 0;
  const bool accept = c_new < c;
  // lam / 3 as the tensor ops take it on the card: times the reciprocal
  const float lam_next = clampf(accept ? __fmul_rn(l, 1.0f / 3.0f) : l * 4.0f, 1e-10f, 1e8f);
  const bool small = dnorm[b] <= tol * (pnorm[b] + tol);
  const bool flat = (c - c_new) <= ftol * c;
  const bool done_next = (accept && (small || flat)) || (!accept && l >= 1e7f);
  const bool take = !was_done && accept;
  for (int i = lane; i < P; i += 32) {
    const float v = take ? tb[i] : p[o + i];
    np[warp][i] = v;
    p[o + i] = v;
  }
  __syncwarp();
  if (lane < W) slot_pose(np[warp], lane, pose4 + (static_cast<size_t>(b) * W + lane) * 4);
  if (lane == 0) {
    if (!was_done) {
      cost[b] = accept ? c_new : c;
      lam[b] = lam_next;
    }
    done[b] = (was_done || done_next) ? 1 : 0;
    if (live != nullptr) live[b] -= was_done ? 1 : 0;
  }
}

bool bad_window(int B, int W) { return B < 0 || W < 1 || W > kMaxW; }

int blocks_of_warps(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

// Hj (B, W, 3, 3), gj (B, W, 3): K3a's slot blocks; p (B, P); dts, imu
// (B, W); lam (B); sqrt_info (8, 8); row_valid (10 W) in aux_valid's row
// layout; active (P) 0/1 -> A (B, P, P), rhs (B, P), dscale (B, P).  All
// float32, contiguous, on the device; 1 <= W <= 6.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int lm_assemble_f32(const float* Hj, const float* gj, const float* p,
                               const float* dts, const float* imu,
                               const float* lam, const float* sqrt_info,
                               const float* row_valid, const float* active,
                               float w_imu, float w_bias, float* A, float* rhs,
                               float* dscale, int B, int W, void* stream) {
  if (bad_window(B, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    lm_assemble_kernel<<<B, kAssembleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        Hj, gj, p, dts, imu, lam, sqrt_info, row_valid, active, w_imu, w_bias, W,
        A, rhs, dscale);
  }
  return static_cast<int>(cudaGetLastError());
}

// p, x, dscale (B, P); active, angle (P) 0/1 -> trial (B, P), pose4
// (B, W, 4), dnorm, pnorm (B).
extern "C" int lm_trial_f32(const float* p, const float* x, const float* dscale,
                            const float* active, const float* angle, float* trial,
                            float* pose4, float* dnorm, float* pnorm, int B, int W,
                            void* stream) {
  if (bad_window(B, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    lm_trial_kernel<<<blocks_of_warps(B), 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        p, x, dscale, active, angle, B, W, trial, pose4, dnorm, pnorm);
  }
  return static_cast<int>(cudaGetLastError());
}

// rho (B, W): K3b's slot sums at the trial; trial (B, P); dnorm, pnorm,
// ndt_scale (B); dts, imu (B, W); sqrt_info, row_valid as lm_assemble's.
// Updates p (B, P), cost, lam (B) float32, done (B) bool and live (B) int32
// (may be null) in place, and writes pose4 (B, W, 4) of the new p.
extern "C" int lm_accept_f32(const float* rho, const float* trial, const float* dnorm,
                             const float* pnorm, const float* ndt_scale,
                             const float* dts, const float* imu,
                             const float* sqrt_info, const float* row_valid,
                             float w_imu, float w_bias, float tol, float ftol,
                             float* p, float* cost, float* lam, uint8_t* done,
                             int32_t* live, float* pose4, int B, int W,
                             void* stream) {
  if (bad_window(B, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    lm_accept_kernel<<<blocks_of_warps(B), 32 * kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        rho, trial, dnorm, pnorm, ndt_scale, dts, imu, sqrt_info, row_valid, w_imu,
        w_bias, tol, ftol, B, W, p, cost, lam, done, live, pose4);
  }
  return static_cast<int>(cudaGetLastError());
}
