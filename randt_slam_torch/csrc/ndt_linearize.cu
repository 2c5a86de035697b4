// Fused NDT linearization (kernel K3a) and robust cost (kernel K3b) of the
// window smoother's LM loop.
//
// Replaces: randt_slam_tpu/ops/ndt_linearize.py `linearize` (Pallas kernel
// `_linearize_kernel`) and `robust_cost` (Pallas kernel `_cost_kernel`),
// both over the shared math `_pair_terms`, `_barron_weight`, `_barron_rho`.
//
// Per window slot w, over its N pairs (moving cell, fixed map, neighbour):
//
//   r2 = d^T S^-1 d,  S = R Sigma_m R^T + Sigma_f,  d = R mu_m + t - mu_f
//   r  = sqrt(max(r2, eps)),  J = dr/d(tx, ty, theta) (zero where r2 <= eps)
//   K3a: H = sum w J J^T (3x3), g = sum w r J (3), rho = sum rho(r^2) v
//        with w = ndt_scale * rho'(r^2) * v (Barron IRLS weight, GNC mu)
//   K3b: rho = sum rho(r^2) v, r2max = max over valid pairs of r^2
//
// Inputs are the channels-first packs of ops/ndt_linearize.pack_pairs:
// m_mean (W,3,N), m_cov (W,6,N), a_mean (W,3,N), a_cov (W,6,N), valid
// (W,1,N), covariances as their 6 unique components [00 01 02 11 12 22];
// pose4 (W,4) = [tx, ty, cos theta, sin theta] computed outside.  mu and
// ndt_scale are read from device memory (they are device tensors inside the
// LM loop; passing them by value would make the host wait on the device).
//
// A batch of B window problems is B * W slots in one launch: the packs are
// (B*W, ch, N), and slot w belongs to member w / W, whose own mu and
// ndt_scale it reads (one value each per member).  Each slot's sums are
// its own; the wrapper sums rho over each member's W slots.
//
// What bounds it on an H100: latency, for both.  The bytes are reading
// the valid weight of every pair and the other 18 floats of each valid pair
// once (an invalid pair adds nothing; at most W * N * 76 B = 0.47 MB at the
// Oxford shape W = 3, N = 2048, ~0.14 us at 3.35 TB/s); about 200 float
// operations per valid pair are ~0.02 us at 67 TFLOP/s.  At this size one
// launch costs more than either: the kernels exist to replace the ~1,000
// small launches of an autograd linearization.  The TPU kernel unrolled the
// W slots over full-width vector ops in one program.
//
// Both kernels: each slot is one thread-block cluster of 8 blocks x 256
// threads (a Hopper feature), so at N = 2048 a thread takes one pair and
// every load of the slot is in flight at once (any N: the thread of rank k
// strides n = k * 256 + t, + 2048, ...).  Each warp folds its threads' sums
// by fixed shuffle trees: K3b's cost and maximum one tree each, K3a's ten
// sums by the transposing fold of warp_fold.cuh (12 shuffles, not 50).
// Each block folds its warps in order into its own shared memory, and after
// a cluster barrier block rank 0 reads the 8 block partials through
// distributed shared memory in rank order and writes the slot's outputs; a
// second barrier keeps every block's shared memory alive until then.  One
// launch, no device-memory scratch, no counter; a card that refuses the
// cluster launch makes the launcher return its error.
//
// Determinism: every sum is taken in a fixed order (per thread, then the
// fixed trees), with no float atomics, so two launches give bitwise-identical
// output.  Built without fast math: sqrtf, powf, log1pf and division are the
// IEEE-accurate versions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>

#include "warp_fold.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterBlocks = 8;  // the portable cluster size
constexpr int kSlotThreads = kClusterBlocks * kThreads;  // one pair each at N = 2048
constexpr int kTerms = 10;  // H00 H01 H02 H11 H12 H22 g0 g1 g2 rho

// Barron loss with the GNC control parameter folded into the scale
// (registration/barron.py): b = mu a^2, c = 1/b; branch 0 for alpha >= 2,
// 1 for |alpha| <= 0.05 (Cauchy), 2 otherwise.  factor = |alpha - 2|,
// exponent = alpha / 2, exponent_m1 = alpha / 2 - 1 come from the host.
struct Barron {
  int branch;
  float alpha, factor, exponent, exponent_m1;
  float b, c, pre, times_s;

  __device__ Barron(float mu, float scale, float alpha_, int branch_,
                    float factor_, float exponent_, float exponent_m1_)
      : branch(branch_), alpha(alpha_), factor(factor_), exponent(exponent_),
        exponent_m1(exponent_m1_) {
    b = mu * scale * scale;
    c = 1.0f / b;
    pre = b * factor / alpha;
    times_s = 2.0f * c / factor;
  }

  __device__ float weight(float s) const {
    if (branch == 0) return 1.0f;
    if (branch == 1) {
      const float w = 1.0f / (1.0f + s * c);
      return w < FLT_MIN ? FLT_MIN : w;
    }
    return pre * exponent * powf(s * times_s + 1.0f, exponent_m1) * times_s;
  }

  __device__ float rho(float s) const {
    if (branch == 0) return s;
    if (branch == 1) return b * log1pf(s * c);
    return pre * (powf(s * times_s + 1.0f, exponent) - 1.0f);
  }
};

struct Pair {
  float r2, q0, q1, q2, dth0, dth1;
  float dS00, dS01, dS02, dS11, dS12;
};

// The pair math of `_pair_terms`, formula for formula.  `x + n` points at
// channel 0 of pair n; channel k lies N floats further on.
__device__ __forceinline__ Pair pair_terms(float c, float s, float tx, float ty,
                                           const float* __restrict__ mm,
                                           const float* __restrict__ mc,
                                           const float* __restrict__ am,
                                           const float* __restrict__ ac,
                                           int N, int n) {
  const float mx = mm[n], my = mm[N + n], mi = mm[2 * N + n];
  const float a = mc[n], b = mc[N + n], e = mc[2 * N + n];
  const float cc = mc[3 * N + n], f = mc[4 * N + n], g = mc[5 * N + n];
  const float fx = am[n], fy = am[N + n], fi = am[2 * N + n];
  const float f00 = ac[n], f01 = ac[N + n], f02 = ac[2 * N + n];
  const float f11 = ac[3 * N + n], f12 = ac[4 * N + n], f22 = ac[5 * N + n];

  const float u = c * mx - s * my;
  const float v = s * mx + c * my;
  const float d0 = u + tx - fx;
  const float d1 = v + ty - fy;
  const float d2 = mi - fi;

  // S = R Sigma_m R^T + Sigma_f
  const float r00 = c * (c * a - s * b) - s * (c * b - s * cc);
  const float r01 = c * (s * a + c * b) - s * (s * b + c * cc);
  const float r11 = s * (s * a + c * b) + c * (s * b + c * cc);
  const float r02 = c * e - s * f;
  const float r12 = s * e + c * f;
  const float s00 = r00 + f00;
  const float s01 = r01 + f01;
  const float s02 = r02 + f02;
  const float s11 = r11 + f11;
  const float s12 = r12 + f12;
  const float s22 = g + f22;

  // q = S^-1 d via the adjugate; |det| < 1e-30 (a small negative det too)
  // becomes +1e-30
  const float A = s11 * s22 - s12 * s12;
  const float B = s02 * s12 - s01 * s22;
  const float C = s01 * s12 - s11 * s02;
  float det = s00 * A + s01 * B + s02 * C;
  det = fabsf(det) < 1e-30f ? 1e-30f : det;
  const float D = s00 * s22 - s02 * s02;
  const float E = s01 * s02 - s00 * s12;
  const float F = s00 * s11 - s01 * s01;
  Pair p;
  p.q0 = (A * d0 + B * d1 + C * d2) / det;
  p.q1 = (B * d0 + D * d1 + E * d2) / det;
  p.q2 = (C * d0 + E * d1 + F * d2) / det;
  p.r2 = d0 * p.q0 + d1 * p.q1 + d2 * p.q2;
  p.dth0 = -v;
  p.dth1 = u;

  // dS/dtheta = P + P^T, P = (R' Sigma_m) R^T
  const float n00 = -s * a - c * b;
  const float n01 = -s * b - c * cc;
  const float n02 = -s * e - c * f;
  const float n10 = c * a - s * b;
  const float n11 = c * b - s * cc;
  const float n12 = c * e - s * f;
  const float p00 = n00 * c - n01 * s;
  const float p01 = n00 * s + n01 * c;
  const float p10 = n10 * c - n11 * s;
  const float p11 = n10 * s + n11 * c;
  p.dS00 = 2.0f * p00;
  p.dS01 = p01 + p10;
  p.dS02 = n02;
  p.dS11 = 2.0f * p11;
  p.dS12 = n12;
  return p;
}

// max(r2, eps) as jnp.maximum / torch.clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_eps(float r2, float eps) {
  return r2 < eps ? eps : r2;
}

// max(a, b) as jnp.max / torch.amax: a NaN in either stays NaN (fmaxf
// would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// K3a: one thread-block cluster of kClusterBlocks blocks per slot, as K3b
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads)
linearize_kernel(const float* __restrict__ pose4, const float* __restrict__ mu_p,
                 const float* __restrict__ ndt_scale_p,
                 const float* __restrict__ mm, const float* __restrict__ mc,
                 const float* __restrict__ am, const float* __restrict__ ac,
                 const float* __restrict__ valid, float* __restrict__ H,
                 float* __restrict__ g, float* __restrict__ rho_out,
                 int slots_per_member, int N, float scale, float alpha,
                 float eps, int branch, float factor, float exponent,
                 float exponent_m1) {
  __shared__ float warp_part[kWarps][kTerms];
  __shared__ float block_part[kTerms];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = blockIdx.x / kClusterBlocks;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const float tx = pose4[4 * w], ty = pose4[4 * w + 1];
  const float c = pose4[4 * w + 2], s = pose4[4 * w + 3];
  const int member = w / slots_per_member;
  const float ndt_scale = ndt_scale_p[member];
  const Barron loss(mu_p[member], scale, alpha, branch, factor, exponent,
                    exponent_m1);
  const size_t o3 = static_cast<size_t>(w) * 3 * N;
  const size_t o6 = static_cast<size_t>(w) * 6 * N;
  const float* vw = valid + static_cast<size_t>(w) * N;

  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;

  // every pair is read, valid or not: its terms are multiplied by the valid
  // weight, so a NaN in an invalid pair reaches the sums as in plain
  for (int n = rank * kThreads + t; n < N; n += kSlotThreads) {
    const Pair p = pair_terms(c, s, tx, ty, mm + o3, mc + o6, am + o3, ac + o6, N, n);
    const float w_valid = vw[n];
    const float r = sqrtf(clamp_eps(p.r2, eps));
    const float qdSq = p.q0 * (p.dS00 * p.q0 + p.dS01 * p.q1 + p.dS02 * p.q2)
                       + p.q1 * (p.dS01 * p.q0 + p.dS11 * p.q1 + p.dS12 * p.q2)
                       + p.q2 * (p.dS02 * p.q0 + p.dS12 * p.q1);
    const float inv2r = 0.5f / r;
    // the derivative of sqrt(max(r2, eps)): zero where the clamp holds
    const float live = p.r2 > eps ? 1.0f : 0.0f;
    const float J0 = 2.0f * p.q0 * inv2r * live;
    const float J1 = 2.0f * p.q1 * inv2r * live;
    const float J2 = (2.0f * (p.q0 * p.dth0 + p.q1 * p.dth1) - qdSq) * inv2r * live;
    // rho' and rho at r * r, not at r2 (they differ where the clamp holds)
    const float sq = r * r;
    const float wgt = ndt_scale * loss.weight(sq) * w_valid;
    const float wr = wgt * r;
    acc[0] += wgt * J0 * J0;
    acc[1] += wgt * J0 * J1;
    acc[2] += wgt * J0 * J2;
    acc[3] += wgt * J1 * J1;
    acc[4] += wgt * J1 * J2;
    acc[5] += wgt * J2 * J2;
    acc[6] += wr * J0;
    acc[7] += wr * J1;
    acc[8] += wr * J2;
    acc[9] += loss.rho(sq) * w_valid;
  }

  // warp: the transposing fold leaves lane pairs holding one term each
  float sum[fold_width(kTerms, 16)];
  int term, held;
  warp_fold<kTerms, 16>(acc, lane, 0, kTerms, sum, term, held);
  if (held > 0) warp_part[t / 32][term] = sum[0];
  __syncthreads();
  // block: its warps in order
  if (t < kTerms) {
    float tot = warp_part[0][t];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) tot += warp_part[k][t];
    block_part[t] = tot;
  }
  // the cluster: rank 0 reads the blocks' partials through distributed
  // shared memory, in rank order; the second sync keeps every block's
  // shared memory alive until then
  cluster.sync();
  if (rank == 0 && t < kTerms) {
    float tot = block_part[t];
#pragma unroll
    for (int k = 1; k < kClusterBlocks; ++k) {
      tot += cluster.map_shared_rank(&block_part[0], k)[t];
    }
    if (t < 6) {  // H00 H01 H02 H11 H12 H22, H filled symmetrically
      const int i = t < 3 ? 0 : (t < 5 ? 1 : 2);
      const int j = t < 3 ? t : (t < 5 ? t - 2 : 2);
      H[9 * w + 3 * i + j] = tot;
      H[9 * w + 3 * j + i] = tot;
    } else if (t < 9) {
      g[3 * w + t - 6] = tot;
    } else {
      rho_out[w] = tot;
    }
  }
  cluster.sync();
}

// K3b: one thread-block cluster of kClusterBlocks blocks per slot; the
// block of rank k takes the pairs n = k * kThreads + t, + kSlotThreads, ...
__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads)
robust_cost_kernel(const float* __restrict__ pose4, const float* __restrict__ mu_p,
                   const float* __restrict__ mm, const float* __restrict__ mc,
                   const float* __restrict__ am, const float* __restrict__ ac,
                   const float* __restrict__ valid, float* __restrict__ rho_out,
                   float* __restrict__ r2max_out, int slots_per_member, int N,
                   float scale, float alpha, float eps, int branch,
                   float factor, float exponent, float exponent_m1) {
  __shared__ float warp_rho[kWarps];
  __shared__ float warp_top[kWarps];
  __shared__ float block_part[2];  // this block's rho sum and r2 max
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = blockIdx.x / kClusterBlocks;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const float tx = pose4[4 * w], ty = pose4[4 * w + 1];
  const float c = pose4[4 * w + 2], s = pose4[4 * w + 3];
  const Barron loss(mu_p[w / slots_per_member], scale, alpha, branch, factor,
                    exponent, exponent_m1);
  const size_t o3 = static_cast<size_t>(w) * 3 * N;
  const size_t o6 = static_cast<size_t>(w) * 6 * N;
  const float* vw = valid + static_cast<size_t>(w) * N;

  // every pair is read, valid or not: its cost is multiplied by the valid
  // weight, so a NaN in an invalid pair reaches the sum as in plain
  float rho = 0.0f;
  float r2max = 0.0f;
  for (int n = rank * kThreads + t; n < N; n += kSlotThreads) {
    const float r2 =
        pair_terms(c, s, tx, ty, mm + o3, mc + o6, am + o3, ac + o6, N, n).r2;
    const float w_valid = vw[n];
    const float r = sqrtf(clamp_eps(r2, eps));
    const float sq = r * r;
    rho += loss.rho(sq) * w_valid;
    r2max = nan_max(r2max, w_valid > 0.0f ? sq : 0.0f);
  }

  // warp, then block: fixed-order trees
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rho += __shfl_down_sync(0xffffffffu, rho, off);
    r2max = nan_max(r2max, __shfl_down_sync(0xffffffffu, r2max, off));
  }
  if (lane == 0) {
    warp_rho[t / 32] = rho;
    warp_top[t / 32] = r2max;
  }
  __syncthreads();
  if (t == 0) {
    float sum = warp_rho[0], top = warp_top[0];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      sum += warp_rho[k];
      top = nan_max(top, warp_top[k]);
    }
    block_part[0] = sum;
    block_part[1] = top;
  }
  // the cluster: rank 0 reads the blocks' partials through distributed
  // shared memory, in rank order; the second sync keeps every block's
  // shared memory alive until then
  cluster.sync();
  if (rank == 0 && t == 0) {
    float sum = block_part[0], top = block_part[1];
#pragma unroll
    for (int k = 1; k < kClusterBlocks; ++k) {
      const float* part = cluster.map_shared_rank(&block_part[0], k);
      sum += part[0];
      top = nan_max(top, part[1]);
    }
    rho_out[w] = sum;
    r2max_out[w] = top;
  }
  cluster.sync();
}

}  // namespace

// the slot count a launch takes: S slots of W per member, S a multiple of W,
// S * kClusterBlocks blocks in one grid dimension
static bool bad_slots(int S, int W, int N) {
  return S < 0 || W < 0 || N < 0 || S > (1 << 27) ||
         (S > 0 && (W < 1 || S % W != 0));
}

// K3a.  pose4 (S,4), mu (S/W), ndt_scale (S/W), packs (S,3|6|3|6|1,N)
// float32, S = B*W slots, all contiguous on the device -> H (S,3,3), g (S,3),
// rho (S).  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int ndt_linearize_f32(const float* pose4, const float* mu,
                                 const float* ndt_scale, const float* m_mean,
                                 const float* m_cov, const float* a_mean,
                                 const float* a_cov, const float* valid,
                                 float* H, float* g, float* rho, int S, int W,
                                 int N, float scale, float alpha, float eps,
                                 int branch, float factor, float exponent,
                                 float exponent_m1, void* stream) {
  if (bad_slots(S, W, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    // clusters of kClusterBlocks consecutive blocks, one per slot
    linearize_kernel<<<S * kClusterBlocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        pose4, mu, ndt_scale, m_mean, m_cov, a_mean, a_cov, valid, H, g, rho, W,
        N, scale, alpha, eps, branch, factor, exponent, exponent_m1);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3b.  The same inputs without ndt_scale -> rho (S), r2max (S).
extern "C" int ndt_robust_cost_f32(const float* pose4, const float* mu,
                                   const float* m_mean, const float* m_cov,
                                   const float* a_mean, const float* a_cov,
                                   const float* valid, float* rho, float* r2max,
                                   int S, int W, int N, float scale,
                                   float alpha, float eps, int branch,
                                   float factor, float exponent,
                                   float exponent_m1, void* stream) {
  if (bad_slots(S, W, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (S > 0) {
    // clusters of kClusterBlocks consecutive blocks, one per slot
    robust_cost_kernel<<<S * kClusterBlocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        pose4, mu, m_mean, m_cov, a_mean, a_cov, valid, rho, r2max, W, N, scale,
        alpha, eps, branch, factor, exponent, exponent_m1);
  }
  return static_cast<int>(cudaGetLastError());
}
