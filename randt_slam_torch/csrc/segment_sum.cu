// Full segment sum (kernel K5).
//
// Replaces: randt_slam_tpu/ops/segment_moments.py `_segment_moments_pallas`
// (Pallas kernel `_kernel`), reached through `segment_moments`, the moment
// reduction behind `ndt/cells.from_points`.
//
//   out[s, c] = sum_p [ids[p] == s] * values[p, c],   s < S
//
// values are the per-point moment channels [w | w p | w p p^T (+ pNDT)]
// (13 channels); ids outside [0, S) are dropped.  The ids are read as the
// caller has them, int32 or int64 (cluster_ids gives int64), so the caller
// launches nothing but this kernel.
//
// What bounds it on an H100: the function reads every id once, the value
// rows of the kept points once and writes the (S, CH) table once: 0.47 MB
// on a rendered Oxford frame (26,000 int64 ids, 1,804 kept rows, 3,249
// sums), ~0.14 us at 3.35 TB/s; the adds are negligible.  The TPU kernel
// contracted an on-the-fly (segment tile x point tile) one-hot against the
// values on the matrix unit: S * P * CH multiply-adds for an O(P CH) sum.
// What keeps this one ~8 us above the launch is a chain of dependent steps
// (the ids' loads, the scans, the row gather, the cluster barriers), not
// bytes (PERF.md).
//
// Design: one thread-block cluster of kCluster blocks per slice of kSlice
// consecutive segments (13 clusters at S = 3,249).  Block r of a cluster
// takes the r-th of kCluster contiguous stretches of the points, and each
// of its warps a contiguous range of that stretch.  A block sums its
// stretch's points of each segment in ascending point order (a stable
// counting sort in shared memory, then the runs); the kCluster partial
// sums of a segment are then added in rank order.  So each sum is taken in
// one order fixed by the point indices: no float atomics, and two launches
// are bitwise equal.
//
// 1. Each warp reads its range's ids (neighbouring lanes on neighbouring
//    ids), keeps each point's place in the slice in shared memory (kOut:
//    not in it) and counts the slice's segments in its own row of 16-bit
//    counters (integer atomics, two counters to a word: exact in any
//    order).
// 2. Shuffle scans over the warps give each warp's first slot in each
//    segment's run, and a scan over the segments the runs' starts.
// 3. Each warp walks its range again, 32 points a step, from shared
//    memory: the lanes in one segment find each other (__match_any_sync),
//    and a point's slot is its warp's next slot in the segment plus the
//    number of lower lanes in its group.  Each run lists its points in
//    ascending order.
// 4. The listed points' value rows are gathered into shared memory a tile
//    at a time (neighbouring threads on neighbouring values of a row,
//    kGather loads a thread in flight), and one thread per (segment,
//    channel) adds its run's values in list order.
// 5. Each block stores its sums of the r-th kSlice / kCluster segments of
//    the slice into block r's shared memory (distributed shared memory);
//    after a cluster barrier block r adds each segment's kCluster sums in
//    rank order and writes them.
//
// A segment without points writes exactly 0.  Limits: P <= kMaxPoints (a
// block keeps its stretch's places and list in shared memory), S <=
// kMaxSegments.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxChannels = 16;
constexpr int kCluster = 8;              // the portable cluster size
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 256;              // segments per cluster
constexpr int kOwn = kSlice / kCluster;  // segments a block writes
constexpr int kItems = kSlice * kMaxChannels / kThreads;  // sums a thread
constexpr int kRow = kSlice + 2;         // a warp's counter row, off the banks
constexpr int kTile = 1024;              // rows gathered at once
constexpr int kBatch = 8;                // 32-point steps whose ids a warp loads at once
constexpr int kGather = 16;              // values a thread loads before it stores them
constexpr int kMaxPoints = 1 << 17;
constexpr int kMaxSegments = 1 << 16;
constexpr uint16_t kOut = 0xffff;        // a point outside the slice

static_assert(kSlice % kWarps == 0 && kSlice % 32 == 0, "step 2's scans");
static_assert(kOwn * kMaxChannels <= kThreads, "step 5: a sum a thread");
static_assert(kSlice % kCluster == 0, "step 5: kOwn segments a block");
static_assert(kMaxPoints / kCluster < 65536, "a slot in a block's run fits 16 bits");

// dynamic shared memory: the stretch's places (uint16) and list (int32),
// then the gathered rows
__host__ __device__ constexpr int place_bytes(int stretch) { return (stretch + 7) / 8 * 16; }
__host__ __device__ constexpr int list_bytes(int stretch) { return (stretch + 3) / 4 * 16; }

template <typename Id>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ values, const Id* __restrict__ ids,
                   float* __restrict__ out, int P, int S, int CH) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ __align__(16) uint16_t first[kWarps][kRow];  // a warp's next slots
  __shared__ int run_start[kSlice + 1];
  // the blocks' sums of this block's kOwn segments, by rank: item j CH + c
  __shared__ float partial[kCluster][kOwn * kMaxChannels];

  cg::cluster_group cluster = cg::this_cluster();
  // the cluster's blocks have all started once this barrier phase is over:
  // waited for before the first store into another block (step 5)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1;
  const int s_lo = (blockIdx.x / kCluster) * kSlice;
  const int n_seg = min(kSlice, S - s_lo);

  // this block's stretch and this warp's range of it
  const int stretch = (P + kCluster - 1) / kCluster;
  const int b_lo = min(rank * stretch, P), b_hi = min(b_lo + stretch, P);
  const int chunk = (b_hi - b_lo + kWarps - 1) / kWarps;
  const int lo = min(b_lo + warp * chunk, b_hi), hi = min(lo + chunk, b_hi);
  uint16_t* place = reinterpret_cast<uint16_t*>(dyn);  // [p - b_lo]
  int* list = reinterpret_cast<int*>(dyn + place_bytes(stretch));
  float* rows = reinterpret_cast<float*>(dyn + place_bytes(stretch) + list_bytes(stretch));
  unsigned* first_words = reinterpret_cast<unsigned*>(&first[0][0]);

  for (int i = t; i < kWarps * kRow / 2; i += kThreads) first_words[i] = 0;
  __syncthreads();

  // ---- 1. places in the slice, and the warp's count of each segment -------
  unsigned* counts = first_words + warp * (kRow / 2);
  for (int p0 = lo; p0 < hi; p0 += 32 * kBatch) {
    Id id[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + 32 * u + lane;
      id[u] = p < hi ? ids[p] : Id(-1);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + 32 * u + lane;
      const bool in = id[u] >= s_lo && id[u] < s_lo + n_seg;
      const int j = static_cast<int>(id[u] - s_lo);
      if (p < hi) place[p - b_lo] = in ? static_cast<uint16_t>(j) : kOut;
      if (in) atomicAdd(counts + (j >> 1), 1u << (16 * (j & 1)));
    }
  }
  __syncthreads();

  // ---- 2. each warp's first slot in each run; the runs' starts ------------
  {
    // warp g scans segments g, g + kWarps, ..., lane w holding warp w's
    // count, all kSlice / kWarps scans side by side
    constexpr int kPer = kSlice / kWarps;
    int c[kPer], incl[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) incl[k] = c[k] = first[lane][warp + k * kWarps];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int y = __shfl_up_sync(0xffffffffu, incl[k], off);
        if (lane >= off) incl[k] += y;
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      first[lane][warp + k * kWarps] = static_cast<uint16_t>(incl[k] - c[k]);
      if (lane == 31) run_start[1 + warp + k * kWarps] = incl[k];  // the count, for now
    }
  }
  __syncthreads();
  if (warp == 0) {  // the counts' exclusive scan, kSlice / 32 a lane
    constexpr int kPer = kSlice / 32;
    int c[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      c[k] = run_start[1 + lane * kPer + k];
      sum += c[k];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      run += c[k];
      run_start[1 + lane * kPer + k] = run;
    }
    if (lane == 0) run_start[0] = 0;
  }
  __syncthreads();

  // ---- 3. each point into its run's next slot ------------------------------
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    const int j = p < hi ? place[p - b_lo] : kOut;
    const unsigned hits = __ballot_sync(0xffffffffu, j != kOut);
    if (hits == 0) continue;  // the same in every lane
    const unsigned group = __match_any_sync(0xffffffffu, j);  // a hit's group
    if (j != kOut) list[run_start[j] + first[warp][j] + __popc(group & below)] = p;
    __syncwarp();
    if (j != kOut && (group & below) == 0) first[warp][j] += __popc(group);
    __syncwarp();
  }
  __syncthreads();

  // ---- 4. the block's sums, a tile of rows at a time -----------------------
  const int total = run_start[kSlice];
  float acc[kItems];
#pragma unroll
  for (int h = 0; h < kItems; ++h) acc[h] = 0.0f;
  for (int base = 0; base < total; base += kTile) {
    const int n = min(kTile, total - base);
    for (int i0 = t; i0 < n * CH; i0 += kThreads * kGather) {
      float v[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n * CH) {
          const int r = i / CH;
          v[u] = values[static_cast<size_t>(list[base + r]) * CH + (i - r * CH)];
        }
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n * CH) rows[i] = v[u];
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kItems; ++h) {
      const int i = t + h * kThreads;
      const int j = i / CH, c = i - j * CH;
      if (j < n_seg) {
        const int e = min(run_start[j + 1], base + n) - base;
        for (int r = max(run_start[j], base) - base; r < e; ++r) acc[h] += rows[r * CH + c];
      }
    }
    __syncthreads();
  }

  // ---- 5. each segment's kCluster sums, added in rank order by the block
  // that writes it (segment j: block j / kOwn) -------------------------------
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
#pragma unroll
  for (int h = 0; h < kItems; ++h) {
    const int i = t + h * kThreads;
    const int j = i / CH;
    if (j < n_seg) {
      const int owner = j / kOwn;
      cluster.map_shared_rank(&partial[rank][0], owner)[i - owner * kOwn * CH] = acc[h];
    }
  }
  cluster.sync();
  const int own_lo = min(rank * kOwn, n_seg), own_hi = min(own_lo + kOwn, n_seg);
  if (t < (own_hi - own_lo) * CH) {
    float sum = partial[0][t];
#pragma unroll
    for (int r = 1; r < kCluster; ++r) sum += partial[r][t];
    out[static_cast<size_t>(s_lo + own_lo) * CH + t] = sum;
  }
}

template <typename Id>
int launch(const float* values, const Id* ids, float* out, int P, int S, int CH,
           void* stream) {
  if (CH < 1 || CH > kMaxChannels || P < 0 || P > kMaxPoints || S < 0 ||
      S > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0) return static_cast<int>(cudaGetLastError());
  const int stretch = (P + kCluster - 1) / kCluster;
  const int bytes = place_bytes(stretch) + list_bytes(stretch) + kTile * CH * 4;
  // once per process: the most dynamic shared memory any shape needs
  constexpr int kMaxStretch = kMaxPoints / kCluster;
  static const cudaError_t set = cudaFuncSetAttribute(
      segment_sum_kernel<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      place_bytes(kMaxStretch) + list_bytes(kMaxStretch) + kTile * kMaxChannels * 4);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slices = (S + kSlice - 1) / kSlice;
  segment_sum_kernel<Id><<<slices * kCluster, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(values, ids, out, P,
                                                                S, CH);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values (P, CH) float32 with CH <= 16, ids (P,) int32 (segment_sum_i32_f32)
// or int64 (segment_sum_i64_f32) -> out (S, CH) float32; all contiguous on
// the device; P <= 2^17, S <= 2^16.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int segment_sum_i32_f32(const float* values, const int* ids, float* out,
                                   int P, int S, int CH, void* stream) {
  return launch(values, ids, out, P, S, CH, stream);
}

extern "C" int segment_sum_i64_f32(const float* values, const long long* ids,
                                   float* out, int P, int S, int CH, void* stream) {
  return launch(values, ids, out, P, S, CH, stream);
}
