// Transposing warp sum of several values per lane, in a fixed order.
//
// Each lane brings N values (terms 0 .. N-1).  At each xor step of offset
// OFF (16, 8, 4, 2, 1) the lanes of the lower half keep the first
// ceil(N / 2) of their values and the lanes of the upper half the rest
// (padded with zeros), each adding its partner's copy of the values it
// keeps, so a step costs ceil(N / 2) shuffles instead of N.  Once a lane is
// down to one value it is summed over the remaining offsets.  Ten values
// take 5 + 3 + 2 + 1 + 1 = 12 shuffles (a shuffle tree per value: 50);
// 64 take 62 (320).
//
// After the steps each lane holds fold_width(N, 16) values: the warp's sums
// of the terms out_base + j for j < out_n (out_n is 0 for a lane that holds
// only padding or a copy that another lane also holds).  Every sum is taken
// in an order fixed by the lane numbers alone, and padding never meets a
// real term, so a NaN stays in its own term.

#pragma once

__host__ __device__ constexpr int fold_width(int n, int off) {
  return (off == 0 || n == 1) ? n : fold_width((n + 1) / 2, off / 2);
}

template <int N, int OFF>
__device__ __forceinline__ void warp_fold(const float (&v)[N], int lane, int base,
                                          int n, float (&out)[fold_width(N, OFF)],
                                          int& out_base, int& out_n) {
  if constexpr (OFF == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = v[j];
    out_base = base;
    out_n = n;
  } else if constexpr (N == 1) {
    float x = v[0];
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    out[0] = x;
    out_base = base;
    // the lanes that differ only in the bits summed here hold copies
    out_n = (lane & (2 * OFF - 1)) == 0 ? n : 0;
  } else {
    constexpr int M = (N + 1) / 2;
    const bool up = (lane & OFF) != 0;
    float kept[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float lo = v[j];
      const float hi = M + j < N ? v[M + j < N ? M + j : 0] : 0.0f;
      kept[j] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, OFF);
    }
    warp_fold<M, OFF / 2>(kept, lane, up ? base + M : base,
                          up ? (n > M ? n - M : 0) : (n < M ? n : M), out,
                          out_base, out_n);
  }
}
