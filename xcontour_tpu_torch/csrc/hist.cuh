// K2's first-pass layout and bin search, shared with its structure probe
// P2 (probes.cu): 8 warps a block, each lane loading kUnroll cells before
// it uses them, the bin found from a guess checked against the edges.
#pragma once

#include <cuda_runtime.h>

namespace xc_hist {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // cells a lane loads before it adds them

// bin of a value with e[0] <= x <= e[N]
__device__ __forceinline__ int find_bin(const float* e, int N, float x) {
  if (x == e[N]) return N - 1;
  int lo = 1, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// the same bin, starting from the bin that evenly spaced edges would give
// (inv = N / (e[N] - e[0]), or 0): the guess and its neighbours are checked
// against the edges, so the bin is always the comparisons' one; a guess
// more than one bin off (uneven edges) falls back to the search
__device__ __forceinline__ int find_bin_guess(const float* e, int N, float x,
                                              float inv) {
  if (x == e[N]) return N - 1;
  const float gf = fminf(fmaxf((x - e[0]) * inv, 0.0f), (float)(N - 1));
  const int k = (int)gf;
  if (e[k] <= x) {
    if (k == N - 1 || x < e[k + 1]) return k;
    if (k + 1 == N - 1 || x < e[k + 2]) return k + 1;
  } else if (k > 0 && e[k - 1] <= x) {
    return k - 1;
  }
  return find_bin(e, N, x);
}

}  // namespace xc_hist
