// K7's tiles and the marching-squares arithmetic of K7 and K8, shared with
// K7's structure probe P3 (probes.cu): the segment table, edge points and
// lengths, the level searches, the block scan of the pair queue, and the
// walk of a tile's crossed (cell, level) pairs that K7 and P3 both run
// (walk_tile).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace xc_length {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// K7's tiles
constexpr int kRB = 16;                            // cell rows of a tile
constexpr int kCB = 128;                           // cell columns of a tile
constexpr int kRows = kRB / (kThreads / kCB);      // cells per thread: 8
constexpr int kLevelChunk = 1024;                  // sorted levels a pass holds
constexpr int kLevelBits = 10;                     // log2(kLevelChunk)
constexpr int kQueue = 2048;                       // pairs a round measures
constexpr int kMinBlocks = 4;                      // 64 registers a thread

// The segments of each marching-squares case (code: bit k set where corner
// k of 00, 01, 10, 11 lies above the level), 4 bits a code: the edges of
// the first segment's two ends, p | q << 2, with edges 0 top (00-01),
// 1 bottom (10-11), 2 left (00-10), 3 right (01-11).  The saddles ('low':
// high corners cut off one by one) 6 (01 and 10 high) and 9 (00 and 11
// high) add a segment from the bottom edge to the left (6) or right (9).
constexpr unsigned long long kSegTable = 0x08ce948ddc49ec80ull;

struct Pt {
  float y, x;  // offsets from the cell's (y0, x0) corner
};

__device__ __forceinline__ float frac(float lev, float va, float vb) {
  const float d = vb - va;
  return d == 0.f ? 0.f : (lev - va) / d;
}

// the level's point on an edge: top (0, f dx), bottom (dy, f dx), left
// (f dy, 0), right (f dy, dx); one division whichever edge
__device__ __forceinline__ Pt edge_point(int edge, float lev, float v00,
                                         float v01, float v10, float v11,
                                         float dy, float dx) {
  const float va = edge == 1 ? v10 : (edge == 3 ? v01 : v00);
  const float vb = edge == 0 ? v01 : (edge == 2 ? v10 : v11);
  const float f = frac(lev, va, vb);
  if (edge < 2) return Pt{edge == 1 ? dy : 0.f, f * dx};
  return Pt{f * dy, edge == 3 ? dx : 0.f};
}

template <bool kLatlon>
__device__ __forceinline__ float seg_len(Pt p, Pt q, float y0) {
  const float dy = p.y - q.y;
  const float dx = p.x - q.x;
  if (!kLatlon) return hypotf(dy, dx);
  const float sl = sinf(0.5f * dy);
  const float sn = sinf(0.5f * dx);
  float a = sl * sl + (cosf(y0 + p.y) * cosf(y0 + q.y)) * (sn * sn);
  a = fminf(fmaxf(a, 0.f), 1.f);
  return 2.f * asinf(sqrtf(a));
}

// Length of the level's segments in a valid cell it crosses (code not 0,
// not 15): corners v00 (y0, x0), v01 (y0, x1), v10 (y1, x0), v11 (y1, x1);
// extents dy = y1 - y0 and dx = x1 - x0.
template <bool kLatlon>
__device__ __forceinline__ float crossing_length(float lev, float v00,
                                                 float v01, float v10,
                                                 float v11, float y0,
                                                 float dy, float dx,
                                                 int code) {
  const int seg = (int)(kSegTable >> (4 * code)) & 15;
  const Pt p = edge_point(seg & 3, lev, v00, v01, v10, v11, dy, dx);
  const Pt q = edge_point(seg >> 2, lev, v00, v01, v10, v11, dy, dx);
  float len = seg_len<kLatlon>(p, q, y0);
  if (code == 6 || code == 9) {
    const Pt p2 = edge_point(1, lev, v00, v01, v10, v11, dy, dx);
    const Pt q2 = edge_point(code == 9 ? 3 : 2, lev, v00, v01, v10, v11, dy,
                             dx);
    len += seg_len<kLatlon>(p2, q2, y0);
  }
  return len;
}

__device__ __forceinline__ int cell_code(float lev, float v00, float v01,
                                         float v10, float v11) {
  return (v00 > lev) | ((v01 > lev) << 1) | ((v10 > lev) << 2) |
         ((v11 > lev) << 3);
}

__device__ __forceinline__ bool any_nan(float a, float b, float c, float d) {
  return isnan(a) || isnan(b) || isnan(c) || isnan(d);
}

// Number of sorted levels (NaN last) below x: NaN is never below x, so
// the predicate is monotone along the sorted row.
__device__ __forceinline__ int count_below(const float* lev, int N, float x) {
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lev[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same count by the 32 lanes of a warp: a 32-way search (each step
// tests 32 pivots and keeps the stretch between the last below x and the
// first not below), then one load a lane over the last 32 levels.
__device__ __forceinline__ int warp_count_below(const float* lev, int N,
                                                float x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = N;  // the count lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int k = __popc(__ballot_sync(kFull, p < hi && lev[p] < x));
    const int nlo = k > 0 ? lo + (k - 1) * step + 1 : lo;
    hi = min(hi, lo + k * step);
    lo = nlo;
  }
  return lo + __popc(__ballot_sync(kFull, lo + lane < hi && lev[lo + lane] < x));
}

// count_below over levels l0 + i / inv, guessed and checked against the
// levels themselves (so the count is always the comparisons' one), the
// guess and its neighbours, else the binary search
__device__ __forceinline__ int count_below_guess(const float* lev, int N,
                                                 float x, float l0,
                                                 float inv) {
  const int g = (int)fminf(fmaxf(ceilf((x - l0) * inv), 0.f), (float)N);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int c = d == 0 ? g : (d == 1 ? g - 1 : g + 1);
    if (c >= 0 && c <= N && (c == 0 || lev[c - 1] < x) &&
        (c == N || !(lev[c] < x)))
      return c;
  }
  return count_below(lev, N, x);
}

// exclusive block scan of one int a thread; *total gets the block's sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* wtot,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? wtot[w] : 0;
    all += wtot[w];
  }
  *total = all;
  __syncthreads();  // wtot is reused by the next scan
  return before + incl - v;
}

// K7's and P3's walk of one tile, a block per tile of kRB x kCB cells of
// one batch element, thread t owning column t % kCB, rows (t / kCB) x
// kRows + i: the corners and coordinates staged, each cell's corner range,
// the tile's range [n0, n1) of sorted levels, then chunks of kLevelChunk
// levels, each cell's crossed levels of the chunk, the block scan and the
// shared queue of crossed pairs, kQueue a round.  For each chunk:
// begin(cnt) before the barrier that publishes it, add(k, len) for each
// crossed pair (level k of the chunk, its segment's length), end(base,
// cnt) after its last round, then a barrier.
template <bool kLatlon, class Begin, class Add, class End>
__device__ __forceinline__ void walk_tile(
    const float* __restrict__ data, const float* __restrict__ levs,
    const float* __restrict__ ycoord, const float* __restrict__ xcoord,
    long long ystride, long long xstride, int Ny, int Nx, int N, int tiles,
    int n_cb, Begin begin, Add add, End end) {
  __shared__ float sv[kRB + 1][kCB + 1];   // corners, NaN outside the field
  __shared__ float sy[kRB + 1], sx[kCB + 1];
  __shared__ float slev[kLevelChunk];
  __shared__ int queue[kQueue];            // cell << kLevelBits | level
  __shared__ float red[2][kWarps];
  __shared__ int wtot[kWarps];
  __shared__ int info[2];                  // the tile's level range
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x - b * tiles;
  const int rb = t / n_cb;
  const int row0 = rb * kRB, col0 = (t - rb * n_cb) * kCB;
  const float* db = data + (long long)b * Ny * Nx;
  const float* yb = ycoord + b * ystride;
  const float* xb = xcoord + b * xstride;
  const float* lb = levs + (long long)b * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < (kRB + 1) * (kCB + 1); i += kThreads) {
    const int r = i / (kCB + 1), c = i - r * (kCB + 1);
    const int gr = row0 + r, gc = col0 + c;
    sv[r][c] = gr < Ny && gc < Nx ? db[(long long)gr * Nx + gc] : NAN;
  }
  if (threadIdx.x <= kRB)
    sy[threadIdx.x] = row0 + threadIdx.x < Ny ? yb[row0 + threadIdx.x] : 0.f;
  if (threadIdx.x <= kCB)
    sx[threadIdx.x] = col0 + threadIdx.x < Nx ? xb[col0 + threadIdx.x] : 0.f;
  __syncthreads();

  // each cell's corner [lo, hi) (empty for a cell with a NaN corner or
  // outside the field), and the tile's
  const int tx = threadIdx.x % kCB;
  const int r0 = (threadIdx.x / kCB) * kRows;
  float lo[kRows], hi[kRows];
  float tlo = INFINITY, thi = -INFINITY;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    const float v00 = sv[r][tx], v01 = sv[r][tx + 1];
    const float v10 = sv[r + 1][tx], v11 = sv[r + 1][tx + 1];
    const bool ok = !any_nan(v00, v01, v10, v11);
    lo[i] = ok ? fminf(fminf(v00, v01), fminf(v10, v11)) : INFINITY;
    hi[i] = ok ? fmaxf(fmaxf(v00, v01), fmaxf(v10, v11)) : -INFINITY;
    tlo = fminf(tlo, lo[i]);
    thi = fmaxf(thi, hi[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tlo = fminf(tlo, __shfl_xor_sync(kFull, tlo, o));
    thi = fmaxf(thi, __shfl_xor_sync(kFull, thi, o));
  }
  if (lane == 0) {
    red[0][warp] = tlo;
    red[1][warp] = thi;
  }
  __syncthreads();
  // the tile's range [n0, n1) of sorted levels, by warp 0 (each lane the
  // tile's values: the search is the warp's)
  if (warp == 0) {
    tlo = lane < kWarps ? red[0][lane] : INFINITY;
    thi = lane < kWarps ? red[1][lane] : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tlo = fminf(tlo, __shfl_xor_sync(kFull, tlo, o));
      thi = fmaxf(thi, __shfl_xor_sync(kFull, thi, o));
    }
    const int a0 = warp_count_below(lb, N, tlo);
    const int a1 = max(a0, warp_count_below(lb, N, thi));
    if (lane == 0) {
      info[0] = a0;
      info[1] = a1;
    }
  }
  __syncthreads();
  const int n0 = info[0], n1 = info[1];

  for (int base = n0; base < n1; base += kLevelChunk) {
    const int cnt = min(kLevelChunk, n1 - base);
    for (int k = threadIdx.x; k < cnt; k += kThreads) slev[k] = lb[base + k];
    begin(cnt);
    __syncthreads();
    // each cell's crossed levels [a, a + m) of the chunk (all finite: the
    // tile's range holds no NaN), the count below a value guessed as if
    // the levels were evenly spaced, then checked
    const float l0 = slev[0], span = slev[cnt - 1] - l0;
    const float inv = span > 0.f ? (float)(cnt - 1) / span : 0.f;
    int a[kRows], m[kRows], mine = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      a[i] = 0;
      m[i] = 0;
      if (lo[i] <= hi[i]) {
        a[i] = count_below_guess(slev, cnt, lo[i], l0, inv);
        m[i] = count_below_guess(slev, cnt, hi[i], l0, inv) - a[i];
        mine += m[i];
      }
    }
    int pairs;
    const int off = block_exclusive_scan(mine, wtot, &pairs);
    for (int q0 = 0; q0 < pairs; q0 += kQueue) {
      // queue the pairs whose slot falls in this round
      int s = off;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int j0 = max(0, q0 - s), j1 = min(m[i], q0 + kQueue - s);
        const int cell = (r0 + i) * kCB + tx;
        for (int j = j0; j < j1; ++j)
          queue[s + j - q0] = (cell << kLevelBits) | (a[i] + j);
        s += m[i];
      }
      __syncthreads();
      const int nq = min(kQueue, pairs - q0);
      for (int p = threadIdx.x; p < nq; p += kThreads) {
        const int e = queue[p];
        const int k = e & (kLevelChunk - 1);
        const int r = (e >> kLevelBits) / kCB;
        const int c = (e >> kLevelBits) % kCB;
        const float v00 = sv[r][c], v01 = sv[r][c + 1];
        const float v10 = sv[r + 1][c], v11 = sv[r + 1][c + 1];
        const float lev = slev[k];
        add(k, crossing_length<kLatlon>(
                   lev, v00, v01, v10, v11, sy[r], sy[r + 1] - sy[r],
                   sx[c + 1] - sx[c], cell_code(lev, v00, v01, v10, v11)));
      }
      __syncthreads();
    }
    end(base, cnt);
    __syncthreads();
  }
}

}  // namespace xc_length
