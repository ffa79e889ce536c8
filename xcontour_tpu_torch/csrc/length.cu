// K7-K8: marching-squares contour lengths.
//
// K7 replaces xcontour_tpu/kernels/length_pallas.py, _kernel (launched by
// contour_lengths_pallas): the total perimeter of each contour level of each
// batch element,
//
//   out[b, n] = sum over cells of the in-cell segment lengths at levels[b, n],
//
// with skimage's fully_connected='low' saddles, no segment in a cell with a
// NaN corner, haversine (unit sphere, radians) or hypot lengths, and 0 for a
// level that crosses nothing (the caller makes it NaN).
//
// K8 replaces xcontour_tpu/kernels/length_pallas.py, _local_kernel (launched
// by local_lengths_pallas): the length inside each (W x W)-cell window of a
// 2-D field at that window's own level, 0 for a NaN level.
//
// The tie rule.  An endpoint-pinned level (a level equal to a corner value)
// must give segments of exactly zero length, so that an empty contour totals
// exactly 0.  Edge fractions are therefore computed by IEEE division, as the
// XLA twin does (diagnostics/length.py:77-79): a level equal to the far
// corner gives (vb - va) / (vb - va) = 1 exactly.  The TPU kernels multiply
// by a precomputed reciprocal, x * (1/x) is not always 1, and a few ulps of
// length survive.  Vertices are offsets from the cell's (y0, x0) corner,
// f * extent, so f = 0 and f = 1 land bitwise on the corners (0 and the
// extent itself), and a segment between two equal vertices has length 0.
// Built without --use_fast_math, so '/' rounds correctly.
//
// Geodesic lengths use the haversine with sinf/cosf/asinf.  Differences of
// latitude and longitude are taken between the offsets, which are small and
// carry full relative precision; cos(lat) at each end is cosf(y0 + offset).
// No cell size bounds the kernel (the TPU's Maclaurin series did).
//
// Bound on the H100: FP32 issue, per (cell, level) pair that the level can
// cross.  K7 therefore keeps the TPU's pretest: the wrapper sorts each batch
// element's levels, and each (RB x CB)-cell tile takes the min and max of
// its valid corners and finds, by binary search, the contiguous range
// [n0, n1) of sorted levels within [min, max).  A zonally banded field
// crosses few levels per tile.
//
// K7 design: a block per tile, 16 cell rows x 128 cell columns, 256 threads.
// A thread owns one column and 8 consecutive cells of it, and keeps their
// 9 x 2 corner values and row coordinates in registers across the level
// loop.  Per level, a warp shuffle sums the 32 threads' partial lengths and
// lane 0 stores it in shared memory; after each chunk of up to 512 levels
// the block sums its 8 warps in order and writes the tile's partial totals.
// A second kernel, a warp per (b, n), sums the active tiles in a fixed
// order.  No float atomics: two runs agree bitwise.  Offsets are 64-bit.
//
// K8 design: a block per window reads the window straight from the (Ny, Nx)
// field at its anchor (oy, ox) = (wy, wx) * stride (no patch stack), each
// thread walks cells with a stride of 256, and the block sums in a fixed
// order.  Neighbouring windows overlap, so the field is read from L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRB = 16;                            // cell rows of a K7 tile
constexpr int kCB = 128;                           // cell columns of a K7 tile
constexpr int kRows = kRB / (kThreads / kCB);      // cells per thread: 8
constexpr int kLevelChunk = 512;

struct Pt {
  float y, x;  // offsets from the cell's (y0, x0) corner
};

__device__ __forceinline__ float frac(float lev, float va, float vb) {
  const float d = vb - va;
  return d == 0.f ? 0.f : (lev - va) / d;
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

// Length of the level's segments in one valid cell that the level crosses
// (code: bit k set where corner k of 00, 01, 10, 11 lies above the level;
// not 0, not 15): corners v00 (y0, x0), v01 (y0, x1), v10 (y1, x0), v11
// (y1, x1); extents dy = y1 - y0 and dx = x1 - x0.  Endpoints are selected
// first and each segment measured once, as in the twin.  Kept out of line:
// inlined into the unrolled cell loop with a per-case segment, K7 measured
// 37x slower at ERA5 on an H100.
template <bool kLatlon>
__device__ __noinline__ float crossing_length(float lev, float v00, float v01,
                                              float v10, float v11, float y0,
                                              float dy, float dx, int code) {
  const Pt top{0.f, frac(lev, v00, v01) * dx};
  const Pt bot{dy, frac(lev, v10, v11) * dx};
  const Pt lef{frac(lev, v00, v10) * dy, 0.f};
  const Pt rig{frac(lev, v01, v11) * dy, dx};
  // isolated corner 00: 1, 14; 01: 2, 13; 10: 4, 11; 11: 8, 7; horizontal
  // 3, 12; vertical 5, 10; saddles ('low': high corners cut off one by
  // one) 9 (00 and 11 high) and 6 (01 and 10 high)
  const bool horiz = code == 3 || code == 12;
  const bool verti = code == 5 || code == 10;
  const bool iso10 = code == 4 || code == 11;
  const bool iso11 = code == 8 || code == 7;
  const bool to_lef = code == 1 || code == 14 || iso10 || code == 9;
  const Pt p1 = horiz ? lef : (iso10 || iso11 ? bot : top);
  const Pt q1 = to_lef ? lef : (verti ? bot : rig);
  float len = seg_len<kLatlon>(p1, q1, y0);
  if (code == 9 || code == 6)
    len += seg_len<kLatlon>(bot, code == 9 ? rig : lef, y0);
  return len;
}

// 0 when the level does not cross the (valid) cell, else its length.
template <bool kLatlon>
__device__ __forceinline__ float cell_length(float lev, float v00, float v01,
                                             float v10, float v11, float y0,
                                             float dy, float dx) {
  const int code = (v00 > lev) | ((v01 > lev) << 1) | ((v10 > lev) << 2) |
                   ((v11 > lev) << 3);
  if (code == 0 || code == 15) return 0.f;
  return crossing_length<kLatlon>(lev, v00, v01, v10, v11, y0, dy, dx, code);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// Number of sorted levels (NaN last) below x: NaN is never below x, so
// the predicate is monotone along the sorted row.
__device__ int count_below(const float* lev, int N, float x) {
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lev[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool kLatlon>
__global__ void __launch_bounds__(kThreads)
lengths_tile_kernel(const float* __restrict__ data,
                    const float* __restrict__ levs, int* __restrict__ n0s,
                    int* __restrict__ n1s, const float* __restrict__ ycoord,
                    const float* __restrict__ xcoord, long long ystride,
                    long long xstride, float* __restrict__ partial, int Ny,
                    int Nx, int N, int tiles, int n_cb) {
  __shared__ float wsum[kWarps][kLevelChunk];
  __shared__ float wlo[kWarps], whi[kWarps];
  __shared__ int range[2];
  const int b = blockIdx.y;
  const long long tile = (long long)b * tiles + blockIdx.x;
  const int rb = blockIdx.x / n_cb;
  const int cb = blockIdx.x % n_cb;
  const int tx = threadIdx.x % kCB;
  const int c = cb * kCB + tx;
  const int r0 = rb * kRB + (threadIdx.x / kCB) * kRows;
  const float* db = data + (long long)b * Ny * Nx;
  const float* yb = ycoord + b * ystride;
  const float* xb = xcoord + b * xstride;
  const float* lb = levs + (long long)b * N;
  const bool col_ok = c < Nx - 1;
  const float dx = col_ok ? xb[c + 1] - xb[c] : 0.f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float vl[kRows + 1], vr[kRows + 1], yy[kRows + 1];
#pragma unroll
  for (int i = 0; i <= kRows; ++i) {
    const int r = r0 + i;
    const bool ok = col_ok && r < Ny;
    vl[i] = ok ? db[(long long)r * Nx + c] : NAN;
    vr[i] = ok ? db[(long long)r * Nx + c + 1] : NAN;
    yy[i] = r < Ny ? yb[r] : 0.f;
  }
  // the pretest: the valid cells' corner [min, max) gives the range
  // [n0, n1) of sorted levels that can cross the tile; a tile of NaN cells
  // has min +inf and max -inf, so its range is empty
  unsigned valid = 0;
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const bool ok = !(isnan(vl[i]) || isnan(vr[i]) || isnan(vl[i + 1]) ||
                      isnan(vr[i + 1]));
    valid |= (unsigned)ok << i;
    if (ok) {
      lo = fminf(lo, fminf(fminf(vl[i], vr[i]), fminf(vl[i + 1], vr[i + 1])));
      hi = fmaxf(hi, fmaxf(fmaxf(vl[i], vr[i]), fmaxf(vl[i + 1], vr[i + 1])));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    wlo[warp] = lo;
    whi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      lo = fminf(lo, wlo[w]);
      hi = fmaxf(hi, whi[w]);
    }
    const int a0 = count_below(lb, N, lo);
    const int a1 = max(a0, count_below(lb, N, hi));
    range[0] = a0;
    range[1] = a1;
    n0s[tile] = a0;
    n1s[tile] = a1;
  }
  __syncthreads();
  const int n0 = range[0];
  const int n1 = range[1];

  float* pb = partial + tile * N;
  for (int base = n0; base < n1; base += kLevelChunk) {
    const int cnt = min(kLevelChunk, n1 - base);
    for (int k = 0; k < cnt; ++k) {
      const float lev = lb[base + k];
      float s = 0.f;
      if (valid) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if ((valid >> i) & 1u)
            s += cell_length<kLatlon>(lev, vl[i], vr[i], vl[i + 1], vr[i + 1],
                                      yy[i], yy[i + 1] - yy[i], dx);
      }
      s = warp_sum(s);
      if (lane == 0) wsum[warp][k] = s;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += wsum[w][k];
      pb[base + k] = t;
    }
    __syncthreads();
  }
}

// out[b, n]: a warp per (b, n) sums the tiles whose range holds n, lane l
// taking tiles l, l + 32, ..., then a fixed shuffle tree.
__global__ void lengths_sum_kernel(const float* __restrict__ partial,
                                   const int* __restrict__ n0s,
                                   const int* __restrict__ n1s,
                                   float* __restrict__ out, int B, int N,
                                   int tiles) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= (long long)B * N) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const long long t0 = (w / N) * tiles;
  const int n = (int)(w % N);
  float acc = 0.f;
  for (int t = lane; t < tiles; t += 32) {
    if (n >= n0s[t0 + t] && n < n1s[t0 + t])
      acc += partial[(t0 + t) * N + n];
  }
  acc = warp_sum(acc);
  if (lane == 0) out[w] = acc;
}

template <bool kLatlon>
__global__ void __launch_bounds__(kThreads)
local_lengths_kernel(const float* __restrict__ data,
                     const float* __restrict__ levels,
                     const float* __restrict__ ycoord,
                     const float* __restrict__ xcoord,
                     float* __restrict__ out, int Nx, int Wx, int W,
                     int stride) {
  __shared__ float wsum[kWarps];
  const long long w = (long long)blockIdx.y * Wx + blockIdx.x;
  const float lev = levels[w];
  if (isnan(lev)) {  // the whole block
    if (threadIdx.x == 0) out[w] = 0.f;
    return;
  }
  const long long oy = (long long)blockIdx.y * stride;
  const long long ox = (long long)blockIdx.x * stride;
  float s = 0.f;
  for (int k = threadIdx.x; k < W * W; k += kThreads) {
    const long long r = oy + k / W;
    const long long c = ox + k % W;
    const float* p = data + r * Nx + c;
    const float v00 = p[0], v01 = p[1], v10 = p[Nx], v11 = p[Nx + 1];
    if (isnan(v00) || isnan(v01) || isnan(v10) || isnan(v11)) continue;
    const float y0 = ycoord[r];
    s += cell_length<kLatlon>(lev, v00, v01, v10, v11, y0, ycoord[r + 1] - y0,
                              xcoord[c + 1] - xcoord[c]);
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += wsum[i];
    out[w] = t;
  }
}

}  // namespace

// data (B, Ny, Nx); levels (B, N) sorted ascending, NaN last; n0/n1
// (B, n_rb * n_cb) int32 scratch for the tiles' level ranges; y (B or 1, Ny)
// and x (B or 1, Nx) coordinates; partial (B, n_rb * n_cb, N) scratch;
// out (B, N) sorted totals.
extern "C" int xc_contour_lengths(const void* data, const void* levels,
                                  void* n0, void* n1,
                                  const void* y, const void* x, void* partial,
                                  void* out, int B, int Ny, int Nx, int N,
                                  int n_rb, int n_cb, int y_batched,
                                  int x_batched, int latlon, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = n_rb * n_cb;
  const dim3 grid(tiles, B);
  const long long ys = y_batched ? Ny : 0;
  const long long xs = x_batched ? Nx : 0;
  if (latlon)
    lengths_tile_kernel<true><<<grid, kThreads, 0, st>>>(
        (const float*)data, (const float*)levels, (int*)n0, (int*)n1,
        (const float*)y, (const float*)x, ys, xs,
        (float*)partial, Ny, Nx, N, tiles, n_cb);
  else
    lengths_tile_kernel<false><<<grid, kThreads, 0, st>>>(
        (const float*)data, (const float*)levels, (int*)n0, (int*)n1,
        (const float*)y, (const float*)x, ys, xs,
        (float*)partial, Ny, Nx, N, tiles, n_cb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)B * N;
  lengths_sum_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps), kThreads, 0,
                       st>>>((const float*)partial, (const int*)n0,
                             (const int*)n1, (float*)out, B, N, tiles);
  return (int)cudaGetLastError();
}

// data (Ny, Nx); levels (Wy, Wx); y (Ny,), x (Nx,); out (Wy, Wx) raw
// totals of the windows of `window` points anchored every `stride` points.
extern "C" int xc_local_lengths(const void* data, const void* levels,
                                const void* y, const void* x, void* out,
                                int Ny, int Nx, int Wy, int Wx, int window,
                                int stride, int latlon, void* stream) {
  (void)Ny;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(Wx, Wy);
  if (latlon)
    local_lengths_kernel<true><<<grid, kThreads, 0, st>>>(
        (const float*)data, (const float*)levels, (const float*)y,
        (const float*)x, (float*)out, Nx, Wx, window - 1, stride);
  else
    local_lengths_kernel<false><<<grid, kThreads, 0, st>>>(
        (const float*)data, (const float*)levels, (const float*)y,
        (const float*)x, (float*)out, Nx, Wx, window - 1, stride);
  return (int)cudaGetLastError();
}
