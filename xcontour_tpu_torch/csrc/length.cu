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
// by local_lengths_pallas): the length inside each (W x W)-cell window of
// each 2-D field of a batch at that window's own level, 0 for a NaN level.
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
// Bound on the H100: FP32 issue.  A (cell, level) pair costs a few compares
// to classify, and a crossed pair one or two segments (two edge fractions,
// each an IEEE division, and a haversine or a hypot per segment).  The
// level crosses the valid cell exactly when min <= level < max of its
// corners, so both kernels find the crossed pairs from corner ranges and
// measure only those, 32 to a warp: a crossed pair met by one lane of a
// warp that classifies cells would keep the other 31 waiting through its
// segment arithmetic.
//
// Totals are 64-bit fixed point: each length rounded up (a positive length
// never vanishes, a zero one stays zero) at a scale 2^scale, added by
// integer atomics, whose order does not change the bits, so two runs agree
// bit for bit.  A first one-block kernel sets the scale from the
// coordinates: a segment is at most the largest row spacing plus the
// largest column spacing, ext < 2^e, and scale = 62 - ceil(log2(2 cells))
// - e keeps a total of `cells` cells of two segments under 2^62 (a quantum
// of 2^-41 ext at ERA5's 720 x 1439 cells).  A non-finite length sets the
// top bit, and that total becomes NaN.  A last kernel turns the totals into
// floats (K7: back into the caller's level order).
//
// K7 design: a block per tile of 16 cell rows x 128 cell columns (grid x
// = batch x tiles), 256 threads, each owning 8 cells of one column.  The
// block stages the tile's 17 x 129 corners and its coordinates in shared
// memory, reduces its valid corners' [min, max), and warp 0 finds the
// range [n0, n1) of sorted levels that can cross it by a 32-way search.
// Per chunk of up to 1024 of those levels (staged), each cell counts the
// chunk's levels below its min and below its max, from the index evenly
// spaced levels would give, checked against the levels (binary search
// where that misses); a block scan of the cells' crossed counts gives each
// (cell, level) pair a slot in a shared-memory queue, and every thread
// measures queued pairs, t, t + 256, ...  Lane l adds into copy l % ncopy
// of the chunk's totals (the lanes measuring one contour's pairs hit
// different words), the copies are folded, and one atomic a level adds
// the tile's total.  At most 64 registers a thread (4 blocks an SM): the
// kernel is latency-bound, and the cap measured 0.27 ms against 0.44 at
// 96 registers (ERA5, N = 121).
//
// K8 design: the windows overlap (window 101, stride 10: a cell lies in up
// to 100 windows), so each cell is read once, not once a window.  A warp
// per block of stride x stride cells on the windows' lattice (8 a block;
// a large block is cut into slabs of 8 steps of 32 cells, a warp each, so
// that a few large blocks still fill the card) takes its cells 2 steps of
// 32 at a time (lane map of min(stride, 32) columns, no division a cell),
// keeps each cell's corner [lo, hi) in registers and reduces the steps'
// [min, max): the pretest, shared by the up to 100 windows that cover the
// block.  It tests those windows' levels
// against the range, 32 at a time, and for each that passes classifies its
// cells against the level, clipped to the window (a block a window covers
// in part is tested whole: a superset), appending the crossed ones (ballot,
// population count) to a queue of 64 in shared memory; whenever 32 are
// queued, every lane measures one (corners and coordinates reloaded
// through L1) and adds it to its window's total.  At most 64 registers a
// thread.  A batch of fields is one launch (one per 65,535 fields): grid y
// is the field, each field's windows keep their own totals, so a slice of
// a batch gives the bits of a launch on it alone (the scale depends on the
// coordinates and the window, not the batch).  The field offsets the
// window index; the levels and totals pointers stay kernel parameters,
// which hold no register (offset pointers cost 10-15% in spills).
#include <cuda_runtime.h>
#include <math.h>

#include "length.cuh"

namespace {

using namespace xc_length;

// K7's totals
constexpr int kAccWords = 2048;                    // copies x levels of totals
constexpr unsigned long long kNonFinite = 1ull << 63;

// K8
constexpr int kCellSteps = 2;                      // a lane's cells held at once
constexpr int kSlabSteps = 8;                      // a warp's steps of a block
constexpr int kWQ = 64;                            // a warp's queue

// The fixed-point scale of K7 and K8: a total is at most `count` cells x
// 2 segments x (the largest row spacing plus the largest column spacing
// of the coordinates, ext < 2^e); *scale = bits - e with bits = 62 -
// ceil(log2(2 count)) keeps it under 2^62.  y holds ny rows of Ny, x nx
// rows of Nx.  One block.
__global__ void __launch_bounds__(kThreads)
spacing_scale_kernel(const float* __restrict__ ycoord, int ny, int Ny,
                     const float* __restrict__ xcoord, int nx, int Nx,
                     int bits, int* __restrict__ scale) {
  __shared__ float red[2][kWarps];
  float dy = 0.f, dx = 0.f;
  for (int r = 0; r < ny; ++r)
    for (int i = threadIdx.x; i < Ny - 1; i += kThreads) {
      const float* p = ycoord + (long long)r * Ny + i;
      const float d = fabsf(p[1] - p[0]);
      if (isfinite(d)) dy = fmaxf(dy, d);
    }
  for (int r = 0; r < nx; ++r)
    for (int i = threadIdx.x; i < Nx - 1; i += kThreads) {
      const float* p = xcoord + (long long)r * Nx + i;
      const float d = fabsf(p[1] - p[0]);
      if (isfinite(d)) dx = fmaxf(dx, d);
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    dy = fmaxf(dy, __shfl_xor_sync(kFull, dy, o));
    dx = fmaxf(dx, __shfl_xor_sync(kFull, dx, o));
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = dy;
    red[1][threadIdx.x >> 5] = dx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      dy = fmaxf(dy, red[0][w]);
      dx = fmaxf(dx, red[1][w]);
    }
    int e;
    frexpf(dy + dx, &e);
    *scale = bits - e;
  }
}

// bits of the scale for totals over `count` cells (see above)
int scale_bits(long long count) {
  int lg = 0;
  while ((1ll << lg) < 2 * count) ++lg;
  return 62 - lg;
}

// K7: a block per tile of kRB x kCB cells of one batch element
// (walk_tile).  Totals go to the tile's level range of the batch element's
// 64-bit totals (integer atomics, so their order does not matter).
template <bool kLatlon>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lengths_kernel(const float* __restrict__ data, const float* __restrict__ levs,
               const float* __restrict__ ycoord,
               const float* __restrict__ xcoord, long long ystride,
               long long xstride, const int* __restrict__ scale_ptr,
               unsigned long long* __restrict__ gacc, int Ny, int Nx, int N,
               int tiles, int n_cb) {
  __shared__ unsigned long long acc[kAccWords];   // ncopy x cnt totals
  const int scale = *scale_ptr;
  const int lane = threadIdx.x & 31;
  unsigned long long* ga = gacc + (long long)(blockIdx.x / tiles) * N;
  int ncopy = 1, width = 0;
  walk_tile<kLatlon>(
      data, levs, ycoord, xcoord, ystride, xstride, Ny, Nx, N, tiles, n_cb,
      [&](int cnt) {
        // lane l adds into copy l % ncopy of the chunk's totals, so the
        // lanes of a warp that measure pairs of one level hit different
        // words
        ncopy = min(32, kAccWords / cnt);
        width = cnt;
        for (int k = threadIdx.x; k < ncopy * cnt; k += kThreads) acc[k] = 0ull;
      },
      [&](int k, float len) {
        const int ak = lane % ncopy * width + k;
        if (isfinite(len))
          atomicAdd(&acc[ak], __float2ull_ru(scalbnf(len, scale)));
        else
          atomicOr(&acc[ak], kNonFinite);
      },
      [&](int base, int cnt) {
        // fold the copies; one add a level into the batch element's totals
        for (int k = threadIdx.x; k < cnt; k += kThreads) {
          unsigned long long v = 0ull, nf = 0ull;
          for (int j = 0; j < ncopy; ++j) {
            v += acc[j * cnt + k] & ~kNonFinite;
            nf |= acc[j * cnt + k];
          }
          if (nf & kNonFinite) atomicOr(&ga[base + k], kNonFinite);
          if (v) atomicAdd(&ga[base + k], v);
        }
      });
}

// out[order[i]] (or out[i] without an order): the fixed-point total i as
// a float, NaN where a length was not finite; totals of `row` entries a
// row, order holding each row's positions
__global__ void fixed_to_float_kernel(const unsigned long long* __restrict__ acc,
                                      const long long* __restrict__ order,
                                      const int* __restrict__ scale_ptr,
                                      float* __restrict__ out, long long n,
                                      int row) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long v = acc[i];
  const long long o = order ? i - i % row + order[i] : i;
  out[o] = v & kNonFinite ? NAN : (float)ldexp((double)v, -*scale_ptr);
}

// K8's queue of crossings: the cell (from the lattice block's corner), the
// window and its level.
struct WarpQueue {
  int* r;
  int* c;
  int* w;
  float* lev;
  int n;
};

// The lanes measure queue entries [0, n), lane l entry l, corners from the
// field at the block's corner p0, coordinates from the block's corner (ys,
// xs), and add each length into its window's total.
template <bool kLatlon>
__device__ __forceinline__ void measure(const WarpQueue& q, int n,
                                        const float* p0, int Nx,
                                        const float* ys, const float* xs,
                                        int scale,
                                        unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  if (lane >= n) return;
  const int r = q.r[lane], c = q.c[lane];
  const float lev = q.lev[lane];
  const float* p = p0 + (long long)r * Nx + c;
  const float v00 = p[0], v01 = p[1], v10 = p[Nx], v11 = p[Nx + 1];
  const float y0 = ys[r];
  const float len = crossing_length<kLatlon>(
      lev, v00, v01, v10, v11, y0, ys[r + 1] - y0, xs[c + 1] - xs[c],
      cell_code(lev, v00, v01, v10, v11));
  if (isfinite(len))
    atomicAdd(&acc[q.w[lane]], __float2ull_ru(scalbnf(len, scale)));
  else
    atomicOr(&acc[q.w[lane]], kNonFinite);
}

// K8: a warp per slab of up to kSlabSteps steps of 32 cells of a lattice
// block of s x s cells of field blockIdx.y (8 warps a CUDA block; one slab
// a block unless the stride is large).  Only the block's first
// min(s, cells) rows and columns are read: past the window's cells
// (stride > window - 1) no window covers a cell.  The warp takes its cells
// kCellSteps steps at a time (lane map ccw x crps, no division per cell),
// keeps each cell's [lo, hi) in registers and reduces the steps' [min,
// max); then tests the windows that cover the block, 32 at a time, against
// that range, and for each that passes classifies the cells against its
// level (clipped to the window), queueing the crossed ones.
template <bool kLatlon>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
local_lengths_kernel(const float* __restrict__ data,
                     const float* __restrict__ levels,
                     const float* __restrict__ ycoord,
                     const float* __restrict__ xcoord,
                     const int* __restrict__ scale_ptr,
                     unsigned long long* __restrict__ acc, int Ny, int Nx,
                     int Wy, int Wx, int cells, int s, int nby, int nbx,
                     int nbw, int ccw, int crps, int nsl) {
  __shared__ int qr[kWarps][kWQ], qc[kWarps][kWQ], qw[kWarps][kWQ];
  __shared__ float ql[kWarps][kWQ];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long wid = (long long)blockIdx.x * kWarps + warp;
  if (wid >= (long long)nby * nbx * nsl) return;  // the whole warp
  const int b = blockIdx.y;
  const int wo = b * Wy * Wx;   // the field's windows (B Wy Wx < 2^31)
  const long long blk = wid / nsl;
  const int sl = (int)(wid - blk * nsl);
  const int bi = (int)(blk / nbx);
  const int bj = (int)(blk - (long long)bi * nbx);
  const long long r0 = (long long)bi * s, c0 = (long long)bj * s;
  const int bs = min(s, cells);
  const int h = (int)min((long long)bs, Ny - 1 - r0);   // the block's cells
  const int wd = (int)min((long long)bs, Nx - 1 - c0);  // inside the field
  const int scale = *scale_ptr;
  const float* p0 = data + (long long)b * Ny * Nx + r0 * Nx + c0;
  const float* ys = ycoord + r0;
  const float* xs = xcoord + c0;
  WarpQueue q{qr[warp], qc[warp], qw[warp], ql[warp], 0};
  const unsigned lt = (1u << lane) - 1u;
  // the windows covering the block: rows wy0 .. wy0 + nwy - 1, columns
  // wx0 .. wx0 + nwx - 1 (each covers at least one cell of it)
  const int wy0 = max(0, bi - nbw + 1), wx0 = max(0, bj - nbw + 1);
  const int nwy = min(Wy - 1, bi) - wy0 + 1, nwx = min(Wx - 1, bj) - wx0 + 1;
  const int nwin = nwy * nwx;
  const int clr = lane / ccw, clc = lane - clr * ccw;
  const int nc = (wd + ccw - 1) / ccw;   // 1 unless stride > 32
  // this warp's steps [g0, steps)
  const int g0 = sl * kSlabSteps;
  const int steps = min((h + crps - 1) / crps * nc, g0 + kSlabSteps);
  for (int g = g0; g < steps; g += kCellSteps) {
    float lo[kCellSteps], hi[kCellSteps];
    int rr[kCellSteps], cc[kCellSteps];
    float glo = INFINITY, ghi = -INFINITY;
#pragma unroll
    for (int u = 0; u < kCellSteps; ++u) {
      const int t = g + u;
      const int tr = nc == 1 ? t : t / nc;
      rr[u] = tr * crps + clr;
      cc[u] = (t - tr * nc) * ccw + clc;
      lo[u] = INFINITY;
      hi[u] = -INFINITY;
      if (t < steps && clr < crps && rr[u] < h && cc[u] < wd) {
        const float* p = p0 + (long long)rr[u] * Nx + cc[u];
        const float v00 = p[0], v01 = p[1], v10 = p[Nx], v11 = p[Nx + 1];
        if (!any_nan(v00, v01, v10, v11)) {
          lo[u] = fminf(fminf(v00, v01), fminf(v10, v11));
          hi[u] = fmaxf(fmaxf(v00, v01), fmaxf(v10, v11));
        }
      }
      glo = fminf(glo, lo[u]);
      ghi = fmaxf(ghi, hi[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      glo = fminf(glo, __shfl_xor_sync(kFull, glo, o));
      ghi = fmaxf(ghi, __shfl_xor_sync(kFull, ghi, o));
    }
    if (!(glo < ghi)) continue;  // no level crosses these cells
    for (int t0 = 0; t0 < nwin; t0 += 32) {
      const int t = t0 + lane;
      const int dwy = t / nwx;   // per window tested, not per cell
      const int wyy = wy0 + dwy, wxx = wx0 + t - dwy * nwx;
      const int w = wo + wyy * Wx + wxx;
      const float lw = t < nwin ? levels[w] : NAN;
      unsigned todo = __ballot_sync(kFull, glo <= lw && lw < ghi);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float lev = __shfl_sync(kFull, lw, src);
        const int win = __shfl_sync(kFull, w, src);
        // the window's cells from the block's corner: [ry, ry + cells) x
        // [rx, rx + cells)
        const int ry = (int)((long long)__shfl_sync(kFull, wyy, src) * s - r0);
        const int rx = (int)((long long)__shfl_sync(kFull, wxx, src) * s - c0);
#pragma unroll
        for (int u = 0; u < kCellSteps; ++u) {
          if (g + u >= steps) break;  // warp-uniform
          const bool hit = lo[u] <= lev && lev < hi[u] && rr[u] >= ry &&
                           rr[u] < ry + cells && cc[u] >= rx &&
                           cc[u] < rx + cells;
          const unsigned got = __ballot_sync(kFull, hit);
          if (hit) {
            const int slot = q.n + __popc(got & lt);
            q.r[slot] = rr[u];
            q.c[slot] = cc[u];
            q.w[slot] = win;
            q.lev[slot] = lev;
          }
          q.n += __popc(got);
          __syncwarp();
          if (q.n >= 32) {
            measure<kLatlon>(q, 32, p0, Nx, ys, xs, scale, acc);
            // move the rest (fewer than 32) to the front
            const bool mv = lane < q.n - 32;
            int mr = 0, mc = 0, mw = 0;
            float ml = 0.f;
            if (mv) {
              mr = q.r[32 + lane];
              mc = q.c[32 + lane];
              mw = q.w[32 + lane];
              ml = q.lev[32 + lane];
            }
            __syncwarp();
            if (mv) {
              q.r[lane] = mr;
              q.c[lane] = mc;
              q.w[lane] = mw;
              q.lev[lane] = ml;
            }
            q.n -= 32;
            __syncwarp();
          }
        }
      }
    }
  }
  measure<kLatlon>(q, q.n, p0, Nx, ys, xs, scale, acc);
}

// (lanes a row, rows a step) of a warp over rows of width w
void lane_map(int w, int* cw, int* rps) {
  *cw = w < 32 ? w : 32;
  *rps = 32 / *cw;
}

}  // namespace

// data (B, Ny, Nx); levels (B, N) sorted ascending, NaN last, order (B, N)
// their positions in the caller's order; y (B or 1, Ny) and x (B or 1, Nx)
// coordinates; acc (B N + 1) 64-bit scratch (the totals, then the scale);
// out (B, N) totals in the caller's order; tiles of n_rb x n_cb.
extern "C" int xc_contour_lengths(const void* data, const void* levels,
                                  const void* order, const void* y,
                                  const void* x, void* acc, void* out, int B,
                                  int Ny, int Nx, int N, int n_rb, int n_cb,
                                  int y_batched, int x_batched, int latlon,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * N;
  unsigned long long* a = (unsigned long long*)acc;
  int* scale = (int*)(a + n);
  cudaError_t err = cudaMemsetAsync(acc, 0, 8 * (size_t)n, st);
  if (err != cudaSuccess) return (int)err;
  spacing_scale_kernel<<<1, kThreads, 0, st>>>(
      (const float*)y, y_batched ? B : 1, Ny, (const float*)x,
      x_batched ? B : 1, Nx, scale_bits((long long)(Ny - 1) * (Nx - 1)),
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = n_rb * n_cb;
  const unsigned grid = (unsigned)((long long)tiles * B);
  const long long ys = y_batched ? Ny : 0;
  const long long xs = x_batched ? Nx : 0;
  if (latlon)
    lengths_kernel<true><<<grid, kThreads, 0, st>>>(
        (const float*)data, (const float*)levels, (const float*)y,
        (const float*)x, ys, xs, scale, a, Ny, Nx, N, tiles, n_cb);
  else
    lengths_kernel<false><<<grid, kThreads, 0, st>>>(
        (const float*)data, (const float*)levels, (const float*)y,
        (const float*)x, ys, xs, scale, a, Ny, Nx, N, tiles, n_cb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fixed_to_float_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                          0, st>>>(a, (const long long*)order, scale,
                                   (float*)out, n, N);
  return (int)cudaGetLastError();
}

// data (B, Ny, Nx); levels (B, Wy, Wx); y (Ny,), x (Nx,); acc (B Wy Wx + 1)
// 64-bit scratch (the totals, then the scale); out (B, Wy, Wx) raw totals
// of the windows of `window` points anchored every `stride` points; nby x
// nbx lattice blocks a field, nbw a window's side.  A launch takes up to
// 65,535 fields (grid y).
extern "C" int xc_local_lengths(const void* data, const void* levels,
                                const void* y, const void* x, void* acc,
                                void* out, int B, int Ny, int Nx, int Wy,
                                int Wx, int window, int stride, int nby,
                                int nbx, int nbw, int latlon, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int s = stride, cells = window - 1;
  const long long n = (long long)B * Wy * Wx;
  if (cells < 1)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n, st);
  unsigned long long* a = (unsigned long long*)acc;
  const int* sc = (const int*)(a + n);
  cudaError_t err = cudaMemsetAsync(acc, 0, 8 * (size_t)n, st);
  if (err != cudaSuccess) return (int)err;
  spacing_scale_kernel<<<1, kThreads, 0, st>>>(
      (const float*)y, 1, Ny, (const float*)x, 1, Nx,
      scale_bits((long long)cells * cells), (int*)(a + n));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a block's cells a side that windows cover, its steps of 32, and the
  // warps (slabs of kSlabSteps steps) that share them
  const int bs = s < cells ? s : cells;
  int ccw, crps;
  lane_map(bs, &ccw, &crps);
  const int nsl = ((bs + crps - 1) / crps * ((bs + ccw - 1) / ccw) +
                   kSlabSteps - 1) / kSlabSteps;
  const unsigned gx =
      (unsigned)(((long long)nby * nbx * nsl + kWarps - 1) / kWarps);
  const float *yy = (const float*)y, *xx = (const float*)x;
  for (int f0 = 0; f0 < B; f0 += 65535) {
    const int nb = B - f0 < 65535 ? B - f0 : 65535;
    const dim3 grid(gx, nb);
    const float* d = (const float*)data + (long long)f0 * Ny * Nx;
    const float* lv = (const float*)levels + (long long)f0 * Wy * Wx;
    unsigned long long* af = a + (long long)f0 * Wy * Wx;
    if (latlon)
      local_lengths_kernel<true><<<grid, kThreads, 0, st>>>(
          d, lv, yy, xx, sc, af, Ny, Nx, Wy, Wx, cells, s, nby, nbx, nbw, ccw,
          crps, nsl);
    else
      local_lengths_kernel<false><<<grid, kThreads, 0, st>>>(
          d, lv, yy, xx, sc, af, Ny, Nx, Wy, Wx, cells, s, nby, nbx, nbw, ccw,
          crps, nsl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fixed_to_float_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                          0, st>>>(a, nullptr, sc, (float*)out, n, Wx);
  return (int)cudaGetLastError();
}
