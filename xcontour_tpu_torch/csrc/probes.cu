// P1-P4: the kernel-ceiling probes.  Each is the twin of one of the port's
// kernels: it keeps that kernel's grid, blocks, staging and loop, drops the
// machinery named below, and computes a function that does not depend on
// the blocking, so its plain PyTorch version can hold it.  Its time is the
// ceiling the kernel can reach at its structure: a kernel near its probe
// has no headroom left at that structure, a probe well ahead of it shows
// how much the dropped machinery costs.
//
// P1 replaces bench.py:523 (_lwa_structure_probe, body `kernel` :484),
// twin of K3's surface kernel (lwa.cu, lwa_lin_kernel):
//
//   R[b, j, x] = sum_y min(q[b, y, x] - Q[b, j], 0) * W[y, x],
//
// NaN propagating as jnp.minimum's.  The same 128-surface tiles x 32-column
// strips x B grid, 32 x 8 threads, 16 surfaces a thread in registers,
// 32-row panels of q and W double-buffered by cp.async, and K3's row sum
// (lin_row).  Dropped: the centering on c0, the sentinel fix-up pass, E's
// prep kernel and the E carry-in epilogue.  Bound: FP32 issue, K3's 3
// instructions a (surface, cell) pair.
//
// P2 replaces bench.py:593 (_hist_structure_probe, body `kernel` :552),
// twin of K2's first pass (hist.cu, cdf_partial_kernel):
//
//   S[b] = sum_g (w[b, 0, g] + w[b, 1, g]) * #{k in 1..N : v[b, g] < e[b, k]}
//
// for ascending edges; a NaN value counts 0 (its compares are false), a
// NaN weight propagates.  The same grid (kernels.hist.plan), 8 warps, lane
// l taking cells l, l + 32, ... of its warp's run, 4 loaded before any is
// used, the current bin kept in registers and a new one found by guess,
// check, then binary search (find_bin_guess).  Dropped: the flushes, the
// shared float atomics and their copies, the fold of the copies into the
// partial histogram, passes 2 and 3.  Each block writes one partial and
// a fixed-order fold gives S, so two runs agree bit for bit.  Bound: the
// bytes read, K2's at two channels.
//
// P3 replaces bench.py:666 (_length_structure_probe, body `kernel` :628),
// twin of K7's main kernel (length.cu, lengths_kernel), lat-lon:
//
//   T[b] = sum_n L[b, n],
//
// L being K7's totals before the caller's exact-empty NaN.  The same tiles
// of 16 x 128 cells, 256 threads, staged corners and coordinates, the
// tile's sorted-level range [n0, n1), chunks of 1024 levels, the block
// scan and the shared queue of crossed pairs, K7's segment arithmetic
// (crossing_length).  Dropped: the per-level totals and their copies, the
// 64-bit fixed-point atomics, the scale and conversion kernels: each thread
// adds its pairs' lengths in a float register, the block folds them into
// one partial a tile, and the fixed-order fold gives T (bit for bit again).
// Bound: K7's.
//
// P4 replaces bench.py:742 (_pallas_copy, body _copy_kernel :737), twin of
// K1 (stencil.cu): out = q * 1.0000001f, one rounding, with K1's blocks of
// 4 warps over (b, 32 V columns, 4 strips of 16 rows), float4 where the
// row length and alignment allow, rows loaded 2 ahead.  Dropped: the
// neighbours, 1/dx, 1/dy and the shuffles.  Bound: its 2 B Ny Nx 4 bytes,
// the copy ceiling K1 is measured against.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hist.cuh"
#include "length.cuh"
#include "lwa.cuh"
#include "stencil.cuh"

namespace {

constexpr int kBlock = 256;   // threads of P2's, P3's and the fold's blocks
constexpr int kBlockWarps = kBlock / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kBatchChunk = 65535;   // P1's batch a launch (grid z)
constexpr float kScale = 1.0000001f;
static_assert(xc_hist::kThreads == kBlock && xc_length::kThreads == kBlock,
              "P2 and P3 keep their kernels' blocks");

// one float a thread summed over the block in a fixed order (the same bits
// every run); the total in thread 0
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[kBlockWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0) {
    t = red[0];
#pragma unroll
    for (int w = 1; w < kBlockWarps; ++w) t += red[w];
  }
  return t;
}

// out[b] = the sum of partial[b, 0 .. n), in a fixed order
__global__ void __launch_bounds__(kBlock)
probe_fold_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int n) {
  const float* p = partial + (long long)blockIdx.x * n;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kBlock) s += p[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// P1
__global__ void __launch_bounds__(xc_lwa::kTX * xc_lwa::kJG)
lwa_structure_kernel(const float* __restrict__ q, const float* __restrict__ W,
                     const float* __restrict__ Q, float* __restrict__ out,
                     int Ny, int Nx) {
  using namespace xc_lwa;
  __shared__ float sq[2][kYP][kTX];
  __shared__ float sw[2][kYP][kTX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.y * kTX + tx;
  const int j0 = blockIdx.x * (kJG * kJ) + ty * kJ;
  const int b = blockIdx.z;
  const long long plane = (long long)Ny * Nx;
  const float* qb = q + b * plane;
  const float* Qb = Q + (long long)b * Ny;

  float Qj[kJ], acc[kJ];
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const int j = j0 + k;
    Qj[k] = j < Ny ? Qb[j] : 0.0f;
    acc[k] = 0.0f;
  }

  lin_panels<true>(acc, Qj, sq, sw, qb, W, Ny, Nx, x, [](int) {});

  if (x >= Nx) return;
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const int j = j0 + k;
    if (j < Ny) out[b * plane + (long long)j * Nx + x] = acc[k];
  }
}

// P2: block blk of batch element b writes partial[b, blk]
__global__ void __launch_bounds__(kBlock)
hist_structure_kernel(const float* __restrict__ v,
                      const float* __restrict__ edges,
                      const float* __restrict__ w, float* __restrict__ partial,
                      int G, int N, int nblk, int wchunk) {
  using namespace xc_hist;
  extern __shared__ float e[];   // the N + 1 edges
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x - b * nblk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i <= N; i += kThreads)
    e[i] = edges[(size_t)b * (N + 1) + i];
  __syncthreads();

  const float e0 = e[0];
  const float etop = e[N];
  const float inv = etop > e0 ? (float)N / (etop - e0) : 0.0f;
  const float* vb = v + (size_t)b * G;
  const float* w0 = w + (size_t)b * 2 * G;
  const float* w1 = w0 + G;
  const int start = (blk * kWarps + warp) * wchunk;
  const int end = min(G, start + wchunk);

  int k = 0;
  float lo = INFINITY, hi = -INFINITY;   // no bin yet: every value misses
  float s = 0.0f;
  for (int base = start; base < end; base += 32 * kUnroll) {
    float x[kUnroll], ws[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = base + u * 32 + lane;
      const bool in = g < end;
      x[u] = in ? __ldcs(vb + g) : __int_as_float(0x7fc00000);
      ws[u] = in ? __ldcs(w0 + g) + __ldcs(w1 + g) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // edges above the value: all N below e0, none at or above the top
      // edge or for NaN, else N minus the value's bin
      float cnt;
      if (x[u] < e0) {
        cnt = (float)N;
      } else if (!(x[u] < etop)) {
        cnt = 0.0f;
      } else {
        if (!(x[u] >= lo && x[u] < hi)) {
          k = find_bin_guess(e, N, x[u], inv);
          lo = e[k];
          hi = e[k + 1];
        }
        cnt = (float)(N - k);
      }
      s = fmaf(ws[u], cnt, s);
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// P3: K7's walk of a tile (walk_tile), its pairs' lengths added in a
// float register a thread; the tile's total goes to partial[b, tile]
__global__ void __launch_bounds__(xc_length::kThreads, xc_length::kMinBlocks)
length_structure_kernel(const float* __restrict__ data,
                        const float* __restrict__ levs,
                        const float* __restrict__ ycoord,
                        const float* __restrict__ xcoord, long long ystride,
                        long long xstride, float* __restrict__ partial, int Ny,
                        int Nx, int N, int tiles, int n_cb) {
  float sum = 0.f;   // this thread's pairs' lengths
  xc_length::walk_tile<true>(
      data, levs, ycoord, xcoord, ystride, xstride, Ny, Nx, N, tiles, n_cb,
      [](int) {}, [&](int, float len) { sum += len; }, [](int, int) {});
  const float total = block_sum(sum);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// P4: V columns a lane
template <int V>
__global__ void __launch_bounds__(32 * xc_stencil::kWarpsY)
scaled_copy_kernel(const float* __restrict__ q, float* __restrict__ out,
                   int Ny, int Nx) {
  using namespace xc_stencil;
  const int b = blockIdx.x;
  const int x0 = (blockIdx.y * 32 + threadIdx.x) * V;
  const int y0 = (blockIdx.z * kWarpsY + threadIdx.y) * kStrip;
  if (y0 >= Ny) return;
  const int y1 = min(Ny, y0 + kStrip);
  const int xc = min(x0, Nx - V);   // lanes past Nx shadow the last columns
  const size_t plane = (size_t)Ny * Nx;
  const float* qb = q + b * plane;
  float* ob = out + b * plane;
  for (int ys = y0; ys < y1; ys += kAhead) {
    float r[kAhead][V];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (ys + a < y1) {
        load_vec<V>(qb + (ys + a) * Nx + xc, r[a]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) r[a][v] = 0.0f;
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int y = ys + a;
      if (y >= y1) break;
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) o[v] = __fmul_rn(r[a][v], kScale);
      if (x0 < Nx) store_vec<V>(ob + y * Nx + xc, o);
    }
  }
}

template <int V>
void launch_copy(const float* q, float* out, int B, int Ny, int Nx,
                 cudaStream_t st) {
  using namespace xc_stencil;
  const dim3 grid(B, (Nx + 32 * V - 1) / (32 * V),
                  (Ny + kStrip * kWarpsY - 1) / (kStrip * kWarpsY));
  scaled_copy_kernel<V><<<grid, dim3(32, kWarpsY), 0, st>>>(q, out, Ny, Nx);
}

}  // namespace

// q (B, Ny, Nx), W (Ny, Nx), Q (B, Ny) -> out (B, Ny, Nx)
extern "C" int xc_lwa_structure(const void* q, const void* W, const void* Q,
                                void* out, int B, int Ny, int Nx,
                                void* stream) {
  using namespace xc_lwa;
  cudaStream_t st = (cudaStream_t)stream;
  const long long plane = (long long)Ny * Nx;
  const int per_block = kJG * kJ;
  for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
    const int bc = B - b0 < kBatchChunk ? B - b0 : kBatchChunk;
    const dim3 grid((Ny + per_block - 1) / per_block, (Nx + kTX - 1) / kTX,
                    bc);
    lwa_structure_kernel<<<grid, dim3(kTX, kJG), 0, st>>>(
        (const float*)q + b0 * plane, (const float*)W,
        (const float*)Q + (long long)b0 * Ny, (float*)out + b0 * plane, Ny,
        Nx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// values (B, G), edges (B, N + 1) ascending, weights (B, 2, G); partial
// (B, nblk) scratch; out (B,)
extern "C" int xc_hist_structure(const void* values, const void* edges,
                                 const void* weights, void* partial, void* out,
                                 int B, int G, int N, int nblk, int wchunk,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(N + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        hist_structure_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  hist_structure_kernel<<<(unsigned)nblk * B, kBlock, smem, st>>>(
      (const float*)values, (const float*)edges, (const float*)weights,
      (float*)partial, G, N, nblk, wchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probe_fold_kernel<<<B, kBlock, 0, st>>>((const float*)partial, (float*)out,
                                          nblk);
  return (int)cudaGetLastError();
}

// data (B, Ny, Nx); levels (B, N) sorted ascending, NaN last; y (B or 1,
// Ny) and x (B or 1, Nx) coordinates in radians; partial (B, n_rb n_cb)
// scratch; out (B,)
extern "C" int xc_length_structure(const void* data, const void* levels,
                                   const void* y, const void* x,
                                   void* partial, void* out, int B, int Ny,
                                   int Nx, int N, int n_rb, int n_cb,
                                   int y_batched, int x_batched,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = n_rb * n_cb;
  length_structure_kernel<<<(unsigned)((long long)tiles * B), kBlock, 0, st>>>(
      (const float*)data, (const float*)levels, (const float*)y,
      (const float*)x, y_batched ? Ny : 0, x_batched ? Nx : 0,
      (float*)partial, Ny, Nx, N, tiles, n_cb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probe_fold_kernel<<<B, kBlock, 0, st>>>((const float*)partial, (float*)out,
                                          tiles);
  return (int)cudaGetLastError();
}

// q (B, Ny, Nx) -> out = q * 1.0000001f; 4 columns a lane where the row
// length and the pointers' alignment allow float4 accesses, else 1
extern "C" int xc_scaled_copy(const void* q, void* out, int B, int Ny, int Nx,
                              void* stream) {
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (Nx % 4 == 0 && addr % 16 == 0)
    launch_copy<4>((const float*)q, (float*)out, B, Ny, Nx, st);
  else
    launch_copy<1>((const float*)q, (float*)out, B, Ny, Nx, st);
  return (int)cudaGetLastError();
}
