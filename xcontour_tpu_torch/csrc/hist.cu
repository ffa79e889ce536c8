// K2: direct multi-channel weighted CDF.
//
// Replaces xcontour_tpu/kernels/hist_pallas.py, _kernel (launched by
// histogram_pallas_multi and histogram_pallas).  The TPU kernel avoids
// scatters entirely: for every level k it compares a VMEM tile against
// edge k+1 and reduces, N*G compares per snapshot.
//
//   out[b, c, k] = sum_g w[b, c, g] * [e[b,0] <= v[b,g] < e[b,k+1]]
//
// with the top edge inclusive (k = N-1) and NaN values or weights adding
// nothing.
//
// Bound on the H100: the bytes read, B*G*(1+C)*4.
//
// Design, three launches:
//  1. grid nblk * B (x only, so any batch launches), 8 warps a block; nblk
//     is sized by the wrapper from the SM count (about 4 blocks an SM).
//     Each warp owns a contiguous
//     run of cells; lane l takes cells l, l+32, ... of it, 4 of them
//     loaded (value and every channel) before any is added.  A lane keeps
//     its current bin, that bin's two edges and one running sum per
//     channel in registers: a value inside the two edges only adds; any
//     other value flushes the sums (one atomic per channel) and finds its
//     bin from a guess, the bin evenly spaced edges would give, checked
//     with its neighbours against the edges, or else by binary search
//     (upper bound minus one, v == e_top -> N-1; valid means e0 <= v <=
//     e_top, never NaN).  The bin is always the comparisons' one, never
//     floor((v - e0) / step), which keeps the law for a constant field
//     (all edges equal): 0 below the top level, the total at the top.
//     The flushes go to ``ncopy`` copies of the (C, N) histogram, lane l
//     to copy l % ncopy, so the lanes of a warp that flush into one bin at
//     once mostly hit different copies: Hopper runs a shared-memory float
//     atomic as a compare-and-swap loop, which retries once for every lane
//     that hits the same address, and on zonally banded tracers (and in
//     the A(Y_eq) table build, whose values are each row's coordinate) the
//     lanes of a warp fall in one bin.  The copies are folded in order
//     into the block's partial (B, nblk, C, N).  Up to 8 channels ride in
//     registers; more take one launch per group of 8.  Where the edges and
//     one group's histogram do not fit in shared memory, each launch takes
//     a range of bins [k0, k0 + nb) and only the values inside its edges
//     (e[k0] <= v < e[k0 + nb], the top edge inclusive in the last range);
//     a value's bin is the same whichever range holds it, so the ranges
//     fill disjoint bins of the partial, and the scan below carries every
//     weight to the bins above it.
//  2. grid B*C*ceil(N/32): lane = bin; the 8 warps sum the blocks'
//     partials (warp w takes blocks w, w+8, ...), folded in warp order.
//  3. grid B*C: one block scans each row of N totals in place: per-thread
//     segments, warp shuffles, then the warps' totals.

#include <cuda_runtime.h>
#include <math.h>

#include "hist.cuh"

namespace {

using namespace xc_hist;

constexpr int kGroup = 8;    // channels one first-pass launch carries
constexpr unsigned kFull = 0xffffffffu;   // block_scan's shuffles

template <int CG>
__global__ void __launch_bounds__(kThreads)
cdf_partial_kernel(const float* __restrict__ v, const float* __restrict__ edges,
                   const float* __restrict__ w, float* __restrict__ partial,
                   int G, int N, int C, int c0, int k0, int nb, int nblk,
                   int wchunk, int ncopy) {
  extern __shared__ float smem[];
  float* e = smem;              // the range's nb + 1 edges e[k0 .. k0 + nb]
  float* h = smem + nb + 1;     // ncopy copies of a (CG, nb) histogram
  const int b = blockIdx.x / nblk;
  const int blk = blockIdx.x - b * nblk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i <= nb; i += kThreads)
    e[i] = edges[(size_t)b * (N + 1) + k0 + i];
  for (int i = threadIdx.x; i < ncopy * CG * nb; i += kThreads) h[i] = 0.0f;
  __syncthreads();

  float* hl = h + (lane % ncopy) * CG * nb;
  // the range's edges; below the last range its top edge is exclusive
  const float e0 = e[0];
  const float etop = e[nb];
  const bool last = k0 + nb == N;
  const float inv = etop > e0 ? (float)nb / (etop - e0) : 0.0f;
  const float* vb = v + (size_t)b * G;
  const float* wb = w + ((size_t)b * C + c0) * G;
  const int start = (blk * kWarps + warp) * wchunk;
  const int end = min(G, start + wchunk);

  int k = -1;
  float lo = INFINITY, hi = -INFINITY;   // no bin yet: every value misses
  float s[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) s[c] = 0.0f;

  for (int base = start; base < end; base += 32 * kUnroll) {
    float x[kUnroll];
    float wt[kUnroll][CG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = base + u * 32 + lane;
      const bool in = g < end;
      x[u] = in ? __ldcs(vb + g) : __int_as_float(0x7fc00000);
#pragma unroll
      for (int c = 0; c < CG; ++c)
        wt[u][c] = in ? __ldcs(wb + (size_t)c * G + g) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // out of range, or NaN
      if (!(x[u] >= e0 && (x[u] < etop || (last && x[u] == etop)))) continue;
      if (!(x[u] >= lo && x[u] < hi)) {
        if (k >= 0) {
#pragma unroll
          for (int c = 0; c < CG; ++c) atomicAdd(&hl[c * nb + k], s[c]);
        }
        k = find_bin_guess(e, nb, x[u], inv);
        lo = e[k];
        hi = k == nb - 1 ? INFINITY : e[k + 1];
#pragma unroll
        for (int c = 0; c < CG; ++c) s[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (!isnan(wt[u][c])) s[c] += wt[u][c];
    }
  }
  if (k >= 0) {
#pragma unroll
    for (int c = 0; c < CG; ++c) atomicAdd(&hl[c * nb + k], s[c]);
  }
  __syncthreads();

  float* pb = partial + (((size_t)b * nblk + blk) * C + c0) * N + k0;
  for (int i = threadIdx.x; i < CG * nb; i += kThreads) {
    float acc = h[i];
    for (int j = 1; j < ncopy; ++j) acc += h[j * CG * nb + i];
    const int c = i / nb;
    pb[(size_t)c * N + (i - c * nb)] = acc;
  }
}

// inclusive scan of x[0..N) in place by one block of kThreads: each thread
// sums a segment of ceil(N / kThreads) bins, the segment totals are scanned
// by warp shuffles and then across the warps
__device__ void block_scan(float* x, int N) {
  __shared__ float warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (N + kThreads - 1) / kThreads;
  const int beg = min(N, threadIdx.x * per);
  const int end = min(N, beg + per);
  float t = 0.0f;
  for (int k = beg; k < end; ++k) t += __ldcg(x + k);
  float incl = t;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float wsum = lane < kWarps ? warp_tot[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const float o = __shfl_up_sync(kFull, wsum, d);
      if (lane >= d) wsum += o;
    }
    if (lane < kWarps) warp_tot[lane] = wsum;
  }
  __syncthreads();
  float run = (incl - t) + (warp > 0 ? warp_tot[warp - 1] : 0.0f);
  for (int k = beg; k < end; ++k) {
    run += __ldcg(x + k);
    x[k] = run;
  }
}

__global__ void __launch_bounds__(kThreads)
cdf_fold_kernel(const float* __restrict__ partial, float* __restrict__ out,
                int N, int C, int nblk, int nkb) {
  __shared__ float sw[kWarps][32];
  const int bc = blockIdx.x / nkb;
  const int b = bc / C;
  const int c = bc % C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = (blockIdx.x - bc * nkb) * 32 + lane;
  float acc = 0.0f;
  if (k < N)
    for (int i = warp; i < nblk; i += kWarps)
      acc += partial[(((size_t)b * nblk + i) * C + c) * N + k];
  sw[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && k < N) {
    float t = sw[0][lane];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) t += sw[j][lane];
    out[(size_t)bc * N + k] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
cdf_scan_kernel(float* __restrict__ out, int N) {
  block_scan(out + (size_t)blockIdx.x * N, N);
}

template <int CG>
cudaError_t launch_partial(const float* v, const float* edges, const float* w,
                           float* partial, int B, int G, int N, int C, int c0,
                           int k0, int nb, int nblk, int wchunk, int ncopy,
                           cudaStream_t st) {
  const size_t smem = (size_t)(nb + 1 + ncopy * CG * nb) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cdf_partial_kernel<CG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  cdf_partial_kernel<CG><<<(unsigned)nblk * B, kThreads, smem, st>>>(
      v, edges, w, partial, G, N, C, c0, k0, nb, nblk, wchunk, ncopy);
  return cudaGetLastError();
}

}  // namespace

// nrange: bins a first-pass launch takes (N where one group's histogram
// fits in shared memory, else ranges of nrange bins)
extern "C" int xc_weighted_cdf(const void* values, const void* edges,
                               const void* weights, void* partial, void* out,
                               int B, int G, int N, int C, int nrange,
                               int nblk, int wchunk, int ncopy, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* v = (const float*)values;
  const float* e = (const float*)edges;
  const float* w = (const float*)weights;
  float* p = (float*)partial;
  if (nrange < 1) return (int)cudaErrorInvalidValue;
  for (int k0 = 0; k0 < N; k0 += nrange) {
    const int nb = N - k0 < nrange ? N - k0 : nrange;
    for (int c0 = 0; c0 < C; c0 += kGroup) {
      const int cg = C - c0 < kGroup ? C - c0 : kGroup;
      cudaError_t err;
      switch (cg) {
#define XC_CASE(n)                                                           \
        case n:                                                              \
          err = launch_partial<n>(v, e, w, p, B, G, N, C, c0, k0, nb, nblk,  \
                                  wchunk, ncopy, st);                        \
          break;
        XC_CASE(1) XC_CASE(2) XC_CASE(3) XC_CASE(4)
        XC_CASE(5) XC_CASE(6) XC_CASE(7) XC_CASE(8)
#undef XC_CASE
        default:
          return (int)cudaErrorInvalidValue;
      }
      if (err != cudaSuccess) return (int)err;
    }
  }
  const int nkb = (N + 31) / 32;
  cdf_fold_kernel<<<(unsigned)(B * C) * nkb, kThreads, 0, st>>>(
      p, (float*)out, N, C, nblk, nkb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cdf_scan_kernel<<<B * C, kThreads, 0, st>>>((float*)out, N);
  return (int)cudaGetLastError();
}
