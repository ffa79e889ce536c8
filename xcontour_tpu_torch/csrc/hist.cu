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
// Bound on the H100: the bytes read, B*G*(1+C)*4, once the digitize is a
// binary search (log2(N+1) shared-memory compares per cell instead of N).
// Contention of shared-memory atomics comes second: on zonally banded
// tracers neighbouring cells fall in the same bin.
//
// Design, two passes:
//  1. grid (nblk, B): each block copies its row's N+1 edges into shared
//     memory and zeroes a shared (C, N) histogram.  Each thread finds its
//     values' bins by binary search (side='right' minus 1; v == e_top goes
//     to N-1; valid means e0 <= v <= e_top, never NaN) and adds each
//     channel's weight (NaN -> nothing) with a shared-memory atomic.  The
//     block writes its partial histogram to scratch (B, nblk, C, N).
//     Digitizing by comparison, never by floor((v - e0) / step), keeps the
//     law for a constant field (all edges equal): 0 below the top level,
//     the total at the top.
//  2. grid (B*C): each block sums the partials of its (b, c) in a fixed
//     order and takes the inclusive prefix scan along k.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void cdf_partial_kernel(const float* __restrict__ v,
                                   const float* __restrict__ edges,
                                   const float* __restrict__ w,
                                   float* __restrict__ partial, int G, int N,
                                   int C, int chunk) {
  extern __shared__ float smem[];
  float* e = smem;            // N + 1 edges
  float* h = smem + N + 1;    // C x N histogram
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;

  for (int i = threadIdx.x; i <= N; i += blockDim.x)
    e[i] = edges[(long long)b * (N + 1) + i];
  for (int i = threadIdx.x; i < C * N; i += blockDim.x) h[i] = 0.0f;
  __syncthreads();

  const float e0 = e[0];
  const float etop = e[N];
  const float* vb = v + (long long)b * G;
  const float* wb = w + (long long)b * C * G;
  const int start = blk * chunk;
  const int end = min(G, start + chunk);
  for (int g = start + threadIdx.x; g < end; g += blockDim.x) {
    const float x = vb[g];
    if (!(x >= e0 && x <= etop)) continue;  // out of range, or NaN
    int k;
    if (x == etop) {
      k = N - 1;
    } else {
      // upper bound: count of edges <= x, then minus one.  e0 <= x < etop
      // puts k in [0, N-1].
      int lo = 1, hi = N;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (e[mid] <= x) lo = mid + 1; else hi = mid;
      }
      k = lo - 1;
    }
    for (int c = 0; c < C; ++c) {
      const float wc = wb[(long long)c * G + g];
      if (!isnan(wc)) atomicAdd(&h[c * N + k], wc);
    }
  }
  __syncthreads();

  float* pb = partial + ((long long)b * nblk + blk) * C * N;
  for (int i = threadIdx.x; i < C * N; i += blockDim.x) pb[i] = h[i];
}

__global__ void cdf_scan_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int N, int C,
                                int nblk) {
  extern __shared__ float s[];  // N bin totals
  const int b = blockIdx.x / C;
  const int c = blockIdx.x % C;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    float acc = 0.0f;
    for (int i = 0; i < nblk; ++i)
      acc += partial[(((long long)b * nblk + i) * C + c) * N + k];
    s[k] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.0f;
    float* ob = out + ((long long)b * C + c) * N;
    for (int k = 0; k < N; ++k) {
      run += s[k];
      ob[k] = run;
    }
  }
}

}  // namespace

extern "C" int xc_weighted_cdf(const void* values, const void* edges,
                               const void* weights, void* partial, void* out,
                               int B, int G, int N, int C, int nblk, int chunk,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem1 = (size_t)(N + 1 + C * N) * sizeof(float);
  if (smem1 > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cdf_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem1);
    if (err != cudaSuccess) return (int)err;
  }
  cdf_partial_kernel<<<dim3(nblk, B), kThreads, smem1, st>>>(
      (const float*)values, (const float*)edges, (const float*)weights,
      (float*)partial, G, N, C, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = (size_t)N * sizeof(float);
  if (smem2 > 48 * 1024) {
    err = cudaFuncSetAttribute(cdf_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem2);
    if (err != cudaSuccess) return (int)err;
  }
  cdf_scan_kernel<<<B * C, kThreads, smem2, st>>>(
      (const float*)partial, (float*)out, N, C, nblk);
  return (int)cudaGetLastError();
}
