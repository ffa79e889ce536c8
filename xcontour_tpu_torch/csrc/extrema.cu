// E: the contour levels' scan.  Each snapshot's NaN-skipping min and max
// and the N evenly spaced levels between them, from one read of the tracer.
//
// Replaces no TPU kernel: xcontour_tpu/core.py:45-63 is plain jnp
// (cal_contours: where(isnan, +-inf, q).min / .max, then the levels), and
// the port ran it as an isnan, two full-field wheres, an amin and an amax
// (about 510 MB moved for a 66 MB ERA5 step) and nine small launches for
// the levels.
//
// Bound on the H100: device-memory traffic.  Each cell is read once; the
// outputs are a few bytes a snapshot.
//
// Design: two launches.  The first, blocks of 256 threads over (chunk,
// snapshot), reads its chunk of the plane with 16-byte loads (the cells
// before the plane's first 16-byte boundary and after its last whole
// vector, fewer than 2 vectors, with scalar loads by the last chunk's
// block), kUnroll loads in flight a thread before it folds any, and keeps
// fmin from +inf and fmax from -inf: fmin and fmax drop a NaN operand, so
// that is where(isnan, +-inf, q).amin / amax exactly.  A warp shuffle and
// a block reduce write the chunk's (min, max) pair.  The second, one block
// a snapshot, folds the chunks' pairs and writes either the pair itself
// (+-inf kept: the sharded levels reduce it further) or the levels as
// core.levels_from_extrema forms them: +inf min and -inf max become NaN;
// (start, end) is (min, max), or (max, min) when the levels decrease;
// steps = (end - start) / (N - 1) by IEEE division; level i = steps * i +
// start, the product and the sum each rounded on its own (torch runs them
// as two kernels, so nothing may contract them into an FMA); level N - 1
// is end.  The chunk count comes from the wrapper (K2's rule,
// kernels/hist.blocks_a_plane): enough blocks to fill the card a few times
// over.  float32 and float64
// (the vectors hold 4 or 2 cells); indices within a plane are 32-bit (the
// wrapper takes fewer than 2^31 cells a plane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kFoldThreads = 128;
constexpr int kUnroll = 4;
constexpr int kMaxGridY = 65535;

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  using Vec = float4;
  static constexpr int kCells = 4;
  static __device__ __forceinline__ float inf() {
    return __int_as_float(0x7f800000);
  }
  static __device__ __forceinline__ float nan() {
    return __int_as_float(0x7fc00000);
  }
  static __device__ __forceinline__ float lo(float a, float b) {
    return fminf(a, b);
  }
  static __device__ __forceinline__ float hi(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ void fold(const float4& v, float& mn,
                                              float& mx) {
    mn = fminf(fminf(mn, v.x), fminf(v.y, fminf(v.z, v.w)));
    mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
  }
};

template <>
struct Ops<double> {
  using Vec = double2;
  static constexpr int kCells = 2;
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  static __device__ __forceinline__ double lo(double a, double b) {
    return fmin(a, b);
  }
  static __device__ __forceinline__ double hi(double a, double b) {
    return fmax(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ void fold(const double2& v, double& mn,
                                              double& mx) {
    mn = fmin(mn, fmin(v.x, v.y));
    mx = fmax(mx, fmax(v.x, v.y));
  }
};

// the block's (min, max) into thread 0's mn and mx; s_mn and s_mx hold a
// value a warp
template <typename T>
__device__ __forceinline__ void block_extrema(T& mn, T& mx, T* s_mn,
                                              T* s_mx) {
  using O = Ops<T>;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = O::lo(mn, __shfl_xor_sync(kFull, mn, o));
    mx = O::hi(mx, __shfl_xor_sync(kFull, mx, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < warps ? s_mn[lane] : O::inf();
    mx = lane < warps ? s_mx[lane] : -O::inf();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = O::lo(mn, __shfl_xor_sync(kFull, mn, o));
      mx = O::hi(mx, __shfl_xor_sync(kFull, mx, o));
    }
  }
  __syncthreads();                      // s_mn and s_mx free again
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
extrema_partial_kernel(const T* __restrict__ x, T* __restrict__ partial,
                       int B, int M) {
  using O = Ops<T>;
  using Vec = typename O::Vec;
  constexpr int W = O::kCells;
  __shared__ T s_mn[kThreads / 32], s_mx[kThreads / 32];
  const int chunks = gridDim.x, c = blockIdx.x;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const T* p = x + (size_t)b * M;
    const int head = min(
        M, (int)(((16 - ((uintptr_t)p & 15)) & 15) / sizeof(T)));
    const int nvec = (M - head) / W;
    const int per = (nvec + chunks - 1) / chunks;
    const int v0 = min(nvec, c * per), v1 = min(nvec, v0 + per);
    const Vec* pv = reinterpret_cast<const Vec*>(p + head);
    T mn = O::inf(), mx = -O::inf();
    for (int v = v0 + (int)threadIdx.x; v < v1; v += kThreads * kUnroll) {
      Vec r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (v + u * kThreads < v1) r[u] = __ldg(pv + v + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (v + u * kThreads < v1) O::fold(r[u], mn, mx);
    }
    if (c == chunks - 1) {
      for (int i = threadIdx.x; i < head; i += kThreads) {
        const T t = __ldg(p + i);
        mn = O::lo(mn, t);
        mx = O::hi(mx, t);
      }
      for (int i = head + nvec * W + threadIdx.x; i < M; i += kThreads) {
        const T t = __ldg(p + i);
        mn = O::lo(mn, t);
        mx = O::hi(mx, t);
      }
    }
    block_extrema(mn, mx, s_mn, s_mx);
    if (threadIdx.x == 0) {
      T* q = partial + ((size_t)b * chunks + c) * 2;
      q[0] = mn;
      q[1] = mx;
    }
  }
}

// levels: out (B, N), else out (2, B): the mins, then the maxes
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
extrema_fold_kernel(const T* __restrict__ partial, T* __restrict__ out,
                    int B, int chunks, int N, int increase, int levels) {
  using O = Ops<T>;
  __shared__ T s_mn[kFoldThreads / 32], s_mx[kFoldThreads / 32];
  __shared__ T s_line[3];               // start, end, steps
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const T* q = partial + (size_t)b * chunks * 2;
    T mn = O::inf(), mx = -O::inf();
    for (int c = threadIdx.x; c < chunks; c += kFoldThreads) {
      mn = O::lo(mn, q[2 * c]);
      mx = O::hi(mx, q[2 * c + 1]);
    }
    block_extrema(mn, mx, s_mn, s_mx);
    if (threadIdx.x == 0) {
      if (!levels) {
        out[b] = mn;
        out[(size_t)B + b] = mx;
      } else {
        if (mn == O::inf()) mn = O::nan();
        if (mx == -O::inf()) mx = O::nan();
        const T start = increase ? mn : mx;
        const T end = increase ? mx : mn;
        s_line[0] = start;
        s_line[1] = end;
        s_line[2] = O::div(O::sub(end, start), (T)(N - 1));
      }
    }
    __syncthreads();
    if (levels) {
      const T start = s_line[0], end = s_line[1], steps = s_line[2];
      T* row = out + (size_t)b * N;
      for (int i = threadIdx.x; i < N; i += kFoldThreads)
        row[i] = i == N - 1 ? end : O::add(O::mul(steps, (T)i), start);
    }
    __syncthreads();                    // s_line read before the next b
  }
}

template <typename T>
int launch(const void* x, void* partial, void* out, int B, int M,
           int chunks, int N, int increase, int levels, cudaStream_t st) {
  const int gy = B < kMaxGridY ? B : kMaxGridY;
  extrema_partial_kernel<T><<<dim3(chunks, gy), kThreads, 0, st>>>(
      (const T*)x, (T*)partial, B, M);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  extrema_fold_kernel<T><<<gy, kFoldThreads, 0, st>>>(
      (const T*)partial, (T*)out, B, chunks, N, increase, levels);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, M) contiguous; partial (B, chunks, 2); out (B, N) where levels is
// non-zero, else (2, B); itemsize 4 (float32) or 8 (float64)
extern "C" int xc_contour_levels(const void* x, void* partial, void* out,
                                 int B, int M, int chunks, int N,
                                 int increase, int levels, int itemsize,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (itemsize == 8)
    return launch<double>(x, partial, out, B, M, chunks, N, increase, levels,
                          st);
  return launch<float>(x, partial, out, B, M, chunks, N, increase, levels,
                       st);
}
