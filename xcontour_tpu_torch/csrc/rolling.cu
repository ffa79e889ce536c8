// R: the window means of diagnostics/local_length.rolling_mean, every
// window of a call in one launch.
//
// No TPU kernel: the JAX package computes the window means with integral
// images in plain jnp (xcontour_tpu/diagnostics/local_length.py:28), and
// so does the port's plain version (kernels/rolling.py): ~55 launches, four
// cumsums over the whole field and their padded copies.  This kernel sums
// each window's finite points and counts them at its anchor and writes
// only the means.
//
// What it computes, for each field b and window (r, c) of `window` x
// `window` points anchored at (r * stride, c * stride):
//
//   n = the finite points of the window, S = their sum (float64);
//   out[b, r, c] = S / n      if n >= min_count and n > 0,
//                  fill[b]    if n == 0 >= min_count (the field's finite
//                             mean, or 0 for an all-NaN field: the plain
//                             version's value there),
//                  NaN        if n < min_count.
//
// Sums are float64 from the float32 (or float64) values, so a
// Kelvin-scale offset costs no precision and no offset pass is needed (the
// plain version's float32 integral images need one).
//
// Bound on the H100: device-memory traffic.  The field is read once and
// the means written once: at the era5.local step (16 x 721 x 1440, window
// 101, stride 10) 66.4 MB in, 0.5 MB out, 0.020 ms at 3.35 TB/s; the
// float64 adds (about four a point) take a fraction of that.
//
// Design: a block owns a tile of TY anchor rows x TX anchors of one field
// (grid x: the tiles, grid y: the field; a launch takes up to 65,535
// fields) and the (TX - 1) * stride + window columns they cover, the halo
// included: the tiles' footprints overlap by window - stride columns and
// rows, and the re-read comes from L2.  Each thread owns C columns in
// units of 16 bytes (4 float32 or 2 float64; one vector load a row where
// the rows are 16-byte aligned, the first unit starting up to 3 columns
// before the footprint) and keeps their column sums of value and count
// over the rows of the current anchor row's windows in registers: the
// band's first anchor row sums its window rows, each next one adds the
// stride rows that enter and subtracts those that leave (a stride at or
// past the window starts afresh), kBatch rows of loads in flight a thread.
// Then the column sums go to shared memory, a thread a chunk of `stride`
// columns sums them (the chunk and its first window % stride columns), and
// a thread a window adds its window / stride chunks and the partial one:
// each column sum is read about twice, not once a window.  The wrapper's
// plan takes the smallest block (64 threads x 4 columns, up to 256 x 16)
// whose columns hold twice the window, and enough bands for ~8 blocks an
// SM: at the era5.local step 0.065 ms against 0.083 for 256-thread blocks
// of 4-byte loads, and 1.71 for the plain version (H100 80GB HBM3, 700
// W); the halo's re-reads and the load latency of the band's first rows
// hold it at ~30% of the bound.  Every sum has a fixed order (no
// atomics), so the same input gives the same bits;
// tests/test_torch_rolling.py evaluates the same sums in the same order in
// plain torch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxFields = 65535;          // grid y
constexpr long long kNaN = 0x7ff8000000000000ll;
constexpr int kBatch = 4;                  // rows a thread loads at once

// a unit: the V columns a thread loads at once, 16 bytes
template <typename T>
struct Unit;
template <>
struct Unit<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void load(const float* p, float (&a)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
  }
};
template <>
struct Unit<double> {
  static constexpr int V = 2;
  __device__ __forceinline__ static void load(const double* p,
                                              double (&a)[2]) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    a[0] = t.x; a[1] = t.y;
  }
};

// the unit at p: one vector load where rows are 16-byte aligned, else its
// columns before `last` one at a time
template <typename T>
__device__ __forceinline__ void load_unit(const T* p, bool aligned, int last,
                                          T (&a)[Unit<T>::V]) {
  if (aligned) {
    Unit<T>::load(p, a);
  } else {
#pragma unroll
    for (int j = 0; j < Unit<T>::V; ++j) a[j] = j < last ? p[j] : (T)0;
  }
}

template <typename T>
__device__ __forceinline__ void add_point(T x, double& v, int& n) {
  const bool ok = isfinite(x);
  v += ok ? (double)x : 0.0;
  n += ok;
}

template <typename T>
__device__ __forceinline__ void sub_point(T x, double& v, int& n) {
  const bool ok = isfinite(x);
  v -= ok ? (double)x : 0.0;
  n -= ok;
}

// data (fields, Ny, Nx) -> out (fields, Wy, Wx); grid x the tiles (nty
// bands of ntx), grid y the field; fill (fields) float64 or null
// (min_count > 0); C columns a thread (S units of V).  Shared memory: the
// column sums (blockDim.x * C doubles and ints), then the chunk sums
// (nch_max doubles and ints, twice).
template <typename T, int C>
__global__ void __launch_bounds__(kMaxThreads)
window_means_kernel(const T* __restrict__ data,
                    const double* __restrict__ fill, T* __restrict__ out,
                    int Ny, int Nx, int Wy, int Wx, int window, int stride,
                    int min_count, int TX, int TY, int ntx, int nch_max,
                    int aligned) {
  constexpr int V = Unit<T>::V, S = C / V;
  const int nt = blockDim.x;
  extern __shared__ double smem[];
  double* col_v = smem;                               // nt * C
  double* chunk_v = col_v + nt * C;                   // nch_max
  double* part_v = chunk_v + nch_max;                 // nch_max
  int* col_n = (int*)(part_v + nch_max);              // nt * C
  int* chunk_n = col_n + nt * C;                      // nch_max
  int* part_n = chunk_n + nch_max;                    // nch_max

  const int b = blockIdx.y;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int c0 = tx * TX, r0 = ty * TY;
  const int nc = min(TX, Wx - c0), nr = min(TY, Wy - r0);
  const int s = stride, w = window;
  const int q = w / s, rem = w - q * s;
  const int fw = (nc - 1) * s + w;                    // footprint columns
  const int nch = nc + q;                             // chunks of s columns
  // units start `lead` columns before the footprint, on a 16-byte boundary
  const int lead = aligned ? (c0 * s) % V : 0;
  const T* f = data + (size_t)b * Ny * Nx + (size_t)c0 * s - lead;
  T* o = out + (size_t)b * Wy * Wx + c0;
  const double fill_b = fill ? fill[b] : 0.0;

  double v[S][V];
  int n[S][V];
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) { v[k][j] = 0.0; n[k][j] = 0; }

  for (int r = r0; r < r0 + nr; ++r) {
    const int y = r * s;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int x0 = (threadIdx.x + k * nt) * V;      // from f
      if (x0 >= lead + fw) continue;
      const int last = lead + fw - x0;
      if (r == r0 || s >= w) {                        // the window's rows
#pragma unroll
        for (int j = 0; j < V; ++j) { v[k][j] = 0.0; n[k][j] = 0; }
        const T* p = f + (size_t)y * Nx + x0;
        int i = 0;
        for (; i + kBatch <= w; i += kBatch) {
          T a[kBatch][V];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            load_unit(p + (size_t)(i + u) * Nx, aligned, last, a[u]);
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
#pragma unroll
            for (int j = 0; j < V; ++j) add_point(a[u][j], v[k][j], n[k][j]);
        }
        for (; i < w; ++i) {
          T a[V];
          load_unit(p + (size_t)i * Nx, aligned, last, a);
#pragma unroll
          for (int j = 0; j < V; ++j) add_point(a[j], v[k][j], n[k][j]);
        }
      } else {                                        // rows in, rows out
        const T* in = f + (size_t)(y - s + w) * Nx + x0;
        const T* gone = f + (size_t)(y - s) * Nx + x0;
        int i = 0;
        for (; i + kBatch <= s; i += kBatch) {
          T a[kBatch][V], d[kBatch][V];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            load_unit(in + (size_t)(i + u) * Nx, aligned, last, a[u]);
            load_unit(gone + (size_t)(i + u) * Nx, aligned, last, d[u]);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
#pragma unroll
            for (int j = 0; j < V; ++j) {
              add_point(a[u][j], v[k][j], n[k][j]);
              sub_point(d[u][j], v[k][j], n[k][j]);
            }
        }
        for (; i < s; ++i) {
          T a[V], d[V];
          load_unit(in + (size_t)i * Nx, aligned, last, a);
          load_unit(gone + (size_t)i * Nx, aligned, last, d);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            add_point(a[j], v[k][j], n[k][j]);
            sub_point(d[j], v[k][j], n[k][j]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int x = (threadIdx.x + k * nt) * V + j - lead;
        if (x >= 0 && x < fw) { col_v[x] = v[k][j]; col_n[x] = n[k][j]; }
      }
    __syncthreads();
    // chunk j: columns j s .. j s + s - 1 of the footprint (the last one
    // holds only its first rem); part: the first rem of them
    for (int j = threadIdx.x; j < nch; j += nt) {
      const int x0 = j * s;
      const int len = min(s, fw - x0);
      double cv = 0.0, pv = 0.0;
      int cn = 0, pn = 0;
      for (int l = 0; l < len; ++l) {
        cv += col_v[x0 + l];
        cn += col_n[x0 + l];
        if (l == rem - 1) { pv = cv; pn = cn; }
      }
      chunk_v[j] = cv; chunk_n[j] = cn;
      part_v[j] = pv; part_n[j] = pn;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += nt) {
      double sum = 0.0;
      int cnt = 0;
      for (int j = c; j < c + q; ++j) { sum += chunk_v[j]; cnt += chunk_n[j]; }
      if (rem) { sum += part_v[c + q]; cnt += part_n[c + q]; }
      T m;
      if (cnt < min_count) m = (T)__longlong_as_double(kNaN);
      else if (cnt == 0) m = (T)fill_b;
      else m = (T)(sum / cnt);
      o[(size_t)r * Wx + c] = m;
    }
    // no third barrier: the next row writes col_v after the barrier that
    // ended this row's chunk reads, and chunk_v after the one that ends
    // this row's window reads
  }
}

template <typename T, int C>
int launch(const void* data, const void* fill, void* out, int B, int Ny,
           int Nx, int Wy, int Wx, int window, int stride, int min_count,
           int TX, int TY, int ntx, int nty, int threads, int nch_max,
           int aligned, cudaStream_t st) {
  const size_t smem = (size_t)(threads * C + 2 * nch_max) *
                      (sizeof(double) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_means_kernel<T, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  for (int f0 = 0; f0 < B; f0 += kMaxFields) {
    const int nb = B - f0 < kMaxFields ? B - f0 : kMaxFields;
    const dim3 grid((unsigned)(ntx * nty), (unsigned)nb);
    window_means_kernel<T, C><<<grid, threads, smem, st>>>(
        (const T*)data + (size_t)f0 * Ny * Nx,
        fill ? (const double*)fill + f0 : nullptr,
        (T*)out + (size_t)f0 * Wy * Wx, Ny, Nx, Wy, Wx, window, stride,
        min_count, TX, TY, ntx, nch_max, aligned);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename T>
int launch_cols(int threads, int cols, const void* data, const void* fill,
                void* out, int B, int Ny, int Nx, int Wy, int Wx, int window,
                int stride, int min_count, int TX, int TY, int ntx, int nty,
                int nch_max, cudaStream_t st) {
  const int aligned = Nx % Unit<T>::V == 0 && (uintptr_t)data % 16 == 0;
  if (cols == 4)
    return launch<T, 4>(data, fill, out, B, Ny, Nx, Wy, Wx, window, stride,
                        min_count, TX, TY, ntx, nty, threads, nch_max,
                        aligned, st);
  if (cols == 16)
    return launch<T, 16>(data, fill, out, B, Ny, Nx, Wy, Wx, window, stride,
                         min_count, TX, TY, ntx, nty, threads, nch_max,
                         aligned, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// data (B, Ny, Nx) of itemsize bytes (4: float32, 8: float64); fill (B,)
// float64 or null; out (B, Wy, Wx) the window means, in data's type; the
// tiles of TY anchor rows x TX anchors (ntx across, nty down), the threads
// a block and the columns a thread holds (4 or 16) from
// kernels/rolling.py's plan.
extern "C" int xc_window_means(const void* data, const void* fill, void* out,
                               int B, int Ny, int Nx, int Wy, int Wx,
                               int window, int stride, int min_count,
                               int itemsize, int TX, int TY, int ntx,
                               int nty, int threads, int cols, int nch_max,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // room for the footprint after a lead of up to 3 columns
  if (B < 1 || Wy < 1 || Wx < 1 || window < 1 || stride < 1 || TX < 1 ||
      TY < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      (TX - 1) * stride + window + 3 > threads * cols)
    return (int)cudaErrorInvalidValue;
  if (itemsize == 4)
    return launch_cols<float>(threads, cols, data, fill, out, B, Ny, Nx, Wy,
                              Wx, window, stride, min_count, TX, TY, ntx,
                              nty, nch_max, st);
  if (itemsize == 8)
    return launch_cols<double>(threads, cols, data, fill, out, B, Ny, Nx, Wy,
                               Wx, window, stride, min_count, TX, TY, ntx,
                               nty, nch_max, st);
  return (int)cudaErrorInvalidValue;
}
