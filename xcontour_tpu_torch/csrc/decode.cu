// The archive decode: a chunk of a file variable's raw planes, as the file
// stores them, into the snapshots a step takes.
//
// No TPU kernel: the JAX package's CLI decodes on the host
// (xcontour_tpu/cli.py:133, _LazyField._read).  The port's runner copies the
// file's bytes unchanged into pinned memory and to the card, and this
// kernel, launched on the copy stream after the copy, does what the host
// did: the byte order (big- or little-endian float32 or float64), the flip
// of a descending latitude, the cast to the run's dtype and the fluid mask
// (NaN where the mask is 0, as np.where(mask != 0, v, nan)).
//
// Bound on the H100: device-memory traffic.  Each cell reads its file
// bytes (4 or 8) once and writes its value (4 or 8) once; the mask, one
// byte a cell of one plane, is shared by the chunk's planes and comes from
// L2 after the first.
//
// Design: a flat index over vectors of V cells, 16 bytes of the file (V = 4
// float32 or 2 float64), row after row; output row r of a plane reads file
// row Ny - 1 - r under the flip, so the flip costs an index and nothing
// else.  Each lane issues kUnroll streaming loads (evict-first: the bytes
// are read once) before it converts and stores any, to keep enough bytes in
// flight.  The stores stream too: the chunk, past L2's 50 MB at ERA5, is
// read back from HBM by the step anyway (on the H100 at the ERA5 chunk a
// twin without the mask and the casts went from 80% to 84% of its bytes
// bound so; this kernel reads 77-82% there, Tensor.copy_ of the same bytes
// 75%, a cast to float64 62%).  The byte swap is __byte_perm on
// 32-bit words (a float64 swaps its two words too); the cast rounds to
// nearest (__double2float_rn, as numpy's astype), and a masked cell is the
// quiet NaN numpy writes (0x7fc00000, 0x7ff8000000000000).  Where Nx or a
// pointer's alignment forbids vectors, V = 1: one cell a lane, as K1 falls
// back, loaded a 32-bit word at a time (raw needs 4-byte alignment alone).
// Indices are 32-bit (the wrapper takes fewer than 2^31 cells).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// 32-bit words a cell of type In
template <typename In>
constexpr int kWords = sizeof(In) / 4;

template <typename In, int V>
struct Raw {
  uint32_t w[V * kWords<In>];
};

template <typename In, int V>
__device__ __forceinline__ void load_raw(const In* p, Raw<In, V>& r) {
  constexpr int nbytes = V * sizeof(In);
  if constexpr (nbytes == 16) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
    r.w[0] = t.x; r.w[1] = t.y; r.w[2] = t.z; r.w[3] = t.w;
  } else {                                 // one cell, a word at a time
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
#pragma unroll
    for (int k = 0; k < kWords<In>; ++k) r.w[k] = __ldcs(q + k);
  }
}

__device__ __forceinline__ uint32_t bswap32(uint32_t w) {
  return __byte_perm(w, 0, 0x0123);
}

// cell v of a raw vector, in native byte order
template <typename In>
__device__ __forceinline__ In cell(const uint32_t* w, int v, bool swap);

template <>
__device__ __forceinline__ float cell<float>(const uint32_t* w, int v,
                                             bool swap) {
  return __uint_as_float(swap ? bswap32(w[v]) : w[v]);
}

template <>
__device__ __forceinline__ double cell<double>(const uint32_t* w, int v,
                                               bool swap) {
  // the file's 8 bytes as two little-endian words: reversed, the first
  // word's bytes are the high word's
  const uint32_t a = w[2 * v], b = w[2 * v + 1];
  const uint32_t lo = swap ? bswap32(b) : a;
  const uint32_t hi = swap ? bswap32(a) : b;
  return __hiloint2double((int)hi, (int)lo);
}

template <typename Out>
__device__ __forceinline__ Out cast(float x);
template <>
__device__ __forceinline__ float cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ double cast<double>(float x) { return (double)x; }

template <typename Out>
__device__ __forceinline__ Out cast(double x);
template <>
__device__ __forceinline__ float cast<float>(double x) {
  return __double2float_rn(x);
}
template <>
__device__ __forceinline__ double cast<double>(double x) { return x; }

template <typename Out>
__device__ __forceinline__ Out quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __uint_as_float(0x7fc00000u);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000ll);
}

// V mask bytes, one a cell, as bits 8v..8v+7 of a word
template <int V>
__device__ __forceinline__ uint32_t load_mask(const uint8_t* p) {
  if constexpr (V == 4) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (V == 2) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    return __ldg(p);
  }
}

template <typename Out, int V>
__device__ __forceinline__ void store_out(Out* p, const Out (&o)[V]) {
  constexpr int nbytes = V * sizeof(Out);
  if constexpr (nbytes == 32) {            // 4 doubles
    double2* q = reinterpret_cast<double2*>(p);
    __stcs(q, make_double2(o[0], o[1]));
    __stcs(q + 1, make_double2(o[2], o[3]));
  } else if constexpr (nbytes == 16 && sizeof(Out) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
  } else if constexpr (nbytes == 16) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(o[0], o[1]));
  } else if constexpr (nbytes == 8 && sizeof(Out) == 4) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(o[0], o[1]));
  } else {
    __stcs(p, o[0]);
  }
}

// raw (B * Ny rows of nv vectors) -> out, the same cells; mask (Ny, nv * V)
// bytes or null
template <typename In, typename Out, int V>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const In* __restrict__ raw, const uint8_t* __restrict__ mask,
              Out* __restrict__ out, int Ny, int nv, int total, int swap,
              int flip) {
  const int first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  Raw<In, V> r[kUnroll];
  int row[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = first + u * kThreads;
    row[u] = i / nv;
    if (i < total) {
      const int vc = i - row[u] * nv;
      const int y = row[u] % Ny;
      const int src = flip ? row[u] + Ny - 1 - 2 * y : row[u];
      load_raw<In, V>(raw + ((size_t)src * nv + vc) * V, r[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = first + u * kThreads;
    if (i >= total) break;
    const int vc = i - row[u] * nv;
    const uint32_t keep = mask ? load_mask<V>(
        mask + ((size_t)(row[u] % Ny) * nv + vc) * V) : 0x01010101u;
    Out o[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      o[v] = (keep >> (8 * v)) & 0xffu
                 ? cast<Out>(cell<In>(r[u].w, v, swap))
                 : quiet_nan<Out>();
    store_out<Out, V>(out + (size_t)i * V, o);
  }
}

template <typename In, typename Out, int V>
void launch(const void* raw, const void* mask, void* out, int B, int Ny,
            int Nx, int swap, int flip, cudaStream_t st) {
  const int nv = Nx / V;
  const int total = B * Ny * nv;
  const int blocks = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  decode_kernel<In, Out, V><<<blocks, kThreads, 0, st>>>(
      (const In*)raw, (const uint8_t*)mask, (Out*)out, Ny, nv, total, swap,
      flip);
}

template <typename In, typename Out>
void launch_aligned(const void* raw, const void* mask, void* out, int B,
                    int Ny, int Nx, int swap, int flip, cudaStream_t st) {
  constexpr int V = 16 / sizeof(In);
  const uintptr_t addr = (uintptr_t)raw | (uintptr_t)mask | (uintptr_t)out;
  if (Nx % V == 0 && addr % 16 == 0)
    launch<In, Out, V>(raw, mask, out, B, Ny, Nx, swap, flip, st);
  else
    launch<In, Out, 1>(raw, mask, out, B, Ny, Nx, swap, flip, st);
}

}  // namespace

// raw: B * Ny * Nx cells of in_bytes (4: float32, 8: float64) in the file's
// byte order (swap: not the card's); out: the same cells of out_bytes,
// row r of a plane from raw row Ny - 1 - r under flip; mask: (Ny, Nx)
// bytes in out's rows, 0 where a cell is NaN'd, or null
extern "C" int xc_decode_planes(const void* raw, const void* mask, void* out,
                                int B, int Ny, int Nx, int in_bytes,
                                int out_bytes, int swap, int flip,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bytes == 4 && out_bytes == 4)
    launch_aligned<float, float>(raw, mask, out, B, Ny, Nx, swap, flip, st);
  else if (in_bytes == 4 && out_bytes == 8)
    launch_aligned<float, double>(raw, mask, out, B, Ny, Nx, swap, flip, st);
  else if (in_bytes == 8 && out_bytes == 4)
    launch_aligned<double, float>(raw, mask, out, B, Ny, Nx, swap, flip, st);
  else if (in_bytes == 8 && out_bytes == 8)
    launch_aligned<double, double>(raw, mask, out, B, Ny, Nx, swap, flip, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
