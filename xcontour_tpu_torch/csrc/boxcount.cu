// B: box-counting crossing lengths, every stride of a call in one launch.
//
// No TPU kernel: the JAX package computes box counting in plain jnp
// (xcontour_tpu/diagnostics/length.py:249, _crossing_one_stride).  The
// port's plain version (kernels/boxcount.py) takes ~60 launches a stride and
// a (levels x boxes) temporary a chunk of 16 levels; this kernel keeps the
// boxes in shared memory and writes only the totals.
//
// What it computes, for each field b, level k and stride s = strides[j] of
// the call, on the field padded in x by the largest stride (in torch,
// before the launch):
//
//   out[b, k, j] = sum over the boxes (r, c) of stride s of w(r, c)
//                  where wmin(r, c) <= level[b, k] < wmax(r, c).
//
// Box (r, c) covers rows r*s .. r*s+s and columns c*s .. c*s+s; (wmin, wmax)
// is the NaN-skipping min and max of its points (+inf, -inf for an all-NaN
// box, which crosses nothing); w = sqrt(area) * s at (r*s, c*s), or at
// (r, c) under `quirks` (the reference's indexing), and 0 where that is
// NaN.  A column at or past the padded width W reads as NaN: the reference's
// quirks loop can ask for more column boxes than W holds, and its clamped
// numpy slices give such a box only its points inside (the plain version
// appends NaN columns).  The test is the plain version's float32 test on
// the same float32 values, so the crossed (box, level) pairs are the same,
// whatever the order of the levels and for NaN levels (which cross nothing).
//
// Bound on the H100: FP32 issue, two compares a (box, level) test.  T170's
// step (32 x 256 x 512, strides 1-32, N = 121): 5.9 M boxes, 713 M tests,
// 0.043 ms; its 17 MB of field take 0.005 ms at 3.35 TB/s.
//
// Design: one launch for every stride of the call, from the launch table
// the wrapper builds (kernels/boxcount.py, plan): per stride its box rows
// and columns, the tile of R box rows x T box columns a block takes, and
// the stride's first block.  A block takes one tile of one field (grid x:
// the tiles of every field, stride by stride, the largest stride first, as
// its blocks read the most points a box).  Its 256 threads work in turn:
//  1. Teams of Z lanes (the power of two at or above (s + 1) / 2, at most
//     32) reduce one box at a time, a lane one or two columns of s + 1
//     points (at stride 1 a lane the whole box), then shuffles; each lane
//     loads the box's area first, beside its points, and the team's first
//     lane stores (min, max, weight) in shared memory.  A tile holds at
//     most 2,048 boxes and reads about 16K points at most, so a large
//     stride takes small tiles and still fills the card.
//  2. Up to 1,024 levels at a time, kLev = 4 a lane: the lanes that hold
//     them make whole warps, and the G = 256 / lanes groups of them split
//     the tile's boxes (g, g + G, ...): every lane of a warp reads the same
//     box, a broadcast from shared memory, and tests it against its four
//     levels.
//     The groups' sums are folded in group order into the block's partial
//     of each level.
// The last block of a (field, stride) to finish (a counter a pair, zeroed
// before the launch) folds the partials of its blocks in block order.  Every
// sum has a fixed order, so two runs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBoxes = 2048;       // boxes a tile (kernels/boxcount.py)
constexpr int kLev = 4;            // levels a lane
constexpr int kMaxStrides = 32;    // strides a launch
constexpr int kCols = 9;           // ints a row of the launch table

struct Table {
  int n;                           // strides
  int stride[kMaxStrides];
  int col[kMaxStrides];            // the stride's column of out
  int rows[kMaxStrides];           // box rows, box columns
  int cols[kMaxStrides];
  int T[kMaxStrides];              // a tile: R box rows of T boxes
  int R[kMaxStrides];
  int ntc[kMaxStrides];            // tiles across, tiles a field
  int nbf[kMaxStrides];
  int off[kMaxStrides + 1];        // the stride's first block
};

// lanes a box of stride s: a lane one or two columns of s + 1 points
__device__ __forceinline__ int team_size(int s) {
  int z = 1;
  while (2 * z < s + 1 && z < 32) z <<= 1;
  return z;
}

__global__ void __launch_bounds__(kThreads)
boxcount_kernel(const float* __restrict__ data, const float* __restrict__ area,
                const float* __restrict__ levels, float* __restrict__ partial,
                unsigned int* __restrict__ count, float* __restrict__ out,
                int Ny, int W, int N, int quirks, const Table tab) {
  __shared__ float4 box[kBoxes];
  __shared__ float red[kThreads * kLev];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  int j = 0;
  while (j + 1 < tab.n && p >= tab.off[j + 1]) ++j;
  const int s = tab.stride[j];
  const int nbf = tab.nbf[j];
  const int local = p - tab.off[j];
  const int b = local / nbf;
  const int t = local - b * nbf;
  const int rb = t / tab.ntc[j];
  const int r0 = rb * tab.R[j];
  const int c0 = (t - rb * tab.ntc[j]) * tab.T[j];
  const int nr = max(0, min(tab.R[j], tab.rows[j] - r0));
  const int nc = max(0, min(tab.T[j], tab.cols[j] - c0));
  const int nb = nr * nc;
  const float* field = data + (size_t)b * Ny * W;

  // 1. the tile's boxes: (min, max, weight)
  const int Z = team_size(s);
  const int team = tid / Z, lane = tid - team * Z;
  for (int base = 0; base < nb; base += kThreads / Z) {
    const int i = base + team;
    float lo = INFINITY, hi = -INFINITY, w = NAN;
    if (i < nb) {
      const int r = r0 + i / nc;
      const int c = c0 + i % nc;
      const int ay = quirks ? r : r * s;
      const int ax = quirks ? c : c * s;
      if (ax < W) w = __ldg(area + (size_t)ay * W + ax);
      const float* top = field + (size_t)r * s * W;
      for (int x = c * s + lane; x <= c * s + s && x < W; x += Z) {
#pragma unroll 4
        for (int dy = 0; dy <= s; ++dy) {
          const float v = __ldg(top + (size_t)dy * W + x);
          lo = fminf(lo, v);       // fminf and fmaxf skip a NaN
          hi = fmaxf(hi, v);
        }
      }
    }
    for (int o = Z / 2; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (i < nb && lane == 0) {
      w = sqrtf(w) * (float)s;
      box[i] = make_float4(lo, hi, isnan(w) ? 0.f : w, 0.f);
    }
  }
  __syncthreads();

  // 2. the tile's sum of each level
  const float* lev = levels + (size_t)b * N;
  float* part = partial + (size_t)p * N;
  for (int k0 = 0; k0 < N; k0 += kLev * kThreads) {
    const int P = min(N - k0, kLev * kThreads);
    const int Lg = (((P + kLev - 1) / kLev) + 31) & ~31;
    const int G = kThreads / Lg;
    const int g = tid / Lg, jl = tid - g * Lg;
    float c[kLev], acc[kLev];
#pragma unroll
    for (int m = 0; m < kLev; ++m) {
      const int q = jl + m * Lg;
      c[m] = (g < G && q < P) ? __ldg(lev + k0 + q) : NAN;
      acc[m] = 0.f;
    }
    if (g < G) {
#pragma unroll 4
      for (int i = g; i < nb; i += G) {
        const float4 v = box[i];
#pragma unroll
        for (int m = 0; m < kLev; ++m)
          if (v.x <= c[m] && v.y > c[m]) acc[m] += v.z;   // a predicated add
      }
    }
#pragma unroll
    for (int m = 0; m < kLev; ++m) red[tid * kLev + m] = acc[m];
    __syncthreads();
    for (int q = tid; q < P; q += kThreads) {
      const int jq = q % Lg, mq = q / Lg;
      float sum = 0.f;
      for (int gg = 0; gg < G; ++gg) sum += red[(gg * Lg + jq) * kLev + mq];
      part[k0 + q] = sum;
    }
    __syncthreads();
  }

  // the last block of this (field, stride) folds the partials in order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(count + (size_t)b * tab.n + j, 1u) == (unsigned)(nbf - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* first = partial + ((size_t)tab.off[j] + (size_t)b * nbf) * N;
  for (int k = tid; k < N; k += kThreads) {
    float sum = 0.f;
    for (int u = 0; u < nbf; ++u) sum += __ldcg(first + (size_t)u * N + k);
    out[((size_t)b * N + k) * tab.n + tab.col[j]] = sum;
  }
}

}  // namespace

// data (B, Ny, W) and area (Ny, W): the field and the cell areas padded in
// x; levels (B, N); partial: N floats a block; count: B * S words; out
// (B, N, S); table: S rows of kCols ints (host memory), each stride, its
// column of out, box rows, box columns, T, R, tiles across, tiles a field,
// first block; blocks: the table's total
extern "C" int xc_box_counts(const void* data, const void* area,
                             const void* levels, void* partial, void* count,
                             void* out, int B, int Ny, int W, int N, int S,
                             int quirks, const int* table, int blocks,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || S > kMaxStrides || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Table tab;
  tab.n = S;
  for (int j = 0; j < S; ++j) {
    const int* row = table + j * kCols;
    tab.stride[j] = row[0];
    tab.col[j] = row[1];
    tab.rows[j] = row[2];
    tab.cols[j] = row[3];
    tab.T[j] = row[4];
    tab.R[j] = row[5];
    tab.ntc[j] = row[6];
    tab.nbf[j] = row[7];
    tab.off[j] = row[8];
    if (tab.T[j] * tab.R[j] > kBoxes) return (int)cudaErrorInvalidValue;
  }
  tab.off[S] = blocks;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned int) * B * S,
                                    st);
  if (err != cudaSuccess) return (int)err;
  boxcount_kernel<<<blocks, kThreads, 0, st>>>(
      (const float*)data, (const float*)area, (const float*)levels,
      (float*)partial, (unsigned int*)count, (float*)out, Ny, W, N, quirks,
      tab);
  return (int)cudaGetLastError();
}
