// K3's surface tiles, panel staging and row sum, shared with its structure
// probe P1 (probes.cu): blocks of 32 columns x 8 surface groups, kJ
// surfaces a thread in registers, kYP-row panels staged with cp.async
// (lin_panels, the loop both kernels run).
#pragma once

#include <cuda_runtime.h>

namespace xc_lwa {

constexpr int kTX = 32;           // columns per block (one warp)
constexpr int kJG = 8;            // surface groups per block (threadIdx.y)
constexpr int kJ = 16;            // K3's and K4's surfaces per thread
constexpr int kYP = 32;           // rows per staged panel of K3 and K5

// min/max that return NaN when an operand is NaN (jnp.minimum/maximum
// semantics; plain fminf/fmaxf would drop the NaN)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 4-byte asynchronous copy global -> shared; zero-fills when !in (the
// source address is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// K3: one staged row (qk, Wv) against a thread's kJ surfaces
template <bool kInc>
__device__ __forceinline__ void lin_row(float (&acc)[kJ],
                                        const float (&Qj)[kJ], float qv,
                                        float wv) {
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const float qe = qv - Qj[k];
    const float ext = kInc ? min_nan(qe, 0.0f) : max_nan(qe, 0.0f);
    acc[k] = fmaf(ext, wv, acc[k]);
  }
}

// K3's and P1's loop over column x of one batch element: rows [0, Ny) of
// qb (Ny, Nx) and W staged in kYP-row panels of sq and sw, double-buffered
// by cp.async; prep(buf) runs on each panel as it lands, before the
// barrier (K3 centers and sanitizes it, P1 leaves it), then each row goes
// through lin_row.  Thread (tx, ty) of a block of kTX x kJG.
template <bool kInc, class Prep>
__device__ __forceinline__ void lin_panels(float (&acc)[kJ],
                                           const float (&Qj)[kJ],
                                           float (&sq)[2][kYP][kTX],
                                           float (&sw)[2][kYP][kTX],
                                           const float* qb, const float* W,
                                           int Ny, int Nx, int x, Prep prep) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  auto stage = [&](int p, int buf) {
    for (int r = ty; r < kYP; r += kJG) {
      const int yy = p * kYP + r;
      const bool in = yy < Ny && x < Nx;
      const long long o = in ? (long long)yy * Nx + x : 0;
      cp_async4(&sq[buf][r][tx], qb + o, in);
      cp_async4(&sw[buf][r][tx], W + o, in);
    }
    cp_async_commit();
  };

  const int np = (Ny + kYP - 1) / kYP;
  stage(0, 0);
  for (int p = 0, buf = 0; p < np; ++p, buf ^= 1) {
    cp_async_wait_all();
    prep(buf);
    __syncthreads();
    if (p + 1 < np) stage(p + 1, buf ^ 1);
    const int rows = min(kYP, Ny - p * kYP);
    if (rows == kYP) {
#pragma unroll
      for (int r = 0; r < kYP; ++r)
        lin_row<kInc>(acc, Qj, sq[buf][r][tx], sw[buf][r][tx]);
    } else {
#pragma unroll 1
      for (int r = 0; r < rows; ++r)
        lin_row<kInc>(acc, Qj, sq[buf][r][tx], sw[buf][r][tx]);
    }
  }
}

}  // namespace xc_lwa
