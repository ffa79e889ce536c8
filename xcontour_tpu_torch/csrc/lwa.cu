// K3-K6: local finite-amplitude wave activity (LWA) and its impulse-Casimir
// variant (LWA2), the LWA stages of the Keff/LWA pipelines.
//
// K3 replaces xcontour_tpu/kernels/lwa_pallas.py, _kernel_lin (launched by
// _lwa_pallas_lin(variant2=False)): the linearized LWA for part='all',
//
//   LWA[j, x] = -(R_j(x) + E[j, x]),
//   R_j(x)    = sum_y ext(qk[y, x] - Q_j) * Wv[y, x],
//
// with ext = min(., 0) for increasing tracers and max(., 0) otherwise, and
// E the t-term built by the telescoping recurrence of lwa_pallas.py:97-111.
// Inputs arrive centered on the profile midpoint (the centering stays in
// torch, as in the JAX launcher).  Non-finite cells are invalid: they
// become +-inf sentinels with zero weight.  NaN profile rows give 0.
//
// K4 replaces xcontour_tpu/kernels/lwa_pallas.py, _kernel (launched by
// lwa_pallas(pairwise=True)): the pairwise LWA,
//
//   LWA[j, x] = -sum_y qz * mask3(qe, y >= j) * Wz[y, x],
//   qe = q(y, x) - Q_j (variant 1)  or  q(y_j, x) - Q(y) (variant 2),
//
// with the reference's 3-valued mask, parts all/upper/lower, NaN qe -> 0.
// Variant 2 builds the mask with the flipped increase flag and selects
// parts with the original one.  Like the JAX twin (_lwa_dense_xla) it takes
// weights with NaN zeroed (the TPU kernel leaves a NaN weight in), and it
// keeps the product form qz * mask * W, so an infinite qe on a row whose
// mask is 0 gives NaN as it does in the twin.
//
// K6 replaces xcontour_tpu/kernels/lwa_pallas.py, _kernel_yblocked, which
// lwa_pallas takes for both variants when Ny > 3072 (float32): it blocks
// the y reduction only to fit a (Ny, 128) panel in the TPU's VMEM.  K4
// already stages y in 32-row shared-memory panels at every Ny, so K6 is
// K4's kernel run in that regime; offsets are 64-bit, and the wrapper
// refuses 2^31 cells.
//
// K5 replaces xcontour_tpu/kernels/lwa_pallas.py, _kernel_lin2 (launched by
// _lwa_pallas_lin(variant2=True)): the linearized LWA2 for part='all',
//
//   LWA2[j, x] = -(R_j(x) + E[j, x]),
//   R_j(x)     = sum_y ext(q(y_j, x) - Q(y)) * Wv[y, x],
//
// with ext = max(., 0) for increasing tracers (the flipped mask) and
// min(., 0) otherwise.  Invalid profile rows become +-inf sentinels with
// zero weight; a non-finite surface value gives 0.  Unlike K3, the
// reduction rows are profile rows, so Wv is formed while a panel is staged
// and only E needs scratch.
//
// Bound on the H100: FP32 issue.  Every surface j meets every cell: Ny^2*Nx
// pairs per snapshot on Ny*Nx data.  K3 and K5 spend 3 instructions per
// pair (sub, min/max, FMA), K4 about 10 (sub, NaN test, two compares,
// selects, FMA).
//
// Design (all kernels): a block of 32 x 8 threads covers 32 columns and 64
// surfaces; each thread keeps 8 surfaces' operand (Q_j in variant 1,
// q(y_j, x) in variant 2) and running sums in registers.  The block stages
// 32-row panels in shared memory (variant 1: its columns' q and W;
// variant 2: the 32 profile values and W), so each staged value feeds 8
// surfaces per thread and 64 per block.  Every surface reduction is x-separable (the mask depends only
// on the row index), so blocks need no communication.  Surface tiles are
// the fastest grid dimension: the blocks that share a column strip run
// together and read it from L2.
//
// K3's prep kernel runs first: one thread per (b, x) column walks y in
// order, writing the sanitized qk, Wv and E.  E's increments are
// deviation-scaled,
//   E[j] = E[j-1] + (Qt[j] - qt[j-1]) * Wv[j-1] + (Qt[j] - Qt[j-1]) * P0[j-1]
// with P0[j] = sum_{y<j} Wv, so no eps*total loss appears in float32 (the
// naive P1 - Q_j*P0 form does).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTX = 32;           // columns per block (one warp)
constexpr int kJG = 8;            // surface groups per block (threadIdx.y)
constexpr int kJPT = 8;           // surfaces per thread
constexpr int kTJ = kJG * kJPT;   // surfaces per block
constexpr int kYP = 32;           // rows per staged panel

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

__global__ void lwa_lin_prep_kernel(const float* __restrict__ qc,
                                    const float* __restrict__ Wz,
                                    const float* __restrict__ Qt,
                                    float* __restrict__ qk,
                                    float* __restrict__ Wv,
                                    float* __restrict__ E, int Ny, int Nx,
                                    float sent) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= Nx) return;
  const int b = blockIdx.y;
  const long long base = (long long)b * Ny * Nx;
  const float* Qb = Qt + (long long)b * Ny;
  float P0 = 0.0f;    // sum_{i<y} Wv[i]
  float P0m1 = 0.0f;  // sum_{i<y-1} Wv[i]
  float e = 0.0f, qt_prev = 0.0f, w_prev = 0.0f, Q_prev = 0.0f;
  for (int y = 0; y < Ny; ++y) {
    const long long o = (long long)y * Nx + x;
    const float qv = qc[base + o];
    const float wv = Wz[o];
    const bool valid = isfinite(qv) && isfinite(wv);
    const float Qy = Qb[y];
    if (y > 0) e += (Qy - qt_prev) * w_prev + (Qy - Q_prev) * P0m1;
    const float wvv = valid ? wv : 0.0f;
    qk[base + o] = valid ? qv : sent;
    Wv[base + o] = wvv;
    E[base + o] = e;
    P0m1 = P0;
    P0 += wvv;
    qt_prev = valid ? qv : 0.0f;
    w_prev = wvv;
    Q_prev = Qy;
  }
}

template <bool kInc>
__global__ void __launch_bounds__(kTX * kJG)
lwa_lin_kernel(const float* __restrict__ qk, const float* __restrict__ Wv,
               const float* __restrict__ E, const float* __restrict__ Qc,
               float* __restrict__ out, int Ny, int Nx, float sent) {
  __shared__ float sq[kYP][kTX];
  __shared__ float sw[kYP][kTX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.y * kTX;
  const int x = x0 + tx;
  const int j0 = blockIdx.x * kTJ + ty * kJPT;
  const int b = blockIdx.z;
  const long long plane = (long long)Ny * Nx;
  const float* qkb = qk + b * plane;
  const float* Wvb = Wv + b * plane;

  float Qj[kJPT], acc[kJPT];
#pragma unroll
  for (int k = 0; k < kJPT; ++k) {
    const int j = j0 + k;
    Qj[k] = j < Ny ? Qc[(long long)b * Ny + j] : 0.0f;
    acc[k] = 0.0f;
  }

  for (int y0 = 0; y0 < Ny; y0 += kYP) {
    for (int r = ty; r < kYP; r += kJG) {
      const int yy = y0 + r;
      const bool in = yy < Ny && x < Nx;
      const long long o = (long long)yy * Nx + x;
      sq[r][tx] = in ? qkb[o] : sent;
      sw[r][tx] = in ? Wvb[o] : 0.0f;
    }
    __syncthreads();
    const int rows = min(kYP, Ny - y0);
    for (int r = 0; r < rows; ++r) {
      const float qv = sq[r][tx];
      const float wv = sw[r][tx];
#pragma unroll
      for (int k = 0; k < kJPT; ++k) {
        const float qe = qv - Qj[k];
        const float ext = kInc ? min_nan(qe, 0.0f) : max_nan(qe, 0.0f);
        acc[k] = fmaf(ext, wv, acc[k]);
      }
    }
    __syncthreads();
  }

  if (x >= Nx) return;
#pragma unroll
  for (int k = 0; k < kJPT; ++k) {
    const int j = j0 + k;
    if (j < Ny) {
      const long long o = b * plane + (long long)j * Nx + x;
      out[o] = isnan(Qj[k]) ? 0.0f : -(acc[k] + E[o]);
    }
  }
}

// kPart: 0 all, 1 upper, 2 lower.  kV2: variant 2 (impulse-Casimir), whose
// per-thread operands are the surface values q(y_j, x) and whose staged
// panel is the profile Q(y); v1 holds Q_j and stages q(y, x).
template <bool kInc, int kPart, bool kV2>
__global__ void __launch_bounds__(kTX * kJG)
lwa_dense_kernel(const float* __restrict__ q, const float* __restrict__ Wz,
                 const float* __restrict__ Q, float* __restrict__ out, int Ny,
                 int Nx) {
  static_assert(kYP == kTX, "one warp stages a profile panel");
  // variant 2 builds its mask with the flipped flag, and selects parts with
  // the original one (lwa_pallas.py:52-70)
  constexpr bool kMaskInc = kV2 ? !kInc : kInc;
  __shared__ float sq[kYP][kTX];
  __shared__ float sQ[kYP];
  __shared__ float sw[kYP][kTX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.y * kTX + tx;
  const int j0 = blockIdx.x * kTJ + ty * kJPT;
  const int b = blockIdx.z;
  const long long plane = (long long)Ny * Nx;
  const float* qb = q + b * plane;
  const float* Qb = Q + (long long)b * Ny;

  float s[kJPT], acc[kJPT];
#pragma unroll
  for (int k = 0; k < kJPT; ++k) {
    const int j = j0 + k;
    if (kV2)
      s[k] = j < Ny && x < Nx ? qb[(long long)j * Nx + x] : 0.0f;
    else
      s[k] = j < Ny ? Qb[j] : 0.0f;
    acc[k] = 0.0f;
  }

  for (int y0 = 0; y0 < Ny; y0 += kYP) {
    for (int r = ty; r < kYP; r += kJG) {
      const int yy = y0 + r;
      const bool in = yy < Ny && x < Nx;
      const long long o = (long long)yy * Nx + x;
      if (!kV2) sq[r][tx] = in ? qb[o] : __int_as_float(0x7fc00000);
      sw[r][tx] = in ? Wz[o] : 0.0f;
    }
    if (kV2 && ty == 0) sQ[tx] = y0 + tx < Ny ? Qb[y0 + tx] : 0.0f;
    __syncthreads();
    const int rows = min(kYP, Ny - y0);
    for (int r = 0; r < rows; ++r) {
      const float v = kV2 ? sQ[r] : sq[r][tx];
      const float wv = sw[r][tx];
      const int y = y0 + r;
#pragma unroll
      for (int k = 0; k < kJPT; ++k) {
        const float qe = kV2 ? s[k] - v : v - s[k];
        const float qz = isnan(qe) ? 0.0f : qe;
        const bool m = y >= j0 + k;
        float mask;
        if (kMaskInc)
          mask = m ? (qe < 0.0f ? 1.0f : 0.0f) : (qe > 0.0f ? -1.0f : 0.0f);
        else
          mask = m ? (qe > 0.0f ? 1.0f : 0.0f) : (qe < 0.0f ? -1.0f : 0.0f);
        if (kPart == 1) {
          const bool keep = kInc ? mask > 0.0f : mask < 0.0f;
          mask = keep ? mask : 0.0f;
        } else if (kPart == 2) {
          const bool keep = kInc ? mask < 0.0f : mask > 0.0f;
          mask = keep ? mask : 0.0f;
        }
        acc[k] = fmaf(qz * mask, wv, acc[k]);
      }
    }
    __syncthreads();
  }

  if (x >= Nx) return;
#pragma unroll
  for (int k = 0; k < kJPT; ++k) {
    const int j = j0 + k;
    if (j < Ny) out[b * plane + (long long)j * Nx + x] = -acc[k];
  }
}

// K5 prep: one thread per (b, x) column walks y in order and writes the
// variant-2 t-term,
//   E[j] = E[j-1] + (Qt[j-1] - qt[j]) * Wv[j-1] - (qt[j] - qt[j-1]) * P0[j-1]
// (lwa_pallas.py:169), with Wv zero on invalid profile rows and P0[j] the
// sum of Wv over y < j.  Tracer and profile are centered on c0 as they are
// read.
__global__ void lwa_lin2_prep_kernel(const float* __restrict__ q,
                                     const float* __restrict__ Q,
                                     const float* __restrict__ W,
                                     const float* __restrict__ c0,
                                     float* __restrict__ E, int Ny, int Nx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= Nx) return;
  const int b = blockIdx.y;
  const float c = c0[b];
  const long long base = (long long)b * Ny * Nx;
  const float* Qb = Q + (long long)b * Ny;
  float P0 = 0.0f;    // sum_{i<y} Wv[i]
  float P0m1 = 0.0f;  // sum_{i<y-1} Wv[i]
  float e = 0.0f, qt_prev = 0.0f, w_prev = 0.0f, Qt_prev = 0.0f;
  for (int y = 0; y < Ny; ++y) {
    const long long o = (long long)y * Nx + x;
    const float Qy = Qb[y];
    const bool validQ = isfinite(Qy);
    const float qv = q[base + o];
    const float qt = isfinite(qv) ? qv - c : 0.0f;
    const float w = W[o];
    const float wv = validQ && isfinite(w) ? w : 0.0f;
    if (y > 0) e += (Qt_prev - qt) * w_prev - (qt - qt_prev) * P0m1;
    E[base + o] = e;
    P0m1 = P0;
    P0 += wv;
    qt_prev = qt;
    w_prev = wv;
    Qt_prev = validQ ? Qy - c : 0.0f;
  }
}

// K5 surface kernel: each thread keeps 8 centered surface values q(y_j, x)
// and their sums in registers; the block stages 32-row panels of the
// sentinel profile (32 scalars) and of Wv, formed from W and the row's
// validity while staging.  A non-finite surface value gives 0.
template <bool kInc>
__global__ void __launch_bounds__(kTX * kJG)
lwa_lin2_kernel(const float* __restrict__ q, const float* __restrict__ Q,
                const float* __restrict__ W, const float* __restrict__ c0,
                const float* __restrict__ E, float* __restrict__ out, int Ny,
                int Nx) {
  static_assert(kYP == kTX, "one warp stages a profile panel");
  __shared__ float sQ[kYP];
  __shared__ float sw[kYP][kTX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.y * kTX + tx;
  const int j0 = blockIdx.x * kTJ + ty * kJPT;
  const int b = blockIdx.z;
  const long long plane = (long long)Ny * Nx;
  const float c = c0[b];
  // invalid profile rows become sentinels that the extremum clamps to 0
  const float sent = kInc ? INFINITY : -INFINITY;
  const float* qb = q + b * plane;
  const float* Qb = Q + (long long)b * Ny;

  float s[kJPT], acc[kJPT];
#pragma unroll
  for (int k = 0; k < kJPT; ++k) {
    const int j = j0 + k;
    s[k] = j < Ny && x < Nx ? qb[(long long)j * Nx + x] - c : 0.0f;
    acc[k] = 0.0f;
  }

  for (int y0 = 0; y0 < Ny; y0 += kYP) {
    for (int r = ty; r < kYP; r += kJG) {
      const int yy = y0 + r;
      const bool validQ = yy < Ny && isfinite(Qb[yy]);
      const float w = yy < Ny && x < Nx ? W[(long long)yy * Nx + x] : 0.0f;
      sw[r][tx] = validQ && isfinite(w) ? w : 0.0f;
    }
    if (ty == 0) {
      const float Qy = y0 + tx < Ny ? Qb[y0 + tx] : 0.0f;
      sQ[tx] = isfinite(Qy) ? Qy - c : sent;
    }
    __syncthreads();
    const int rows = min(kYP, Ny - y0);
    for (int r = 0; r < rows; ++r) {
      const float Qy = sQ[r];
      const float wv = sw[r][tx];
#pragma unroll
      for (int k = 0; k < kJPT; ++k) {
        const float qe = s[k] - Qy;
        const float ext = kInc ? fmaxf(qe, 0.0f) : fminf(qe, 0.0f);
        acc[k] = fmaf(ext, wv, acc[k]);
      }
    }
    __syncthreads();
  }

  if (x >= Nx) return;
#pragma unroll
  for (int k = 0; k < kJPT; ++k) {
    const int j = j0 + k;
    if (j < Ny) {
      const long long o = b * plane + (long long)j * Nx + x;
      out[o] = isfinite(s[k]) ? -(acc[k] + E[o]) : 0.0f;
    }
  }
}

using DenseKernel = void (*)(const float*, const float*, const float*, float*,
                             int, int);

// indexed by (variant2 * 3 + part) * 2 + increase
constexpr DenseKernel kDenseKernels[12] = {
    lwa_dense_kernel<false, 0, false>, lwa_dense_kernel<true, 0, false>,
    lwa_dense_kernel<false, 1, false>, lwa_dense_kernel<true, 1, false>,
    lwa_dense_kernel<false, 2, false>, lwa_dense_kernel<true, 2, false>,
    lwa_dense_kernel<false, 0, true>,  lwa_dense_kernel<true, 0, true>,
    lwa_dense_kernel<false, 1, true>,  lwa_dense_kernel<true, 1, true>,
    lwa_dense_kernel<false, 2, true>,  lwa_dense_kernel<true, 2, true>,
};

dim3 surface_grid(int B, int Ny, int Nx) {
  return dim3((Ny + kTJ - 1) / kTJ, (Nx + kTX - 1) / kTX, B);
}

}  // namespace

extern "C" int xc_lwa_lin(const void* qc, const void* Wz, const void* Qt,
                          const void* Qc, void* qk, void* Wv, void* E,
                          void* out, int B, int Ny, int Nx, int increase,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float sent = increase ? INFINITY : -INFINITY;
  const int pt = 128;
  lwa_lin_prep_kernel<<<dim3((Nx + pt - 1) / pt, B), pt, 0, st>>>(
      (const float*)qc, (const float*)Wz, (const float*)Qt, (float*)qk,
      (float*)Wv, (float*)E, Ny, Nx, sent);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = surface_grid(B, Ny, Nx), block(kTX, kJG);
  if (increase)
    lwa_lin_kernel<true><<<grid, block, 0, st>>>(
        (const float*)qk, (const float*)Wv, (const float*)E,
        (const float*)Qc, (float*)out, Ny, Nx, sent);
  else
    lwa_lin_kernel<false><<<grid, block, 0, st>>>(
        (const float*)qk, (const float*)Wv, (const float*)E,
        (const float*)Qc, (float*)out, Ny, Nx, sent);
  return (int)cudaGetLastError();
}

extern "C" int xc_lwa_dense(const void* q, const void* Wz, const void* Q,
                            void* out, int B, int Ny, int Nx, int increase,
                            int part, int variant2, void* stream) {
  if (part < 0 || part > 2) return (int)cudaErrorInvalidValue;
  const DenseKernel kernel =
      kDenseKernels[((variant2 ? 1 : 0) * 3 + part) * 2 + (increase ? 1 : 0)];
  kernel<<<surface_grid(B, Ny, Nx), dim3(kTX, kJG), 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)Wz, (const float*)Q, (float*)out, Ny, Nx);
  return (int)cudaGetLastError();
}

extern "C" int xc_lwa_lin2(const void* q, const void* Q, const void* W,
                           const void* c0, void* E, void* out, int B, int Ny,
                           int Nx, int increase, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int pt = 128;
  lwa_lin2_prep_kernel<<<dim3((Nx + pt - 1) / pt, B), pt, 0, st>>>(
      (const float*)q, (const float*)Q, (const float*)W, (const float*)c0,
      (float*)E, Ny, Nx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = surface_grid(B, Ny, Nx), block(kTX, kJG);
  if (increase)
    lwa_lin2_kernel<true><<<grid, block, 0, st>>>(
        (const float*)q, (const float*)Q, (const float*)W, (const float*)c0,
        (const float*)E, (float*)out, Ny, Nx);
  else
    lwa_lin2_kernel<false><<<grid, block, 0, st>>>(
        (const float*)q, (const float*)Q, (const float*)W, (const float*)c0,
        (const float*)E, (float*)out, Ny, Nx);
  return (int)cudaGetLastError();
}
