// K3 and K4: local finite-amplitude wave activity (LWA), part of the
// Keff+LWA step.
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
// lwa_pallas(pairwise=True), variant2=False): the pairwise LWA,
//
//   LWA[j, x] = -sum_y qz * mask3(qe, y >= j) * Wz[y, x],  qe = q - Q_j,
//
// with the reference's 3-valued mask, parts all/upper/lower, NaN qe -> 0.
// Like the JAX twin (_lwa_dense_xla) it takes weights with NaN zeroed
// (the TPU kernel leaves a NaN weight in), and it keeps the product form
// qz * mask * W, so an infinite cell on a masked-out row gives NaN as it
// does in the twin.
//
// Bound on the H100: FP32 issue.  Every surface j meets every cell: Ny^2*Nx
// pairs per snapshot on Ny*Nx data.  K3 spends 3 instructions per pair
// (sub, NaN-propagating min/max, FMA), K4 about 10 (sub, NaN test, two
// compares, selects, FMA).
//
// Design (both kernels): a block of 32 x 8 threads covers 32 columns and 64
// surfaces; each thread keeps 8 surfaces' Q_j and running sums in
// registers.  The block stages 32-row panels of its columns' q and W in
// shared memory, so each staged value feeds 8 surfaces per thread and 64
// per block.  Every surface reduction is x-separable (the mask depends only
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

// kPart: 0 all, 1 upper, 2 lower
template <bool kInc, int kPart>
__global__ void __launch_bounds__(kTX * kJG)
lwa_dense_kernel(const float* __restrict__ q, const float* __restrict__ Wz,
                 const float* __restrict__ Q, float* __restrict__ out, int Ny,
                 int Nx) {
  __shared__ float sq[kYP][kTX];
  __shared__ float sw[kYP][kTX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.y * kTX + tx;
  const int j0 = blockIdx.x * kTJ + ty * kJPT;
  const int b = blockIdx.z;
  const long long plane = (long long)Ny * Nx;
  const float* qb = q + b * plane;

  float Qj[kJPT], acc[kJPT];
#pragma unroll
  for (int k = 0; k < kJPT; ++k) {
    const int j = j0 + k;
    Qj[k] = j < Ny ? Q[(long long)b * Ny + j] : 0.0f;
    acc[k] = 0.0f;
  }

  for (int y0 = 0; y0 < Ny; y0 += kYP) {
    for (int r = ty; r < kYP; r += kJG) {
      const int yy = y0 + r;
      const bool in = yy < Ny && x < Nx;
      const long long o = (long long)yy * Nx + x;
      sq[r][tx] = in ? qb[o] : __int_as_float(0x7fc00000);  // NaN: adds 0
      sw[r][tx] = in ? Wz[o] : 0.0f;
    }
    __syncthreads();
    const int rows = min(kYP, Ny - y0);
    for (int r = 0; r < rows; ++r) {
      const float qv = sq[r][tx];
      const float wv = sw[r][tx];
      const int y = y0 + r;
#pragma unroll
      for (int k = 0; k < kJPT; ++k) {
        const float qe = qv - Qj[k];
        const float qz = isnan(qe) ? 0.0f : qe;
        const bool m = y >= j0 + k;
        float mask;
        if (kInc)
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

template <bool kInc, int kPart>
void launch_dense(dim3 grid, dim3 block, cudaStream_t st, const float* q,
                  const float* Wz, const float* Q, float* out, int Ny,
                  int Nx) {
  lwa_dense_kernel<kInc, kPart><<<grid, block, 0, st>>>(q, Wz, Q, out, Ny, Nx);
}

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
                            int part, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = surface_grid(B, Ny, Nx), block(kTX, kJG);
  const float* qp = (const float*)q;
  const float* wp = (const float*)Wz;
  const float* Qp = (const float*)Q;
  float* op = (float*)out;
  switch (part * 2 + (increase ? 1 : 0)) {
    case 0: launch_dense<false, 0>(grid, block, st, qp, wp, Qp, op, Ny, Nx); break;
    case 1: launch_dense<true, 0>(grid, block, st, qp, wp, Qp, op, Ny, Nx); break;
    case 2: launch_dense<false, 1>(grid, block, st, qp, wp, Qp, op, Ny, Nx); break;
    case 3: launch_dense<true, 1>(grid, block, st, qp, wp, Qp, op, Ny, Nx); break;
    case 4: launch_dense<false, 2>(grid, block, st, qp, wp, Qp, op, Ny, Nx); break;
    case 5: launch_dense<true, 2>(grid, block, st, qp, wp, Qp, op, Ny, Nx); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
