// K1: |grad q|^2 by second-order centered differences.
//
// Replaces xcontour_tpu/kernels/stencil_pallas.py, _kernel (launched by
// squared_gradient_pallas).  The TPU kernel holds one snapshot in VMEM and
// builds the four neighbours with lane/sublane rolls.
//
// Bound on the H100: device-memory traffic.  Each cell reads q once (its
// neighbours come from the same rows, through L1/L2), reads 1/dx (shared by
// every batch element, so it stays in L2), and writes the result: about 12
// bytes per cell, against ~1 FLOP/byte of work.
//
// Design: one thread per output (b, y, x), consecutive threads on
// consecutive x so every load and the store coalesce.  Periodic x wraps by
// index; y walls follow bc_y ('reflect' follows the JAX package's XLA form,
// whose walls are NaN where row 1 is; the TPU kernel writes 0 there).
// Spacings arrive as reciprocals, like the TPU kernel.  The final products
// and sum use explicit round-to-nearest intrinsics so nvcc does not contract
// them into an FMA: the kernel then rounds exactly like its plain PyTorch
// version.

#include <cuda_runtime.h>

namespace {

enum BcY { kExtend = 0, kFill = 1, kReflect = 2 };

__global__ void squared_gradient_kernel(const float* __restrict__ q,
                                        const float* __restrict__ rdx,
                                        const float* __restrict__ rdy,
                                        float* __restrict__ out, int B, int Ny,
                                        int Nx, int periodic_x, int bc_y) {
  const long long total = (long long)B * Ny * Nx;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = (int)(idx % Nx);
  const long long r = idx / Nx;
  const int y = (int)(r % Ny);
  const float* row = q + r * Nx;  // row y of snapshot b
  const float c = row[x];

  float qx;
  if (periodic_x) {
    const int xl = x == 0 ? Nx - 1 : x - 1;
    const int xr = x == Nx - 1 ? 0 : x + 1;
    qx = (row[xr] - row[xl]) * 0.5f;
  } else if (x == 0) {
    qx = row[1] - c;
  } else if (x == Nx - 1) {
    qx = c - row[Nx - 2];
  } else {
    qx = (row[x + 1] - row[x - 1]) * 0.5f;
  }

  float qy;
  if ((y == 0 || y == Ny - 1) && bc_y == kReflect) {
    // zero wall-normal derivative, NaN where row 1 is not finite (the JAX
    // package's (q[1] - q[1]) * 0 at both walls)
    const float r1 = row[(long long)(1 - y) * Nx + x];
    qy = (r1 - r1) * 0.0f;
  } else if (y == 0) {
    const float dn = row[Nx + x];
    qy = bc_y == kExtend ? dn - c : dn * 0.5f;
  } else if (y == Ny - 1) {
    const float up = row[x - Nx];
    qy = bc_y == kExtend ? c - up : -up * 0.5f;
  } else {
    qy = (row[x + Nx] - row[x - Nx]) * 0.5f;
  }

  const float gx = __fmul_rn(qx, rdx[(long long)y * Nx + x]);
  const float gy = __fmul_rn(qy, rdy[y]);
  out[idx] = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
}

}  // namespace

extern "C" int xc_squared_gradient(const void* q, const void* rdx,
                                   const void* rdy, void* out, int B, int Ny,
                                   int Nx, int periodic_x, int bc_y,
                                   void* stream) {
  const long long total = (long long)B * Ny * Nx;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  squared_gradient_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)q, (const float*)rdx, (const float*)rdy, (float*)out, B,
      Ny, Nx, periodic_x, bc_y);
  return (int)cudaGetLastError();
}
