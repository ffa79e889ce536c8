// K1: |grad q|^2 by second-order centered differences.
//
// Replaces xcontour_tpu/kernels/stencil_pallas.py, _kernel (launched by
// squared_gradient_pallas).  The TPU kernel holds one snapshot in VMEM and
// builds the four neighbours with lane/sublane rolls.
//
// Bound on the H100: device-memory traffic.  Each cell reads q once, reads
// 1/dx (shared by every batch element), and writes the result: about 12
// bytes per cell, against ~1 FLOP/byte of work.
//
// Design: blocks of 4 warps over (b, 32 V columns, 4 strips of 16 rows),
// the batch index fastest so the B blocks that read one tile of 1/dx run
// together and find it in L2.  Each lane marches down its strip for V = 4
// adjacent columns (float4 loads and stores; 1 where the row length or
// alignment forbids), carrying the rows above, at and below in
// registers, so q is loaded once per cell (plus one halo row at each end
// of a strip); rows are loaded 2 ahead.  The x neighbours of a lane's
// first and last columns come from the neighbouring lanes by shuffle; lane
// 0 and lane 31 (and the lane of the last column) load theirs, with the
// periodic wrap.  Indices are 32-bit (the wrapper takes fewer than 2^31
// cells).  y walls follow bc_y ('reflect' follows the JAX package's XLA
// form, whose walls are NaN where row 1 is; the TPU kernel writes 0
// there).  Spacings arrive as reciprocals, like the TPU kernel.  The final
// products and sum use explicit round-to-nearest intrinsics so nvcc does
// not contract them into an FMA: the kernel then rounds exactly like its
// plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil.cuh"

namespace {

using namespace xc_stencil;

enum BcY { kExtend = 0, kFill = 1, kReflect = 2 };

constexpr unsigned kFull = 0xffffffffu;

// V columns a lane
template <int V>
__global__ void __launch_bounds__(32 * kWarpsY)
squared_gradient_kernel(const float* __restrict__ q,
                        const float* __restrict__ rdx,
                        const float* __restrict__ rdy, float* __restrict__ out,
                        int Ny, int Nx, int periodic_x, int bc_y) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int x0 = (blockIdx.y * 32 + lane) * V;
  const int y0 = (blockIdx.z * kWarpsY + threadIdx.y) * kStrip;
  if (y0 >= Ny) return;                       // the whole warp
  const int y1 = min(Ny, y0 + kStrip);
  const int xc = min(x0, Nx - V);             // lanes past Nx shadow the last
  int xl, xr;                                 // left of xc, right of xc+V-1
  if (periodic_x) {
    xl = xc == 0 ? Nx - 1 : xc - 1;
    xr = xc + V == Nx ? 0 : xc + V;
  } else {
    xl = max(xc - 1, 0);
    xr = min(xc + V, Nx - 1);
  }
  const bool load_l = lane == 0;
  const bool load_r = lane == 31 || x0 + V >= Nx;
  const size_t plane = (size_t)Ny * Nx;
  const float* qb = q + b * plane;
  float* ob = out + b * plane;

  float up[V], c[V];
  if (y0 > 0) {
    load_vec<V>(qb + (y0 - 1) * Nx + xc, up);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) up[v] = 0.0f;
  }
  load_vec<V>(qb + y0 * Nx + xc, c);
  for (int ys = y0; ys < y1; ys += kAhead) {
    float dn[kAhead][V], rx[kAhead][V], lv[kAhead], rv[kAhead];
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int y = ys + r;
      const bool in = y < y1;
      if (in && y + 1 < Ny) {
        load_vec<V>(qb + (y + 1) * Nx + xc, dn[r]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) dn[r][v] = 0.0f;
      }
      if (in) {
        load_vec<V>(rdx + y * Nx + xc, rx[r]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) rx[r][v] = 0.0f;
      }
      lv[r] = in && load_l ? qb[y * Nx + xl] : 0.0f;
      rv[r] = in && load_r ? qb[y * Nx + xr] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int y = ys + r;
      if (y >= y1) break;                     // the whole warp
      const float sl = __shfl_up_sync(kFull, c[V - 1], 1);
      const float sr = __shfl_down_sync(kFull, c[0], 1);
      const float ry = rdy[y];
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int x = xc + v;
        const float left = v > 0 ? c[v - 1] : load_l ? lv[r] : sl;
        const float right = v < V - 1 ? c[v + 1] : load_r ? rv[r] : sr;
        float qx;
        if (periodic_x) {
          qx = (right - left) * 0.5f;
        } else if (x == 0) {
          qx = right - c[v];
        } else if (x == Nx - 1) {
          qx = c[v] - left;
        } else {
          qx = (right - left) * 0.5f;
        }

        float qy;
        if ((y == 0 || y == Ny - 1) && bc_y == kReflect) {
          // zero wall-normal derivative, NaN where row 1 is not finite
          // (the JAX package's (q[1] - q[1]) * 0 at both walls)
          const float r1 = qb[Nx + x];
          qy = (r1 - r1) * 0.0f;
        } else if (y == 0) {
          qy = bc_y == kExtend ? dn[r][v] - c[v] : dn[r][v] * 0.5f;
        } else if (y == Ny - 1) {
          qy = bc_y == kExtend ? c[v] - up[v] : -up[v] * 0.5f;
        } else {
          qy = (dn[r][v] - up[v]) * 0.5f;
        }

        const float gx = __fmul_rn(qx, rx[r][v]);
        const float gy = __fmul_rn(qy, ry);
        o[v] = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
      }
      if (x0 < Nx) store_vec<V>(ob + y * Nx + xc, o);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        up[v] = c[v];
        c[v] = dn[r][v];
      }
    }
  }
}

template <int V>
void launch(const float* q, const float* rdx, const float* rdy, float* out,
            int B, int Ny, int Nx, int periodic_x, int bc_y, cudaStream_t st) {
  const dim3 grid(B, (Nx + 32 * V - 1) / (32 * V),
                  (Ny + kStrip * kWarpsY - 1) / (kStrip * kWarpsY));
  squared_gradient_kernel<V><<<grid, dim3(32, kWarpsY), 0, st>>>(
      q, rdx, rdy, out, Ny, Nx, periodic_x, bc_y);
}

}  // namespace

// 4 columns a lane where the row length and the pointers' alignment allow
// float4 accesses, else 1
extern "C" int xc_squared_gradient(const void* q, const void* rdx,
                                   const void* rdy, void* out, int B, int Ny,
                                   int Nx, int periodic_x, int bc_y,
                                   void* stream) {
  const uintptr_t addr = (uintptr_t)q | (uintptr_t)rdx | (uintptr_t)out;
  const float* qf = (const float*)q;
  const float* rx = (const float*)rdx;
  const float* ry = (const float*)rdy;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (Nx % 4 == 0 && addr % 16 == 0)
    launch<4>(qf, rx, ry, o, B, Ny, Nx, periodic_x, bc_y, st);
  else
    launch<1>(qf, rx, ry, o, B, Ny, Nx, periodic_x, bc_y, st);
  return (int)cudaGetLastError();
}
