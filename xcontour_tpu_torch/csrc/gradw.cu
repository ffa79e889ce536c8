// G: the five CDF weights of the contour-length chain, from q in one pass.
//
// Replaces no TPU kernel: xcontour_tpu/pipeline.py:251-273 forms the
// weights in plain jnp (the gradient, |grad q|^2, |grad q| and the
// products core.cal_contour_mean_hist takes, (f * grdm) * dA), and the
// port ran that chain as some twenty full-field torch launches, two rolls
// and a stack.  This kernel writes K2's (B, 5, Ny, Nx) input directly:
//
//   dA, grdS * dA, (grdm * grdm) * dA, grdm * dA, ((1 / grdm) * grdm) * dA
//
// with grdS = qx^2 + qy^2 and grdm = sqrt(grdS), qx and qy the centered
// differences divided by dx and dy (ops/stencil.gradient's form: divided,
// not multiplied by reciprocals as K1 is).  NaN in the last channel where
// grdm is 0, as the chain gives.
//
// Bound on the H100: device-memory traffic.  Each cell reads q once and
// writes five channels: 24 bytes a cell.  dx and dA are one plane shared
// by the batch, dy a row, all served from L2.
//
// Design: K1's march (stencil.cuh).  Blocks of 4 warps over (b, 32 V
// columns, 4 strips of 16 rows), the batch index fastest so the B blocks
// that read one tile of dx and dA run together; each lane marches down its
// strip for V = 4 adjacent columns (float4 loads and stores; 1 where the
// row length or alignment forbids), the rows above, at and below in
// registers, x neighbours by shuffle (lane 0, lane 31 and the lane of the
// last column load theirs, with the periodic wrap).  The walls and the
// NaN pattern of 'reflect' are K1's.  Every product, sum, quotient and
// root is rounded by its own round-to-nearest intrinsic, so nvcc contracts
// nothing into an FMA and the kernel rounds exactly as the plain PyTorch
// chain does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stencil.cuh"

namespace {

using namespace xc_stencil;

enum BcY { kExtend = 0, kFill = 1, kReflect = 2 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChannels = 5;

// V columns a lane
template <int V>
__global__ void __launch_bounds__(32 * kWarpsY)
clength_weights_kernel(const float* __restrict__ q,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dA, float* __restrict__ out,
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
  float* ob = out + b * kChannels * plane;

  float up[V], c[V];
  if (y0 > 0) {
    load_vec<V>(qb + (y0 - 1) * Nx + xc, up);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) up[v] = 0.0f;
  }
  load_vec<V>(qb + y0 * Nx + xc, c);
  for (int ys = y0; ys < y1; ys += kAhead) {
    float dn[kAhead][V], sx[kAhead][V], da[kAhead][V], lv[kAhead],
        rv[kAhead];
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
        load_vec<V>(dx + y * Nx + xc, sx[r]);
        load_vec<V>(dA + y * Nx + xc, da[r]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) sx[r][v] = da[r][v] = 0.0f;
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
      const float sy = dy[y];
      float w[kChannels][V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int x = xc + v;
        const float left = v > 0 ? c[v - 1] : load_l ? lv[r] : sl;
        const float right = v < V - 1 ? c[v + 1] : load_r ? rv[r] : sr;
        float qx;
        if (periodic_x) {
          qx = __fmul_rn(__fsub_rn(right, left), 0.5f);
        } else if (x == 0) {
          qx = __fsub_rn(right, c[v]);
        } else if (x == Nx - 1) {
          qx = __fsub_rn(c[v], left);
        } else {
          qx = __fmul_rn(__fsub_rn(right, left), 0.5f);
        }

        float qy;
        if ((y == 0 || y == Ny - 1) && bc_y == kReflect) {
          // zero wall-normal derivative, NaN where row 1 is not finite
          const float r1 = qb[Nx + x];
          qy = __fmul_rn(__fsub_rn(r1, r1), 0.0f);
        } else if (y == 0) {
          qy = bc_y == kExtend ? __fsub_rn(dn[r][v], c[v])
                               : __fmul_rn(dn[r][v], 0.5f);
        } else if (y == Ny - 1) {
          qy = bc_y == kExtend ? __fsub_rn(c[v], up[v])
                               : __fmul_rn(-up[v], 0.5f);
        } else {
          qy = __fmul_rn(__fsub_rn(dn[r][v], up[v]), 0.5f);
        }

        const float gx = __fdiv_rn(qx, sx[r][v]);
        const float gy = __fdiv_rn(qy, sy);
        const float s = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
        const float m = __fsqrt_rn(s);
        const float a = da[r][v];
        w[0][v] = a;
        w[1][v] = __fmul_rn(s, a);
        w[2][v] = __fmul_rn(__fmul_rn(m, m), a);
        w[3][v] = __fmul_rn(m, a);
        w[4][v] = __fmul_rn(__fmul_rn(__fdiv_rn(1.0f, m), m), a);
      }
      if (x0 < Nx) {
#pragma unroll
        for (int k = 0; k < kChannels; ++k)
          store_vec<V>(ob + k * plane + y * Nx + xc, w[k]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        up[v] = c[v];
        c[v] = dn[r][v];
      }
    }
  }
}

template <int V>
void launch(const float* q, const float* dx, const float* dy,
            const float* dA, float* out, int B, int Ny, int Nx,
            int periodic_x, int bc_y, cudaStream_t st) {
  const dim3 grid(B, (Nx + 32 * V - 1) / (32 * V),
                  (Ny + kStrip * kWarpsY - 1) / (kStrip * kWarpsY));
  clength_weights_kernel<V><<<grid, dim3(32, kWarpsY), 0, st>>>(
      q, dx, dy, dA, out, Ny, Nx, periodic_x, bc_y);
}

}  // namespace

// 4 columns a lane where the row length and the pointers' alignment allow
// float4 accesses, else 1
extern "C" int xc_clength_weights(const void* q, const void* dx,
                                  const void* dy, const void* dA, void* out,
                                  int B, int Ny, int Nx, int periodic_x,
                                  int bc_y, void* stream) {
  const uintptr_t addr =
      (uintptr_t)q | (uintptr_t)dx | (uintptr_t)dA | (uintptr_t)out;
  const float* qf = (const float*)q;
  const float* sx = (const float*)dx;
  const float* sy = (const float*)dy;
  const float* da = (const float*)dA;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (Nx % 4 == 0 && addr % 16 == 0)
    launch<4>(qf, sx, sy, da, o, B, Ny, Nx, periodic_x, bc_y, st);
  else
    launch<1>(qf, sx, sy, da, o, B, Ny, Nx, periodic_x, bc_y, st);
  return (int)cudaGetLastError();
}
