// K1's column layout and row loads, shared with its copy probe P4
// (probes.cu): blocks of 4 warps over (b, 32 V columns, 4 strips of 16
// rows), V = 4 columns a lane where float4 accesses are allowed, else 1.
#pragma once

#include <cuda_runtime.h>

namespace xc_stencil {

constexpr int kWarpsY = 4;    // strips a block
constexpr int kStrip = 16;    // rows a lane marches
constexpr int kAhead = 2;     // rows loaded before they are used

// V consecutive floats (16-byte aligned for V = 4)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
  } else {
    a[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *p = a[0];
  }
}

}  // namespace xc_stencil
