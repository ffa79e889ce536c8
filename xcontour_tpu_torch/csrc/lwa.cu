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
// Tracer and profile are centered on c0 (the mean of the finite profile
// values) as they are read.  Non-finite cells (of q or W) are invalid: they
// become +-inf sentinels qk with zero weight Wv.  NaN profile rows give 0.
//
// K4 replaces xcontour_tpu/kernels/lwa_pallas.py, _kernel (launched by
// lwa_pallas(pairwise=True)): the pairwise LWA,
//
//   LWA[j, x] = -sum_y qz * mask3(qe, y >= j) * Wz[y, x],
//   qe = q(y, x) - Q_j (variant 1)  or  q(y_j, x) - Q(y) (variant 2),
//
// with the reference's 3-valued mask, parts all/upper/lower, NaN qe -> 0,
// and a split mode that writes the upper and lower halves in one launch.
// Variant 2 builds the mask with the flipped increase flag and selects
// parts with the original one.  Like the JAX twin (_lwa_dense_xla) it takes
// weights with NaN zeroed (the TPU kernel leaves a NaN weight in), and an
// infinite qe or weight on a pair whose mask is 0 gives NaN (inf * 0) as in
// the twin.
//
// K6 replaces xcontour_tpu/kernels/lwa_pallas.py, _kernel_yblocked, which
// lwa_pallas takes for both variants when Ny > 3072 (float32): it blocks
// the y reduction only to fit a (Ny, 128) panel in the TPU's VMEM.  K4
// stages y in 64-row shared-memory panels at every Ny, so K6 is K4's kernel
// run in that regime; offsets are 64-bit, and the wrapper refuses 2^31
// cells.
//
// K5 replaces xcontour_tpu/kernels/lwa_pallas.py, _kernel_lin2 (launched by
// _lwa_pallas_lin(variant2=True)): the linearized LWA2 for part='all',
//
//   LWA2[j, x] = -(R_j(x) + E[j, x]),
//   R_j(x)     = sum_y ext(q(y_j, x) - Q(y)) * Wv[y, x],
//
// with ext = max(., 0) for increasing tracers (the flipped mask) and
// min(., 0) otherwise.  Invalid profile rows become +-inf sentinels with
// zero weight; a non-finite surface value gives 0.
//
// Bound on the H100: FP32 issue.  Every surface j meets every cell: Ny^2*Nx
// pairs per snapshot on Ny*Nx data (11.23 G pairs for an ERA5 step of
// 15x721x1440, against 62 MB of tracer).  K3, K4 and K5 spend 3
// instructions per pair: sub, min/max, FMA.  Tensor cores do not apply: the
// pair's min/max is not a product, so there is no matrix product to hand to
// wgmma.
//
// Design (all kernels): a block of 32 x 8 threads covers 32 columns; each
// thread keeps kJ consecutive surfaces' operand (Q_j in variant 1,
// q(y_j, x) in variant 2) and running sums in registers, and every staged
// value feeds kJ surfaces per thread.  K3 and K4 keep kJ = 16 (128 surfaces
// a block; 64 registers a thread): against 8 it halves the shared loads per
// FMA, and at 8 they took 9-20% longer on an H100.  K4's split mode keeps
// 16 too: its second accumulators take it to 93 (v1) and 110 (v2)
// registers for sm_90a, with no spill.  K5 keeps 8.  A K4
// warp whose surfaces all lie past Ny stages its rows but sums none (the
// same skip made K3 5% slower at ERA5 on an H100, so K3 has none).  Every
// surface reduction is x-separable (the mask depends only on the row
// index), so blocks need no communication.  Surface tiles are the fastest
// grid dimension: the blocks that share a column strip run together and
// read it from L2.
//
// K3 and K4 stage row panels (K3 32 rows, K4 64) with cp.async into two
// shared buffers: the copy of panel p+1 is in flight while panel p is
// summed, with one barrier a panel.  Each thread copies 4 bytes a row
// (zero-filled outside the grid), then fixes up or checks the elements it
// copied itself (K3: centering, sentinels, Wv; K4: the infinity flag)
// before the barrier.  K3's full panels run a fully unrolled 32-row body,
// the ragged last panel a loop over its rows.
//
// K4's mask costs ~10 instructions a pair in product form (sub, NaN test,
// two compares, a row compare, selects, the product).  But the side
// m = (y >= j) is the same for all of a warp's kJ surfaces [j0, j0 + kJ)
// on every row outside [j0, j0 + kJ - 1), so each warp cuts a panel into
// at most three row spans (warp-uniform bounds): rows on the side y < j,
// the at most kJ - 1 rows that straddle its surfaces, rows on the side
// y >= j.  Every span runs the mask-free form
//   side y >= j: acc += ext_m(qe) * w,   side y < j: acc -= ext_n(qe) * w,
// ext_m = fminf(qe, 0) and ext_n = fmaxf(qe, 0) for the increasing mask
// (swapped for the decreasing one), with the side chosen per surface on
// the straddling rows.  The FMA gets the operands of the product form, so
// finite inputs give the same bits in the same y order (up to the sign of
// a zero), and fminf/fmaxf turn a NaN qe into 0 as qz does.  The straddling
// rows cost one warp of the block a few more instructions a pair than the
// others; the block's warps meet at every panel's barrier, and 64-row
// panels let the straddling rows of several warps share a panel (32-row
// panels measured 1.88 ms against 1.50 at ERA5 on an H100 for 'all').
// Part selections keep one side of the diagonal only (the sign of the mask
// is fixed by m), so a warp skips the rows of the side its part zeroes.
// The forms differ only where the product form meets an infinity: an
// infinite qe, or an infinite weight on a skipped side, gives inf * 0 = NaN
// there and 0 in the mask-free form.  So the block raises a flag
// (__syncthreads_or) for any infinite staged value (q in variant 1, Q in
// variant 2, W) and, once, for any infinite register operand; a flagged
// panel runs the exact product form on every row.

// K3's E comes from a prep kernel with one thread per (b, x, 32-row chunk):
// it writes the chunk-local deviation-scaled recurrence
//   E[j] = E[j-1] + (Qt[j] - qt[j-1]) * Wv[j-1] + (Qt[j] - Qt[j-1]) * P0[j-1]
// (P0[j] = sum_{y<j} Wv, P0 counted from the chunk's previous row) and the
// chunk's totals.  The surface kernel's epilogue adds the carry-in of its
// chunk, e_in + P0_in * (Qt[j] - Qt[s-1]) (the P0_in terms telescope), so
// E stays in the deviation-scaled form and no eps*total loss appears in
// float32 (the naive P1 - Q_j*P0 form has one).

#include <cuda_runtime.h>
#include <math.h>

#include "lwa.cuh"

namespace {

using namespace xc_lwa;

constexpr int kJPT = 8;           // K5's surfaces per thread
constexpr int kTJ = kJG * kJPT;   // K5's surfaces per block
constexpr int kCH = 32;           // rows per chunk of K3's E prep

// K3: the profile centered on c, invalid rows 0 (the t-term's Qt)
__device__ __forceinline__ float centered_or_zero(float v, float c) {
  return isfinite(v) ? v - c : 0.0f;
}

// K3 prep: one thread per (b, x, chunk) walks the chunk's rows in order,
// writing the chunk-local E and, per chunk, its last E and the chunk's
// weight sum (tot[b, chunk, 0 / 1, x]).
__global__ void lwa_lin_prep_kernel(const float* __restrict__ q,
                                    const float* __restrict__ W,
                                    const float* __restrict__ Q,
                                    const float* __restrict__ c0,
                                    float* __restrict__ E,
                                    float* __restrict__ tot, int Ny, int Nx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= Nx) return;
  const int ch = blockIdx.y, b = blockIdx.z, nch = gridDim.y;
  const float c = c0[b];
  const long long base = (long long)b * Ny * Nx;
  const float* Qb = Q + (long long)b * Ny;
  const int s = ch * kCH, e = min(Ny, s + kCH);
  // the previous row's (qt, Wv, Qt); zeros above row 0 give a zero step
  float qt_prev = 0.0f, w_prev = 0.0f, Q_prev = 0.0f;
  if (s > 0) {
    const long long o = (long long)(s - 1) * Nx + x;
    const float qv = q[base + o], wv = W[o];
    const bool valid = isfinite(qv) && isfinite(wv);
    qt_prev = valid ? qv - c : 0.0f;
    w_prev = valid ? wv : 0.0f;
    Q_prev = centered_or_zero(Qb[s - 1], c);
  }
  float eloc = 0.0f, L = 0.0f;  // L: sum of Wv over [s - 1, y - 2]
  for (int y = s; y < e; ++y) {
    const long long o = (long long)y * Nx + x;
    const float qv = q[base + o], wv = W[o];
    const bool valid = isfinite(qv) && isfinite(wv);
    const float Qy = centered_or_zero(Qb[y], c);
    eloc += (Qy - qt_prev) * w_prev + (Qy - Q_prev) * L;
    E[base + o] = eloc;
    L += w_prev;
    qt_prev = valid ? qv - c : 0.0f;
    w_prev = valid ? wv : 0.0f;
    Q_prev = Qy;
  }
  float* t = tot + ((long long)b * nch + ch) * 2 * Nx + x;
  t[0] = eloc;
  t[Nx] = L;
}

// K3 surface kernel: kJ surfaces per thread; panels of q and W staged with
// cp.async, then centered and sanitized in place by the thread that copied
// them.
template <bool kInc>
__global__ void __launch_bounds__(kTX * kJG)
lwa_lin_kernel(const float* __restrict__ q, const float* __restrict__ W,
               const float* __restrict__ Q, const float* __restrict__ c0,
               const float* __restrict__ E, const float* __restrict__ tot,
               float* __restrict__ out, int Ny, int Nx) {
  static_assert(kCH % kJ == 0, "a thread's surfaces lie in one E chunk");
  __shared__ float sq[2][kYP][kTX];
  __shared__ float sw[2][kYP][kTX];
  const float sent = kInc ? INFINITY : -INFINITY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.y * kTX + tx;
  const int j0 = blockIdx.x * (kJG * kJ) + ty * kJ;
  const int b = blockIdx.z;
  const long long plane = (long long)Ny * Nx;
  const float c = c0[b];
  const float* qb = q + b * plane;
  const float* Qb = Q + (long long)b * Ny;

  float Qj[kJ], acc[kJ];
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const int j = j0 + k;
    Qj[k] = j < Ny ? Qb[j] - c : 0.0f;
    acc[k] = 0.0f;
  }

  lin_panels<kInc>(acc, Qj, sq, sw, qb, W, Ny, Nx, x, [&](int buf) {
    for (int r = ty; r < kYP; r += kJG) {
      const float qv = sq[buf][r][tx], wv = sw[buf][r][tx];
      const bool valid = isfinite(qv) && isfinite(wv);
      sq[buf][r][tx] = valid ? qv - c : sent;
      sw[buf][r][tx] = valid ? wv : 0.0f;
    }
  });

  if (x >= Nx || j0 >= Ny) return;
  // E's carry-in for this thread's chunk: e_in = E[s - 1] and P0_in, the
  // weight above the chunk's previous row, from the chunk totals above it
  const int nch = (Ny + kCH - 1) / kCH, ch = j0 / kCH;
  const float* t = tot + (long long)b * nch * 2 * Nx + x;
  float e_in = 0.0f, P_in = 0.0f, Q_s = 0.0f;
  for (int i = 0; i < ch; ++i) {
    const float Q_e = centered_or_zero(Qb[(i + 1) * kCH - 1], c);
    e_in += t[2 * i * Nx] + P_in * (Q_e - Q_s);
    P_in += t[(2 * i + 1) * Nx];
    Q_s = Q_e;
  }
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const int j = j0 + k;
    if (j < Ny) {
      const long long o = b * plane + (long long)j * Nx + x;
      const float Ej =
          e_in + E[o] + P_in * (centered_or_zero(Qb[j], c) - Q_s);
      out[o] = isnan(Qj[k]) ? 0.0f : -(acc[k] + Ej);
    }
  }
}

// K4 modes of a warp's row span: every row on the side y >= j of the
// warp's surfaces, every row on the side y < j, rows that straddle them
// (the side chosen per surface), or the exact product form (flagged panels)
enum { kGE = 0, kLT = 1, kMixed = 2, kExact = 3 };

// one staged row (value v, weight w, row y) against a thread's kJ surfaces
template <int kMode, bool kMaskInc, bool kKeepGE, bool kKeepLT, bool kV2>
__device__ __forceinline__ void dense_row(float (&acc)[kJ],
                                          const float (&s)[kJ], float v,
                                          float w, int y, int j0) {
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const float qe = kV2 ? s[k] - v : v - s[k];
    // the mask-free terms of the two sides (0 on a side the part zeroes)
    const float ge = kKeepGE ? (kMaskInc ? fminf(qe, 0.0f) : fmaxf(qe, 0.0f))
                             : 0.0f;
    const float lt = kKeepLT ? (kMaskInc ? -fmaxf(qe, 0.0f)
                                         : -fminf(qe, 0.0f))
                             : 0.0f;
    if (kMode == kGE) {
      acc[k] = fmaf(ge, w, acc[k]);
    } else if (kMode == kLT) {
      acc[k] = fmaf(lt, w, acc[k]);
    } else if (kMode == kMixed) {
      acc[k] = fmaf(y >= j0 + k ? ge : lt, w, acc[k]);
    } else {
      const float qz = isnan(qe) ? 0.0f : qe;
      const bool m = y >= j0 + k;
      float mask;
      if (kMaskInc)
        mask = m ? (qe < 0.0f ? 1.0f : 0.0f) : (qe > 0.0f ? -1.0f : 0.0f);
      else
        mask = m ? (qe > 0.0f ? 1.0f : 0.0f) : (qe < 0.0f ? -1.0f : 0.0f);
      // a part keeps one side: mask > 0 only where m, mask < 0 only where !m
      mask = (m ? kKeepGE : kKeepLT) ? mask : 0.0f;
      acc[k] = fmaf(qz * mask, w, acc[k]);
    }
  }
}

// rows [r0, r1) of one staged panel, in order
template <int kMode, bool kMaskInc, bool kKeepGE, bool kKeepLT, bool kV2>
__device__ __forceinline__ void dense_rows(float (&acc)[kJ],
                                           const float (&s)[kJ],
                                           const float* vp, const float* wp,
                                           int y0, int r0, int r1, int j0) {
  constexpr int vs = kV2 ? 1 : kTX;  // v2 stages the profile, v1 q panels
  if constexpr (kMode == kGE || kMode == kLT) {
#pragma unroll 8
    for (int r = r0; r < r1; ++r)
      dense_row<kMode, kMaskInc, kKeepGE, kKeepLT, kV2>(
          acc, s, vp[r * vs], wp[r * kTX], y0 + r, j0);
  } else {
#pragma unroll 1
    for (int r = r0; r < r1; ++r)
      dense_row<kMode, kMaskInc, kKeepGE, kKeepLT, kV2>(
          acc, s, vp[r * vs], wp[r * kTX], y0 + r, j0);
  }
}

// K4's rows per staged panel: at 64 the straddling rows of different warps
// share a panel more often, so fewer warps wait at the panel's barrier
constexpr int kDP = 64;

// kPart: 0 all, 1 upper, 2 lower, 3 split (both halves in one pass:
// upper to out, lower to out2).  kV2: variant 2 (impulse-Casimir), whose
// per-thread operands are the surface values q(y_j, x) and whose staged
// panel is the profile Q(y); v1 holds Q_j and stages q(y, x).
//
// Split mode keeps a second accumulator a surface: acc sums the side
// y >= j and acc2 the side y < j, each with the calls (and so the FMAs,
// in the same y order) of the single-part kernel that keeps that side, so
// each half equals that kernel's output bit for bit.  A pair lies on one
// side, so the spans cost what part='all' costs; only the straddling rows
// and flagged panels run twice, once an accumulator.
template <bool kInc, int kPart, bool kV2>
__device__ __forceinline__ void dense_body(const float* __restrict__ q,
                                           const float* __restrict__ Wz,
                                           const float* __restrict__ Q,
                                           float* __restrict__ out,
                                           float* __restrict__ out2, int Ny,
                                           int Nx) {
  static_assert(kDP % kTX == 0, "warp 0 stages a profile panel");
  constexpr bool kSplit = kPart == 3;
  // variant 2 builds its mask with the flipped flag, and selects parts with
  // the original one (lwa_pallas.py:52-70)
  constexpr bool kMaskInc = kV2 ? !kInc : kInc;
  // the sides a part keeps: upper keeps mask > 0 (side y >= j) for an
  // increasing tracer, mask < 0 (side y < j) otherwise; lower the reverse
  constexpr bool kKeepGE = kSplit || kPart == 0 || (kPart == 1) == kInc;
  constexpr bool kKeepLT = kSplit || kPart == 0 || (kPart == 1) != kInc;
  // the sides acc sums (split: y >= j alone; acc2 sums y < j)
  constexpr bool kAccLT = kKeepLT && !kSplit;
  __shared__ float sq[kV2 ? 1 : 2][kV2 ? 1 : kDP][kTX];
  __shared__ float sQ[2][kDP];
  __shared__ float sw[2][kDP][kTX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.y * kTX + tx;
  const int j0 = blockIdx.x * (kJG * kJ) + ty * kJ;
  const int b = blockIdx.z;
  const long long plane = (long long)Ny * Nx;
  const float* qb = q + b * plane;
  const float* Qb = Q + (long long)b * Ny;

  float s[kJ], acc[kJ], acc2[kSplit ? kJ : 1];
  bool reg_inf = false;
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const int j = j0 + k;
    if (kV2)
      s[k] = j < Ny && x < Nx ? qb[(long long)j * Nx + x] : 0.0f;
    else
      s[k] = j < Ny ? Qb[j] : 0.0f;
    reg_inf |= isinf(s[k]);
    acc[k] = 0.0f;
    if constexpr (kSplit) acc2[k] = 0.0f;
  }
  // an infinite register operand makes every panel of the block exact
  const bool block_inf = __syncthreads_or(reg_inf);

  auto stage = [&](int p, int buf) {
    const int y0 = p * kDP;
    for (int r = ty; r < kDP; r += kJG) {
      const int yy = y0 + r;
      const bool in = yy < Ny && x < Nx;
      const long long o = in ? (long long)yy * Nx + x : 0;
      if constexpr (!kV2) cp_async4(&sq[buf][r][tx], qb + o, in);
      cp_async4(&sw[buf][r][tx], Wz + o, in);
    }
    if (kV2 && ty == 0) {
      for (int r = tx; r < kDP; r += kTX) {
        const bool in = y0 + r < Ny;
        cp_async4(&sQ[buf][r], Qb + (in ? y0 + r : 0), in);
      }
    }
    cp_async_commit();
  };

  const int np = (Ny + kDP - 1) / kDP;
  stage(0, 0);
  for (int p = 0, buf = 0; p < np; ++p, buf ^= 1) {
    cp_async_wait_all();
    // each thread checks the values it copied itself: an infinite q (v1),
    // Q (v2) or weight makes the panel exact
    bool mine = false;
    for (int r = ty; r < kDP; r += kJG) {
      mine |= isinf(sw[buf][r][tx]);
      if constexpr (!kV2) mine |= isinf(sq[buf][r][tx]);
    }
    if (kV2 && ty == 0)
      for (int r = tx; r < kDP; r += kTX) mine |= isinf(sQ[buf][r]);
    const bool exact = __syncthreads_or(mine) || block_inf;
    if (p + 1 < np) stage(p + 1, buf ^ 1);
    if (j0 >= Ny) continue;  // warp-uniform: no surface of this warp
    const int y0 = p * kDP;
    const int rows = min(kDP, Ny - y0);
    const float* vp;
    if constexpr (kV2) vp = &sQ[buf][0];
    else vp = &sq[buf][0][tx];
    const float* wp = &sw[buf][0][tx];
    if (exact) {
      dense_rows<kExact, kMaskInc, kKeepGE, kAccLT, kV2>(
          acc, s, vp, wp, y0, 0, rows, j0);
      if constexpr (kSplit)
        dense_rows<kExact, kMaskInc, false, true, kV2>(
            acc2, s, vp, wp, y0, 0, rows, j0);
      continue;
    }
    // warp-uniform: the warp's surfaces are [j0, j0 + kJ), so rows
    // [0, r_lt) lie on the side y < j of all of them, rows [r_ge, rows) on
    // the side y >= j, and only rows [r_lt, r_ge) (at most kJ - 1) straddle
    const int r_lt = min(max(j0 - y0, 0), rows);
    const int r_ge = min(max(j0 + kJ - 1 - y0, r_lt), rows);
    if constexpr (kSplit) {
      dense_rows<kLT, kMaskInc, false, true, kV2>(
          acc2, s, vp, wp, y0, 0, r_lt, j0);
      dense_rows<kMixed, kMaskInc, true, false, kV2>(
          acc, s, vp, wp, y0, r_lt, r_ge, j0);
      dense_rows<kMixed, kMaskInc, false, true, kV2>(
          acc2, s, vp, wp, y0, r_lt, r_ge, j0);
    } else {
      if (kKeepLT)
        dense_rows<kLT, kMaskInc, kKeepGE, kKeepLT, kV2>(
            acc, s, vp, wp, y0, 0, r_lt, j0);
      dense_rows<kMixed, kMaskInc, kKeepGE, kKeepLT, kV2>(
          acc, s, vp, wp, y0, r_lt, r_ge, j0);
    }
    if (kKeepGE)
      dense_rows<kGE, kMaskInc, kKeepGE, kAccLT, kV2>(
          acc, s, vp, wp, y0, r_ge, rows, j0);
  }

  if (x >= Nx) return;
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const int j = j0 + k;
    if (j >= Ny) continue;
    const long long o = b * plane + (long long)j * Nx + x;
    if constexpr (kSplit) {
      // upper is the side y >= j for an increasing tracer, y < j else
      out[o] = -(kInc ? acc[k] : acc2[k]);
      out2[o] = -(kInc ? acc2[k] : acc[k]);
    } else {
      out[o] = -acc[k];
    }
  }
}

// K4 for one part
template <bool kInc, int kPart, bool kV2>
__global__ void __launch_bounds__(kTX * kJG)
lwa_dense_kernel(const float* __restrict__ q, const float* __restrict__ Wz,
                 const float* __restrict__ Q, float* __restrict__ out, int Ny,
                 int Nx) {
  dense_body<kInc, kPart, kV2>(q, Wz, Q, out, nullptr, Ny, Nx);
}

// K4 in split mode: upper to out, lower to out2, in one launch
template <bool kInc, bool kV2>
__global__ void __launch_bounds__(kTX * kJG)
lwa_dense_kernel(const float* __restrict__ q, const float* __restrict__ Wz,
                 const float* __restrict__ Q, float* __restrict__ out,
                 float* __restrict__ out2, int Ny, int Nx) {
  dense_body<kInc, 3, kV2>(q, Wz, Q, out, out2, Ny, Nx);
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

using LinKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, const float*, float*,
                           int, int);

// indexed by increase
constexpr LinKernel kLinKernels[2] = {lwa_lin_kernel<false>,
                                      lwa_lin_kernel<true>};

using DenseKernel = void (*)(const float*, const float*, const float*, float*,
                             int, int);

#define XC_DENSE_PARTS(V2)                                           \
  lwa_dense_kernel<false, 0, V2>, lwa_dense_kernel<true, 0, V2>,     \
      lwa_dense_kernel<false, 1, V2>, lwa_dense_kernel<true, 1, V2>, \
      lwa_dense_kernel<false, 2, V2>, lwa_dense_kernel<true, 2, V2>

// indexed by (variant2 * 3 + part) * 2 + increase
constexpr DenseKernel kDenseKernels[12] = {XC_DENSE_PARTS(false),
                                           XC_DENSE_PARTS(true)};

#undef XC_DENSE_PARTS

using SplitKernel = void (*)(const float*, const float*, const float*, float*,
                             float*, int, int);

// indexed by variant2 * 2 + increase
constexpr SplitKernel kSplitKernels[4] = {
    lwa_dense_kernel<false, false>, lwa_dense_kernel<true, false>,
    lwa_dense_kernel<false, true>, lwa_dense_kernel<true, true>};

dim3 surface_grid(int B, int Ny, int Nx, int per_block) {
  return dim3((Ny + per_block - 1) / per_block, (Nx + kTX - 1) / kTX, B);
}

// CUDA caps grid y and z at 65,535: the entry points launch a batch in
// chunks of at most that many elements, the batch index in z (or y)
// counted from the chunk's first element through offset pointers
constexpr int kBatchChunk = 65535;

}  // namespace

extern "C" int xc_lwa_lin(const void* q, const void* W, const void* Q,
                          const void* c0, void* E, void* tot, void* out,
                          int B, int Ny, int Nx, int increase, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int pt = 128;
  const int nch = (Ny + kCH - 1) / kCH;
  const long long plane = (long long)Ny * Nx;
  const LinKernel kernel = kLinKernels[increase ? 1 : 0];
  for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
    const int bc = B - b0 < kBatchChunk ? B - b0 : kBatchChunk;
    const float* qb = (const float*)q + b0 * plane;
    const float* Qb = (const float*)Q + (long long)b0 * Ny;
    const float* cb = (const float*)c0 + b0;
    float* Eb = (float*)E + b0 * plane;
    float* tb = (float*)tot + (long long)b0 * nch * 2 * Nx;
    float* ob = (float*)out + b0 * plane;
    lwa_lin_prep_kernel<<<dim3((Nx + pt - 1) / pt, nch, bc), pt, 0, st>>>(
        qb, (const float*)W, Qb, cb, Eb, tb, Ny, Nx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kernel<<<surface_grid(bc, Ny, Nx, kJG * kJ), dim3(kTX, kJG), 0, st>>>(
        qb, (const float*)W, Qb, cb, Eb, tb, ob, Ny, Nx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// part 0 all, 1 upper, 2 lower into out; 3 split: upper into out, lower
// into out2 (unused by the other parts)
extern "C" int xc_lwa_dense(const void* q, const void* Wz, const void* Q,
                            void* out, void* out2, int B, int Ny, int Nx,
                            int increase, int part, int variant2,
                            void* stream) {
  if (part < 0 || part > 3) return (int)cudaErrorInvalidValue;
  const int v2 = variant2 ? 1 : 0, inc = increase ? 1 : 0;
  const long long plane = (long long)Ny * Nx;
  for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
    const int bc = B - b0 < kBatchChunk ? B - b0 : kBatchChunk;
    const dim3 grid = surface_grid(bc, Ny, Nx, kJG * kJ), block(kTX, kJG);
    const float* qb = (const float*)q + b0 * plane;
    const float* Qb = (const float*)Q + (long long)b0 * Ny;
    float* ob = (float*)out + b0 * plane;
    if (part == 3)
      kSplitKernels[v2 * 2 + inc]<<<grid, block, 0, (cudaStream_t)stream>>>(
          qb, (const float*)Wz, Qb, ob, (float*)out2 + b0 * plane, Ny, Nx);
    else
      kDenseKernels[(v2 * 3 + part) * 2 + inc]<<<grid, block, 0,
                                                 (cudaStream_t)stream>>>(
          qb, (const float*)Wz, Qb, ob, Ny, Nx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

extern "C" int xc_lwa_lin2(const void* q, const void* Q, const void* W,
                           const void* c0, void* E, void* out, int B, int Ny,
                           int Nx, int increase, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int pt = 128;
  const long long plane = (long long)Ny * Nx;
  const dim3 block(kTX, kJG);
  for (int b0 = 0; b0 < B; b0 += kBatchChunk) {
    const int bc = B - b0 < kBatchChunk ? B - b0 : kBatchChunk;
    const float* qb = (const float*)q + b0 * plane;
    const float* Qb = (const float*)Q + (long long)b0 * Ny;
    const float* cb = (const float*)c0 + b0;
    float* Eb = (float*)E + b0 * plane;
    float* ob = (float*)out + b0 * plane;
    lwa_lin2_prep_kernel<<<dim3((Nx + pt - 1) / pt, bc), pt, 0, st>>>(
        qb, Qb, (const float*)W, cb, Eb, Ny, Nx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid = surface_grid(bc, Ny, Nx, kJG * kJPT);
    if (increase)
      lwa_lin2_kernel<true><<<grid, block, 0, st>>>(qb, Qb, (const float*)W,
                                                     cb, Eb, ob, Ny, Nx);
    else
      lwa_lin2_kernel<false><<<grid, block, 0, st>>>(qb, Qb, (const float*)W,
                                                      cb, Eb, ob, Ny, Nx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
