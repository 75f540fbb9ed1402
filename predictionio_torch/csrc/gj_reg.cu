// Batched Gauss-Jordan solve of small systems, K <= 64, with the working
// copy in registers, for Hopper (sm_90a).
//
// Replaces three TPU kernels of predictionio_tpu/ops/pallas_solve.py at
// K <= 64, the ranks the main paths use (train at 64, quickstart at 10,
// the eval grid at 8 and 16):
//   - _build_solver_aug :249 (entry point gj_aug_reg);
//   - _build_solver_packed :101 (entry point gj_packed_reg);
//   - _build_solver_blocked2 :177, pallas_call at :237 (entry point
//     gj_blocked2_reg, even K).
// Above K = 64 gj_cta.cu runs all three up to K = 256; ops/spd_solve.py
// routes.
//
// One kernel serves all three (kLayout). The packed layout is column
// Gauss-Jordan on M = [[A], [b^T]]; that is the row Gauss-Jordan below
// applied to [A^T | b], transposed: step j reads the same pivot M[j][j],
// scales the same K + 1 values by it and subtracts the same products from
// the same elements. So gj_packed_reg is this kernel with A loaded
// transposed: lane i takes column i of A as its row. For an A that is not
// bitwise symmetric it solves A^T x = b, as the TPU kernel does. The
// blocked2 layout loads [A | b] as aug does and eliminates two pivots a
// step (below), so it solves A x = b for any A, as the TPU kernel does.
//
// Why a second kernel: gj_solve.cu keeps the [K][K+1] working copy in
// shared memory, and in each of the K steps every element is read, the
// pivot column and row entries are read, and the element is written back:
// 4 shared-memory accesses of 4 B, 64 * 4160 * 16 B = 4.3 MB per system
// at K = 64, 59 GB for the 13 850 systems of a rank-64 half-epoch. Shared
// memory moves 128 B/clk on each of the 132 SMs, ~30-33 TB/s, so that
// loop alone cannot take less than ~1.8 ms; it measured 3.17 ms (and
// gj_layouts.cu's gj_blocked2, the same copy two pivots a step with two
// barriers each, 2.82 ms). What the card itself bounds this solve by is
// bytes: the K^3/3 + 2K^2 FP32 operations of the least work for an SPD
// system (a Cholesky factorisation and two substitutions) on
// (K^2 + 2K)*4 bytes is ~6 operations per byte at K = 64, under the
// H100's ridge of 20 (67 TFLOP/s over 3.35 TB/s), a 0.07 ms bound.
//
// Design: one warp owns one system (K <= 16: one half-warp, two systems
// a warp). Lane i holds row i of [A | b] in registers, and for
// 32 < K <= 64 also row i + 32: KP + 1 floats a row, KP in {16, 32, 64} a
// template parameter, K <= KP at run time. Rows and columns K..KP-1 are
// zero and steps p >= K are skipped by a branch uniform across the warp,
// so the padding changes no result. Step p: the pivot lane (p mod 32)
// guards its pivot d (|d| < 1e-30 -> 1, so an all-zero padding system
// solves to exactly 0), takes one IEEE reciprocal 1/d and multiplies its
// row right of the pivot by it (each element within an ulp of row / d);
// each element of that normalised row is broadcast with __shfl_sync, and
// every other row subtracts c_i * row with one fused multiply-add, c_i its
// own pivot-column entry read before the step. The pivot lane takes
// c = 0, which leaves its row as it is. Only the columns right of the
// pivot are touched: columns <= p are never read again, so the updates
// skipped there change nothing that a later step or x reads.
//
// blocked2 (kPair): pair step s takes pivots p0 = 2s and p1 = p0 + 1,
// whose rows lie in lanes p0 mod 32 and p0 mod 32 + 1 of one slot. Four
// shuffles bring the pivot block P = [[p00, p01], [p10, p11]]; every lane
// guards det = p00 p11 - p01 p10 (|det| < 1e-30 -> 1) and takes
// rdet = 1/det, and every other row forms its multipliers
// [m0 m1] = [c0 c1] P^-1 from its own columns p0 and p1. For each column
// right of p1 two shuffles bring both pivot rows' values, and each row
// takes two FMAs. The pivot rows stay as they are; each of their lanes
// keeps its row of P^-1, and at the end x_p0 and x_p1 are that row times
// (b_p0, b_p1), the partner's b one __shfl_xor_sync(.., 1) away. A pair
// step shuffles twice a column where a single step shuffles once, so a
// system takes about the same shuffles and FMAs as aug's, in half the
// dependent pivot chains. K is even, so a pair never straddles K.
//
// Every register array is indexed by unrolled loop counters only, so the
// copy stays in registers (ptxas: 0-byte stack frame, 0 spills). No shared
// memory and no barrier in the elimination.
//
// A is read from device memory once, coalesced. The aug (and blocked2)
// load stages each warp's system, L rows at a time, through a per-warp
// shared tile of stride KP + 1 (odd, so lane i reading row i finds 32
// different banks), with 16-byte loads where A is contiguous and aligned
// (K == KP) and strided scalar loads otherwise (Schur sub-blocks, K < KP).
// The packed load needs no tile: lane i reads A[j][i] for each row j, so
// where A's rows are contiguous the lanes of a system read row j in one
// coalesced access. Only x is written.
//
// Built without --use_fast_math: the reciprocals are __frcp_rn (IEEE,
// round to nearest), which keeps the 1e-4 bars and the exact zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPivotEps = 1e-30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 4;  // warps per block
// the layouts the kernel serves (kLayout)
constexpr int kAug = 0;     // row Gauss-Jordan on [A | b]
constexpr int kPacked = 1;  // the same on [A^T | b]
constexpr int kPair = 2;    // blocked2: [A | b], two pivots a step

template <int KP, int kLayout>
__global__ void __launch_bounds__(kWarps * 32)
gj_reg_kernel(const float* __restrict__ a, int64_t sa0, int64_t sa1,
              int64_t sa2, const float* __restrict__ b, int64_t sb0,
              int64_t sb1, float* __restrict__ x, int64_t r_total, int k,
              bool vec) {
  constexpr int L = KP < 32 ? KP : 32;  // lanes per system
  constexpr int ROWS = KP / L;          // rows per lane
  constexpr int SPW = 32 / L;           // systems per warp
  constexpr int S = KP + 1;             // tile row stride
  constexpr int QUADS = KP / 4;         // 16-byte loads per lane per chunk
  __shared__ float tile[kWarps][32 * S];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ll = lane % L;  // the lane within its system
  const int64_t sys =
      ((int64_t)blockIdx.x * kWarps + warp) * SPW + lane / L;
  const bool valid = sys < r_total;
  float* t = tile[warp] + (lane / L) * L * S;
  const float* as = a + (valid ? sys : 0) * sa0;
  float w[ROWS][KP + 1];  // row ll + c*L of [A | b]; b at column KP

  if constexpr (kLayout == kPacked) {  // row i of [A^T | b]: column i of A
#pragma unroll
    for (int c = 0; c < ROWS; ++c) {
      const int i = c * L + ll;
      const bool live = valid && i < k;
      const float* col = as + (live ? i : 0) * sa2;
#pragma unroll
      for (int j = 0; j < KP; ++j)
        w[c][j] = live && j < k ? __ldg(col + j * sa1) : 0.0f;
    }
  } else if (vec) {  // K == KP, rows contiguous, every system 16-byte aligned
    const float4* src = reinterpret_cast<const float4*>(as);
    float4 v[ROWS][QUADS];
#pragma unroll
    for (int c = 0; c < ROWS; ++c)
#pragma unroll
      for (int n = 0; n < QUADS; ++n)
        v[c][n] = valid ? __ldg(src + c * L * QUADS + ll + n * L)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < ROWS; ++c) {
#pragma unroll
      for (int n = 0; n < QUADS; ++n) {
        const int e = 4 * (ll + n * L);
        float* d = t + (e / KP) * S + e % KP;
        d[0] = v[c][n].x;
        d[1] = v[c][n].y;
        d[2] = v[c][n].z;
        d[3] = v[c][n].w;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < KP; ++j) w[c][j] = t[ll * S + j];
      __syncwarp();  // the next chunk overwrites the tile
    }
  } else {
#pragma unroll
    for (int c = 0; c < ROWS; ++c) {
      const int i0 = c * L;
      const int n = valid ? max(0, min(L, k - i0)) * k : 0;
      for (int e = ll; e < n; e += L) {
        const int i = e / k, j = e - i * k;
        t[i * S + j] = as[(i0 + i) * sa1 + j * sa2];
      }
      __syncwarp();
      const bool live = valid && i0 + ll < k;
#pragma unroll
      for (int j = 0; j < KP; ++j)
        w[c][j] = live && j < k ? t[ll * S + j] : 0.0f;
      __syncwarp();
    }
  }
#pragma unroll
  for (int c = 0; c < ROWS; ++c) {
    const int i = c * L + ll;
    w[c][KP] = valid && i < k ? b[sys * sb0 + i * sb1] : 0.0f;
  }

  if constexpr (kLayout == kPair) {
    float inv[ROWS][2] = {};  // each row's row of its pivot block's inverse
#pragma unroll
    for (int p = 0; p < KP; p += 2) {
      if (p >= k) break;  // uniform; k is even, so p + 1 < k
      const int s = p / L, src = p % L;  // slot, lanes src and src + 1
      const float p00 = __shfl_sync(kFullMask, w[s][p], src, L);
      const float p01 = __shfl_sync(kFullMask, w[s][p + 1], src, L);
      const float p10 = __shfl_sync(kFullMask, w[s][p], src + 1, L);
      const float p11 = __shfl_sync(kFullMask, w[s][p + 1], src + 1, L);
      float det = p00 * p11 - p01 * p10;
      if (fabsf(det) < kPivotEps) det = 1.0f;
      const float rdet = __frcp_rn(det);
      float m0[ROWS], m1[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float c0 = w[r][p], c1 = w[r][p + 1];
        m0[r] = (c0 * p11 - c1 * p10) * rdet;
        m1[r] = (c1 * p00 - c0 * p01) * rdet;
      }
      if (ll == src) {
        inv[s][0] = p11 * rdet;
        inv[s][1] = -p01 * rdet;
        m0[s] = m1[s] = 0.0f;
      } else if (ll == src + 1) {
        inv[s][0] = -p10 * rdet;
        inv[s][1] = p00 * rdet;
        m0[s] = m1[s] = 0.0f;
      }
#pragma unroll
      for (int j = p + 2; j <= KP; ++j) {
        const float v0 = __shfl_sync(kFullMask, w[s][j], src, L);
        const float v1 = __shfl_sync(kFullMask, w[s][j], src + 1, L);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          w[r][j] = fmaf(-m1[r], v1, fmaf(-m0[r], v0, w[r][j]));
      }
    }
    // x_i = (row i of P^-1) . (b_p0, b_p1); every lane takes part in the
    // shuffle, the padding ones too
#pragma unroll
    for (int c = 0; c < ROWS; ++c) {
      const float other = __shfl_xor_sync(kFullMask, w[c][KP], 1, L);
      const bool first = (ll & 1) == 0;
      w[c][KP] = fmaf(inv[c][1], first ? other : w[c][KP],
                      inv[c][0] * (first ? w[c][KP] : other));
    }
  } else {
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      if (p >= k) break;  // uniform: k is the same for every lane
      const int s = p / L, src = p % L;  // the pivot row's slot and lane
      float d = __shfl_sync(kFullMask, w[s][p], src, L);
      if (fabsf(d) < kPivotEps) d = 1.0f;
      const bool pivot = ll == src;
      float c[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) c[r] = w[r][p];
      if (pivot) {
        const float inv = __frcp_rn(d);
        c[s] = 0.0f;
#pragma unroll
        for (int j = p + 1; j <= KP; ++j) w[s][j] *= inv;
      }
#pragma unroll
      for (int j = p + 1; j <= KP; ++j) {
        const float v = __shfl_sync(kFullMask, w[s][j], src, L);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) w[r][j] = fmaf(-c[r], v, w[r][j]);
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int c = 0; c < ROWS; ++c) {
      const int i = c * L + ll;
      if (i < k) x[sys * k + i] = w[c][KP];
    }
  }
}

template <int KP, int kLayout>
int launch(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
           const float* b, int64_t sb0, int64_t sb1, float* x, int64_t r,
           int k, cudaStream_t stream) {
  constexpr int per_block = kWarps * (32 / (KP < 32 ? KP : 32));
  const bool vec = kLayout != kPacked && k == KP && sa2 == 1 && sa1 == KP &&
                   sa0 % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int64_t blocks = (r + per_block - 1) / per_block;
  gj_reg_kernel<KP, kLayout><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, vec);
  return (int)cudaGetLastError();
}

template <int kLayout>
int dispatch(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
             const float* b, int64_t sb0, int64_t sb1, float* x, int64_t r,
             int k, void* stream) {
  if (r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k >= 1 && k <= 16)
    return launch<16, kLayout>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, s);
  if (k > 16 && k <= 32)
    return launch<32, kLayout>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, s);
  if (k > 32 && k <= 64)
    return launch<64, kLayout>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x [r, k] = A^-1 b for A [r, k, k] (strides sa*) and b [r, k] (strides
// sb0, sb1), 1 <= k <= 64; x contiguous. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a k out of range.
int gj_aug_reg(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
               const float* b, int64_t sb0, int64_t sb1, float* x,
               int64_t r, int k, void* stream) {
  return dispatch<kAug>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

// x [r, k] = A^-T b (the packed layout's elimination; A^-1 b for a
// symmetric A), arguments as for gj_aug_reg.
int gj_packed_reg(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                  const float* b, int64_t sb0, int64_t sb1, float* x,
                  int64_t r, int k, void* stream) {
  return dispatch<kPacked>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

// x [r, k] = A^-1 b by row elimination two pivots a step (the blocked2
// layout; any A whose pivot blocks are invertible), arguments as for
// gj_aug_reg, k even.
int gj_blocked2_reg(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                    const float* b, int64_t sb0, int64_t sb1, float* x,
                    int64_t r, int k, void* stream) {
  if (k % 2) return (int)cudaErrorInvalidValue;
  return dispatch<kPair>(a, sa0, sa1, sa2, b, sb0, sb1, x, r, k, stream);
}

}  // extern "C"
