// The two A/B layouts of the batched Gauss-Jordan SPD solve, x = A^-1 b,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of predictionio_tpu/ops/pallas_solve.py above
// K = 256:
//   - _build_solver_packed :101   (entry point gj_packed)
//   - _build_solver_blocked2 :177, pallas_call at :237 (entry point
//     gj_blocked2)
// Both compute what gj_aug (gj_solve.cu) computes, by a different
// elimination; the layout switch (gj_solve(layout=...), PIO_GJ_LAYOUT)
// picks one of them for an A/B on this card. ops/spd_solve.py routes
// both here above K = 256 only, where no route reaches (ranks stop at
// 256): gj_reg.cu and gj_cta.cu run both layouts below, on the working
// copy in registers (and shared memory above K = 128).
//
// gj_packed: column Gauss-Jordan on M = [[A], [b^T]], a [K+1][K] working
// copy read from A's rows as they lie (so for an A that is not bitwise
// symmetric it solves A^T x = b, as the TPU kernel does). Step j reads
// the pivot d = M[j][j] (|d| < 1e-30 -> 1), saves the pivot column
// divided by d and the pivot row, then sets column j to the saved column
// and subtracts pcol[i] * prow[c] from every other column. After K steps
// A has become I and the b row holds x^T. One thread block owns one
// system.
//
// gj_blocked2: row Gauss-Jordan on [A | b] ([K][K+1], the gj_aug working
// copy), two pivots per step: the 2x2 pivot block P of rows and columns
// j0 = 2s, j1 = 2s + 1 is inverted explicitly (det guard |det| < 1e-30
// -> 1), the two pivot rows become P^-1 [row0; row1], and every other
// row subtracts col0[i] * n0 + col1[i] * n1. K/2 steps of two barriers
// each, against gj_aug's K steps. K must be even. It took 2.82 ms at
// [13 850, 64, 1], about the library's Cholesky solve, and 18.1 ms at
// [13 850, 128, 1], twice the library's (PERF.md): gj_reg.cu's and
// gj_cta.cu's gj_blocked2_* bodies replaced it at K <= 256.
//
// What bounds them on this card: the same bytes as gj_aug, (K^2 + 2K)*4
// per system (A and b read once, x written once), against the K^3/3 +
// 2K^2 FP32 operations of the least work that solves an SPD system (a
// Cholesky factorisation and two substitutions), under the FP32 ridge up
// to K ~ 240: the bound is HBM but at K = 255. Each kernel reads A once
// and keeps every step on chip, only x goes back out. What keeps them from
// that bound is the step chain (two barriers per step); blocked2 halves
// the number of steps.
//
// Working copies past the 227 KB a block may hold (packed at K = 255 is
// 261 KB, blocked2 at K = 256 263 KB) run the same kernels with
// kShared = false: the copy lives in device scratch that the caller
// allocates, one slot per system of each resident block, and the blocks
// stride over the systems. The pivot row and column stay in shared memory.
//
// Built without --use_fast_math: the divisions stay IEEE, which keeps the
// 1e-4 bars and the exact zeros of all-zero padding systems.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPivotEps = 1e-30f;
constexpr int kMaxThreads = 256;

// Threads for one system of n elements: whole warps, at most kMaxThreads.
int block_threads(int n) {
  int t = (n + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <bool kShared>
__global__ void packed_kernel(const float* __restrict__ a, int64_t sa0,
                              int64_t sa1, int64_t sa2,
                              const float* __restrict__ b, int64_t sb0,
                              int64_t sb1, float* __restrict__ x,
                              float* __restrict__ scratch, int64_t r_total,
                              int k) {
  extern __shared__ float smem[];
  const int h = k + 1;      // rows of M: A's K rows, then b^T
  const int n = h * k;      // elements of one working copy
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* work = kShared ? smem : scratch + (int64_t)blockIdx.x * n;
  float* pcol = kShared ? work + n : smem;  // pivot column [h]
  float* prow = pcol + h;                   // pivot row [k]
  // element e = i * k + c walked with stride nt: carry (i, c)
  const int i0 = tid / k, c0 = tid % k;
  const int di = nt / k, dc = nt % k;

  for (int64_t r = blockIdx.x; r < r_total; r += gridDim.x) {
    const float* ar = a + r * sa0;
    const float* br = b + r * sb0;
    int i = i0, c = c0;
    for (int e = tid; e < n; e += nt) {
      work[e] = i < k ? ar[i * sa1 + c * sa2] : br[c * sb1];
      i += di;
      c += dc;
      if (c >= k) { c -= k; ++i; }
    }
    __syncthreads();
    for (int j = 0; j < k; ++j) {
      float d = work[j * k + j];
      if (fabsf(d) < kPivotEps) d = 1.0f;
      for (int t = tid; t < h; t += nt) pcol[t] = work[t * k + j] / d;
      for (int t = tid; t < k; t += nt) prow[t] = work[j * k + t];
      __syncthreads();
      i = i0;
      c = c0;
      for (int e = tid; e < n; e += nt) {
        work[e] = c == j ? pcol[i] : work[e] - pcol[i] * prow[c];
        i += di;
        c += dc;
        if (c >= k) { c -= k; ++i; }
      }
      __syncthreads();
    }
    float* xr = x + r * (int64_t)k;
    for (int t = tid; t < k; t += nt) xr[t] = work[k * k + t];
    __syncthreads();  // the next system's load overwrites `work`
  }
}

template <bool kShared>
__global__ void blocked2_kernel(const float* __restrict__ a, int64_t sa0,
                                int64_t sa1, int64_t sa2,
                                const float* __restrict__ b, int64_t sb0,
                                int64_t sb1, float* __restrict__ x,
                                float* __restrict__ scratch, int64_t r_total,
                                int k) {
  extern __shared__ float smem[];
  const int w = k + 1;
  const int n = k * w;
  float* work = kShared ? smem : scratch + (int64_t)blockIdx.x * n;
  float* n0 = kShared ? smem + n : smem;  // [w] normalised pivot rows
  float* n1 = n0 + w;
  float* col0 = n1 + w;                   // [k] pivot columns, 0 at j0, j1
  float* col1 = col0 + k;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int i0 = tid / w, j0c = tid % w;
  const int di = nt / w, dj = nt % w;

  for (int64_t r = blockIdx.x; r < r_total; r += gridDim.x) {
    const float* ar = a + r * sa0;
    const float* br = b + r * sb0;
    {
      int i = i0, j = j0c;
      for (int e = tid; e < n; e += nt) {
        work[e] = j < k ? ar[i * sa1 + j * sa2] : br[i * sb1];
        i += di;
        j += dj;
        if (j >= w) { j -= w; ++i; }
      }
    }
    __syncthreads();
    for (int p0 = 0; p0 < k; p0 += 2) {
      const int p1 = p0 + 1;
      const float* row0 = work + p0 * w;
      const float* row1 = work + p1 * w;
      const float p00 = row0[p0], p01 = row0[p1];
      const float p10 = row1[p0], p11 = row1[p1];
      float det = p00 * p11 - p01 * p10;
      if (fabsf(det) < kPivotEps) det = 1.0f;
      for (int t = tid; t < w; t += nt) {
        const float r0 = row0[t], r1 = row1[t];
        n0[t] = (p11 * r0 - p01 * r1) / det;
        n1[t] = (p00 * r1 - p10 * r0) / det;
      }
      for (int t = tid; t < k; t += nt) {
        const bool piv = t == p0 || t == p1;
        col0[t] = piv ? 0.0f : work[t * w + p0];
        col1[t] = piv ? 0.0f : work[t * w + p1];
      }
      __syncthreads();
      int i = i0, j = j0c;
      for (int e = tid; e < n; e += nt) {
        work[e] = i == p0   ? n0[j]
                  : i == p1 ? n1[j]
                            : work[e] - col0[i] * n0[j] - col1[i] * n1[j];
        i += di;
        j += dj;
        if (j >= w) { j -= w; ++i; }
      }
      __syncthreads();
    }
    float* xr = x + r * (int64_t)k;
    for (int t = tid; t < k; t += nt) xr[t] = work[t * w + k];
    __syncthreads();  // the next system's load overwrites `work`
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// x [r, k] = A^-T b by column elimination (A^-1 b for a symmetric A),
// one system a block. A [r, k, k] (strides sa*), b [r, k] (strides sb0,
// sb1). scratch == NULL runs the shared-memory kernel; otherwise scratch
// holds grid * (k + 1) * k floats and grid blocks stride over the
// systems. Returns cudaGetLastError().
int gj_packed(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
              const float* b, int64_t sb0, int64_t sb1, float* x,
              float* scratch, int64_t r, int k, int grid, void* stream) {
  if (r <= 0) return 0;
  const int n = (k + 1) * k;
  const size_t side = ((size_t)(k + 1) + k) * sizeof(float);
  const int threads = block_threads(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const size_t bytes = (size_t)n * sizeof(float) + side;
    int err = set_smem(packed_kernel<true>, bytes);
    if (err) return err;
    packed_kernel<true><<<(unsigned)r, threads, bytes, s>>>(
        a, sa0, sa1, sa2, b, sb0, sb1, x, nullptr, r, k);
  } else {
    packed_kernel<false><<<grid, threads, side, s>>>(
        a, sa0, sa1, sa2, b, sb0, sb1, x, scratch, r, k);
  }
  return (int)cudaGetLastError();
}

// x [r, k] = A^-1 b by row elimination two pivots at a time (k even).
// Arguments as for gj_packed; scratch holds grid * k * (k + 1) floats.
int gj_blocked2(const float* a, int64_t sa0, int64_t sa1, int64_t sa2,
                const float* b, int64_t sb0, int64_t sb1, float* x,
                float* scratch, int64_t r, int k, int grid, void* stream) {
  if (r <= 0) return 0;
  if (k % 2) return (int)cudaErrorInvalidValue;
  const int w = k + 1;
  const int threads = block_threads(k * w);
  const size_t side = ((size_t)2 * w + 2 * k) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const size_t bytes = (size_t)k * w * sizeof(float) + side;
    int err = set_smem(blocked2_kernel<true>, bytes);
    if (err) return err;
    blocked2_kernel<true><<<(unsigned)r, threads, bytes, s>>>(
        a, sa0, sa1, sa2, b, sb0, sb1, x, nullptr, r, k);
  } else {
    blocked2_kernel<false><<<grid, threads, side, s>>>(
        a, sa0, sa1, sa2, b, sb0, sb1, x, scratch, r, k);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
